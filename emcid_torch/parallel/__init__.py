from emcid_torch.parallel.mesh import (
    DeviceMesh,
    default_mesh,
    gather,
    get_mesh,
    multi_slice_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)
