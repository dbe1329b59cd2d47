"""Request datasets and caption corpora (counterpart of
``emcid_tpu/dsets``): the same parsers, schemas and seed streams."""

from emcid_torch.dsets.iceb import (
    RequestDataset,
    CustomObjectRequestDataset,
    ImageNetMendRequestDataset,
    get_filtered_dataset,
    ObjectPromptDataset,
    compose_alias_test_requests,
)
from emcid_torch.dsets.artists import ArtistRequestsDataset, load_artist_eval_prompts
from emcid_torch.dsets.debias import DebiasRequestDataset
from emcid_torch.dsets.timed_road import TIMEDRoadRequestDataset, CONTEXT_TEMPLATE
from emcid_torch.dsets.global_concepts import (
    NSFWEditRequestDataset,
    get_i2p_editing_requests,
)
from emcid_torch.dsets.stat_dataset import (
    TokenizedDataset,
    length_collation,
    flatten_masked_batch,
)
from emcid_torch.dsets.coco import load_coco_30k
