"""Worker for tests/test_torch_multiprocess.py: one rank of a ``gloo``
process group on the CPU, started with torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``).  It runs every check of its layout against the port
unsharded (or a one-process mesh of as many shards) and writes one JSON of
results, plus the arrays the test compares across ranks, under ``shared``.

    python tests/torch_multiprocess_worker.py {entries per process} {shared}

Layout "1 entry per process" (dcn 4 x data 1 in four processes): the
mesh helpers, the covariance sweep, the eval mean, Stage 1, generation and
the K/V edit's prompt axis.  "2 entries" (dcn 2 x data 2 in two
processes, repeated CPU entries): the mesh helpers, the covariance sweep,
the eval mean and ``run_emcid --tiny --platform cpu``.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
sys.path.insert(0, str(Path(__file__).resolve().parent))

LAYER = "text_model.encoder.layers.1.mlp.fc2"
CAPTIONS = [f"a photo number {i} of a cat" for i in range(32)]
HP = dict(
    layers=[0, 1], clamp_norm_factor=1.5, layer_selection="all",
    fact_token="subject_last", v_num_grad_steps=3, v_lr=0.1,
    v_weight_decay=5e-4, mom2_adjustment=True, mom2_update_weight=100,
    rewrite_module_tmp="text_model.encoder.layers.{}.mlp.fc2",
    layer_module_tmp="text_model.encoder.layers.{}",
    mlp_module_tmp="text_model.encoder.layers.{}.mlp",
    attn_module_tmp="text_model.encoder.layers.{}.self_attn",
    ln_f_module="text_model.final_layer_norm",
    mom2_dataset="ccs_filtered", mom2_n_samples=100,
    mom2_dtype="float32", objective="ablate-dest", esd_mu="None",
)


def rel(a, b) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


def requests(n):
    rng = np.random.RandomState(7)
    return [
        {"prompts": ["a photo of {}", "{}"], "source": f"w{i}",
         "dest": f"w{i + 1}", "seed_train": i,
         "images": [rng.rand(16, 16, 3).astype(np.float32)
                    for _ in range(2)]}
        for i in range(n)
    ]


def helpers(out, mesh, gather, shard_batch, torch):
    """The mesh's shape and first shard; shard_batch/gather round trips in
    global order; the eval mean over the mesh."""
    L = len(mesh.devices)
    x = torch.arange(mesh.size * 2 * 3, dtype=torch.float32).reshape(-1, 3)
    parts = shard_batch(x, mesh)
    own = [x[2 * (mesh.first + k):2 * (mesh.first + k + 1)] for k in range(L)]
    out.update(mesh_axes=list(mesh.axis_names), mesh_shape=list(mesh.shape),
               first=mesh.first, local_entries=L,
               own_shards_ok=all(torch.equal(p, o)
                                 for p, o in zip(parts, own)),
               round_trip_ok=torch.equal(gather(parts, "cpu", mesh), x))
    scores = torch.arange(16, dtype=torch.float32)
    out["eval_mean"] = float(gather(shard_batch(scores, mesh), "cpu",
                                    mesh).mean())


def covariance(out, pc, mesh, shared, tag, rank, torch):
    """The sweep on the process mesh (a cold cache: only rank 0 writes it),
    the one-process mesh of as many shards, and the cache hit after."""
    from emcid_torch.engine.layer_stats import layer_stats_text_encoder
    from emcid_torch.parallel import get_mesh
    from emcid_torch.stats import running

    saves = []
    save = running.save_cached_state
    running.save_cached_state = lambda *a, **k: (saves.append(a[0]),
                                                 save(*a, **k))
    kw = dict(ds_name="x", sample_size=None, batch_size=6,
              captions=CAPTIONS)
    stats = shared / f"stats_{tag}"
    got = layer_stats_text_encoder(pc.text_encoder, pc.tokenizer, LAYER,
                                   stats_dir=stats, mesh=mesh, **kw)
    with tempfile.TemporaryDirectory() as tmp:
        twin = layer_stats_text_encoder(
            pc.text_encoder, pc.tokenizer, LAYER, stats_dir=tmp,
            force_recompute=True, mesh=get_mesh(["cpu"] * mesh.size), **kw)
    again = layer_stats_text_encoder(pc.text_encoder, pc.tokenizer, LAYER,
                                     stats_dir=stats, mesh=mesh, **kw)
    running.save_cached_state = save
    moment = got.mom2.moment()
    out.update(cov_count=got.mom2.count, cov_twin_count=twin.mom2.count,
               cov_bitwise_twin=torch.equal(moment, twin.mom2.moment()),
               cov_cache_hit_equal=torch.equal(moment, again.mom2.moment()),
               cov_cache_count=again.mom2.count, cov_saves=len(saves))
    np.save(shared / f"cov_{tag}_{rank}.npy", moment.numpy())


def stage1_generation_kv(out, pc, mesh, shared, rank, torch):
    """Stage 1 (3 concepts padded to 4; compute_zs_for_requests, and
    ZOptimizer with its eps pool and loss curve), generation and the K/V
    edit, each against the port unsharded; Stage 1 and the K/V edit also
    against the one-process mesh of as many shards."""
    from emcid_torch.engine import cross_attn as tca
    from emcid_torch.engine.compute_z import (
        ZOptimizer, concept_batch_to_device, prepare_concept_batch,
    )
    from emcid_torch.engine.editor import compute_zs_for_requests
    from emcid_torch.hparams import EMCIDHyperParams
    from emcid_torch.models.pipeline import generate, sample_latents
    from emcid_torch.parallel import get_mesh

    hp = EMCIDHyperParams.from_dict(dict(HP))
    reqs = requests(3)
    ref = compute_zs_for_requests(pc, reqs, hp, block_size=8, verbose=False)
    got = compute_zs_for_requests(pc, reqs, hp, block_size=8, mesh=mesh,
                                  verbose=False)
    twin = compute_zs_for_requests(pc, reqs, hp, block_size=8,
                                   mesh=get_mesh(["cpu"] * mesh.size),
                                   verbose=False)
    out["stage1_z_rel"] = rel(ref, got)
    out["stage1_twin_bitwise"] = bool(np.array_equal(got, twin))
    np.save(shared / f"z_{rank}.npy", np.asarray(got))

    arrays, _, _ = prepare_concept_batch(pc.tokenizer, reqs, hp)
    rng = np.random.RandomState(1)
    arrays["latents_mean"] = rng.randn(3, 2, 2, 8, 8, 4).astype(np.float32)
    arrays["latents_logvar"] = np.full((3, 2, 2, 8, 8, 4), -3.0, np.float32)
    batch = concept_batch_to_device(arrays, "cpu")
    optz = ZOptimizer(pc.text_encoder, pc.unet, pc.schedule, hp, layer=1,
                      eps_pool=3, lr_sched="const")
    a = optz.run(batch, torch.Generator().manual_seed(0))
    b = optz.run(batch, torch.Generator().manual_seed(0), mesh=mesh)
    c = optz.run(batch, torch.Generator().manual_seed(0),
                 mesh=get_mesh(["cpu"] * mesh.size))
    out.update(pool_z_rel=rel(a[0], b[0]), pool_loss_rel=rel(a[3], b[3]),
               pool_twin_bitwise=all(torch.equal(x, y)
                                     for x, y in zip(b, c)))
    np.save(shared / f"losses_{rank}.npy", b[3].numpy())

    prompts = [f"a photo of w{i}" for i in range(6)]
    kw = dict(num_inference_steps=2, guidance_scale=7.5, height=16,
              width=16, sampler="ddim")
    pad_p, pad_s = prompts + prompts[-1:] * 2, list(range(6)) + [0, 0]
    out["latents_rel"] = rel(sample_latents(pc, pad_p, pad_s, **kw),
                             sample_latents(pc, pad_p, pad_s, mesh=mesh,
                                            **kw))
    single = generate(pc, prompts, list(range(6)), **kw)
    sharded = generate(pc, prompts, list(range(6)), mesh=mesh, **kw)
    out["images_shape"] = list(sharded.shape)
    out["images_max_level"] = int(np.abs(single.astype(int)
                                         - sharded.astype(int)).max())

    hp_kv = EMCIDHyperParams.from_dict(dict(
        HP, layers=[3], objective="esd", esd_mu=1.0, v_num_grad_steps=2))
    req = {"prompts": ["a photo of {}", "{}"], "source": "cat",
           "dest": "dog", "seed_train": 0}
    rng = np.random.RandomState(0)
    mean = (rng.randn(2, 2, 8, 8, 4) * 0.18).astype(np.float32)
    logvar = np.full(mean.shape, -3.0, np.float32)
    ref = tca.compute_z_unet_x_kv(pc, req, hp_kv, mean, logvar,
                                  gen=torch.Generator().manual_seed(0),
                                  verbose=False)
    got = tca.compute_z_unet_x_kv(pc, req, hp_kv, mean, logvar,
                                  gen=torch.Generator().manual_seed(0),
                                  mesh=mesh, verbose=False)
    twin = tca.compute_z_unet_x_kv(pc, req, hp_kv, mean, logvar,
                                   gen=torch.Generator().manual_seed(0),
                                   mesh=get_mesh(["cpu"] * mesh.size),
                                   verbose=False)
    out["kv_rel"] = max(rel(ref[n], got[n]) for n in ref)
    out["kv_twin_rel"] = max(rel(twin[n], got[n]) for n in ref)


def cli(out, shared, rank):
    """``run_emcid --tiny --platform cpu`` in this process group, with
    every file write counted."""
    import PIL.Image

    from emcid_torch.cli import run_emcid

    writes = []
    savez, img_save = np.savez, PIL.Image.Image.save
    np.savez = lambda *a, **k: (writes.append("npz"), savez(*a, **k))
    PIL.Image.Image.save = lambda self, *a, **k: (writes.append("png"),
                                                  img_save(self, *a, **k))
    edited, deltas = run_emcid.main(cli_argv(shared, "sharded"))
    np.savez, PIL.Image.Image.save = savez, img_save
    out["cli_writes"] = len(writes)
    np.savez(shared / f"cli_{rank}.npz", **{
        k: v.numpy() for k, v in edited.text_encoder.state_dict().items()
        if k.endswith("mlp.fc2.weight")})


def cli_argv(shared, tag):
    """The CLI's arguments for an instruction file under ``shared``
    (written once by ``write_cli_inputs``)."""
    return ["--instruction_path", str(shared / f"run_{tag}.json"), "--tiny",
            "--platform", "cpu", "--hparams_dir", str(shared / "hp"),
            "--steps", "2", "--stats_dir", str(shared / f"cli_stats_{tag}"),
            "--cache_dir", str(shared / f"cli_cache_{tag}")]


def write_cli_inputs(shared):
    """The hparams file and one instruction per tag (its own out_dir)."""
    (shared / "hp").mkdir(parents=True, exist_ok=True)
    (shared / "hp" / "hp.json").write_text(json.dumps(HP))
    for tag in ("sharded", "single"):
        (shared / f"run_{tag}.json").write_text(json.dumps({
            "requests": [{"prompts": ["a photo of {}", "{}"], "source": s,
                          "dest": d, "seed_train": i}
                         for i, (s, d) in enumerate([("cat", "dog"),
                                                     ("w1", "w2")])],
            "hparams": "hp", "val_prompts": ["a cat", "a dog"],
            "sample_num": 2, "out_dir": str(shared / f"out_{tag}")}))


def main(entries: int, shared: str) -> None:
    import torch

    torch.set_num_threads(1)
    os.environ["EMCID_TPU_EPS_POOL"] = "0"
    from emcid_torch.models.loader import _load, build_tiny_pipeline
    from emcid_torch.parallel import (
        default_mesh, distributed, gather, multi_slice_mesh, shard_batch,
    )
    from torch_parity import TINY_WORDS

    shared = Path(shared)
    backend = distributed.init_from_env("cpu")
    rank = distributed.process_index()
    pc = build_tiny_pipeline(seed=0, words=TINY_WORDS, device="cpu")
    # the JAX package's text encoder weights, carried across by the test
    _load(pc.text_encoder, dict(np.load(shared / "text_params.npz")))
    dm = default_mesh()
    out = dict(rank=rank, world=distributed.process_count(), backend=backend,
               default_axes=list(dm.axis_names), default_shape=list(dm.shape))
    mesh = multi_slice_mesh(devices=["cpu"] * entries)
    tag = f"{mesh.shape[0]}x{mesh.shape[1]}"
    helpers(out, mesh, gather, shard_batch, torch)
    covariance(out, pc, mesh, shared, tag, rank, torch)
    if entries == 1:
        stage1_generation_kv(out, pc, mesh, shared, rank, torch)
    else:
        cli(out, shared, rank)
    (shared / f"out_{tag}_{rank}.json").write_text(json.dumps(out))
    distributed.shutdown()


if __name__ == "__main__":
    main(int(sys.argv[1]), sys.argv[2])
