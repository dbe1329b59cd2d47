"""PyTorch port, the single-process device mesh (``emcid_torch.parallel``)
and its consumers, on the CPU with mesh entries that repeat the one device.

Tolerances: the helpers exactly; sharded against unsharded ``sample_latents``
(a batch of 4 padded to 6 on three entries) within 1e-5 relative (the
three batches of 2 sum in another order than one of 6: 2e-6 measured) and
``generate``'s uint8 images within one level; the covariance sweep's second
moment within 1e-6 relative; one Stage-1 block of 3 concepts padded to 4 on
two entries within 1e-5 relative of the port unsharded (z and loss curve);
the K/V edit's prompt axis tiled to lcm(2, 3) = 6 rows on three entries
within 1e-5 relative.  The slow-marked comparison of that Stage-1 block
with the JAX package sharded over the conftest's 8 virtual devices (its
draws replayed) holds z within 1e-4 relative.
"""

import argparse

import numpy as np
import pytest
import torch

from emcid_torch.models.loader import build_tiny_pipeline
from emcid_torch.parallel import (
    DeviceMesh,
    default_mesh,
    gather,
    get_mesh,
    multi_slice_mesh,
    pad_to_multiple,
    replicate,
    shard_batch,
)

from torch_parity import TINY_WORDS, one_torch_thread, rel_diff  # noqa: F401

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


@pytest.fixture(scope="module")
def pc():
    return build_tiny_pipeline(seed=0, words=TINY_WORDS, device="cpu")


def _requests(n):
    rng = np.random.RandomState(7)
    return [
        {"prompts": ["a photo of {}", "{}"], "source": f"w{i}",
         "dest": f"w{i + 1}", "seed_train": i,
         # given training images: no generation inside Stage 1
         "images": [rng.rand(16, 16, 3).astype(np.float32) for _ in range(2)]}
        for i in range(n)
    ]


@pytest.mark.parametrize("case", ["pad", "shard_raises", "shard_gather",
                                  "replicate", "replicate_copies",
                                  "default_mesh", "multi_slice"])
def test_mesh_helpers(case):
    if case == "pad":
        assert [pad_to_multiple(n, 4) for n in (1, 4, 5, 8)] == [4, 4, 8, 8]
    elif case == "shard_raises":
        with pytest.raises(ValueError, match="pad it first"):
            shard_batch(torch.zeros(5, 2), get_mesh(["cpu"] * 2))
    elif case == "shard_gather":
        mesh = get_mesh(["cpu"] * 3)
        x = torch.arange(12.0).reshape(6, 2)
        parts = shard_batch(x, mesh)
        assert [tuple(p.shape) for p in parts] == [(2, 2)] * 3
        assert torch.equal(gather(parts, "cpu"), x)
        assert mesh.size == 3 and mesh.axis_names == ("data",)
        assert isinstance(mesh, DeviceMesh) and hash(mesh) == hash(
            get_mesh(["cpu"] * 3))
    elif case == "replicate":
        m = torch.nn.Linear(2, 2)
        reps = replicate(m, get_mesh(["cpu"] * 3))
        assert len(reps) == 3 and all(r is m for r in reps)
    elif case == "replicate_copies":
        # "cpu:0" is another device than the module's "cpu": one copy for
        # both of its entries, kept until the weights change in place
        m = torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.BatchNorm1d(2))
        mesh = get_mesh(["cpu", "cpu:0", "cpu:0"])
        a = replicate(m, mesh)
        assert a[0] is m and a[1] is a[2] and a[1] is not m
        assert all(torch.equal(x, y) for x, y in zip(
            m.state_dict().values(), a[1].state_dict().values()))
        assert replicate(m, mesh)[1] is a[1]
        with torch.no_grad():
            m[0].weight.add_(1.0)
        b = replicate(m, mesh)
        assert b[1] is not a[1] and torch.equal(b[1][0].weight, m[0].weight)
    elif case == "default_mesh":
        assert default_mesh() is None  # no card here
        assert default_mesh(disable=True) is None
    else:
        # one process: the (dcn, data) mesh of shape (1, entries)
        m = multi_slice_mesh(devices=["cpu"] * 2)
        assert (m.axis_names, m.shape, m.size, m.first) == (
            ("dcn", "data"), (1, 2), 2, 0)
        with pytest.raises(ValueError, match="do not divide"):
            multi_slice_mesh(num_slices=3, devices=["cpu"] * 2)


def test_generate_sharded_equals_unsharded(pc):
    """A batch of 4 on three entries: ``generate`` pads it to 6."""
    from emcid_torch.models.pipeline import generate, sample_latents

    mesh = get_mesh(["cpu"] * 3)
    prompts = [f"a photo of w{i}" for i in range(4)]
    seeds = list(range(4))
    kw = dict(num_inference_steps=2, guidance_scale=7.5, height=16,
              width=16, sampler="ddim")
    with pytest.raises(ValueError, match="divide the mesh"):
        sample_latents(pc, prompts, seeds, mesh=mesh, **kw)
    padded_p, padded_s = prompts + prompts[-1:] * 2, seeds + [0, 0]
    ref = sample_latents(pc, padded_p, padded_s, **kw)
    got = sample_latents(pc, padded_p, padded_s, mesh=mesh, **kw)
    assert rel_diff(ref, got) <= 1e-5
    single = generate(pc, prompts, seeds, **kw)
    sharded = generate(pc, prompts, seeds, mesh=mesh, **kw)
    assert sharded.shape == single.shape == (4, 16, 16, 3)
    assert np.abs(sharded.astype(int) - single.astype(int)).max() <= 1


@pytest.mark.parametrize("batch_size", [6, 5])
def test_layer_stats_sharded_equals_unsharded(pc, tmp_path, batch_size):
    """25 captions on three entries; a batch of 5 pads to 6 rows (zero-mask
    rows add nothing and the count is masked).  A mesh collects mom2
    only."""
    from emcid_torch.engine.layer_stats import layer_stats_text_encoder

    captions = [f"a photo of w{i % 30}" for i in range(25)]
    layer = "text_model.encoder.layers.1.mlp.fc2"
    kw = dict(ds_name="x", sample_size=None, batch_size=batch_size,
              force_recompute=True, captions=captions)
    ref = layer_stats_text_encoder(pc.text_encoder, pc.tokenizer, layer,
                                   stats_dir=tmp_path / "a", **kw)
    got = layer_stats_text_encoder(pc.text_encoder, pc.tokenizer, layer,
                                   stats_dir=tmp_path / "b",
                                   mesh=get_mesh(["cpu"] * 3), **kw)
    assert got.mom2.count == ref.mom2.count
    assert rel_diff(ref.mom2.moment(), got.mom2.moment()) <= 1e-6
    with pytest.raises(ValueError, match="mom2 only"):
        layer_stats_text_encoder(pc.text_encoder, pc.tokenizer, layer,
                                 stats_dir=tmp_path / "c",
                                 to_collect=("mom2", "mean"),
                                 mesh=get_mesh(["cpu"] * 3), **kw)


def test_stage1_block_sharded_equals_unsharded(pc, monkeypatch):
    """3 concepts on two entries: the block pads to 4 inside
    ``ZOptimizer.run`` and the padding is dropped."""
    from emcid_torch.engine.editor import compute_zs_for_requests
    from emcid_torch.hparams import EMCIDHyperParams

    monkeypatch.setenv("EMCID_TPU_EPS_POOL", "0")
    hp = EMCIDHyperParams.from_dict(dict(HP))
    reqs = _requests(3)
    ref = compute_zs_for_requests(pc, reqs, hp, block_size=8, verbose=False)
    got = compute_zs_for_requests(pc, reqs, hp, block_size=8,
                                  mesh=get_mesh(["cpu"] * 2), verbose=False)
    assert got.shape == ref.shape == (3, 1, 32)
    assert rel_diff(ref, got) <= 1e-5


def test_stage1_pool_sharded_equals_unsharded(pc):
    """The eps_dest pool (K=3) and the losses on a 3-entry mesh: draws for
    the block's own concepts, padded and split."""
    from emcid_torch.engine.compute_z import (
        ZOptimizer,
        concept_batch_to_device,
        prepare_concept_batch,
    )
    from emcid_torch.hparams import EMCIDHyperParams

    hp = EMCIDHyperParams.from_dict(dict(HP, v_num_grad_steps=3))
    reqs = _requests(2)
    arrays, _, _ = prepare_concept_batch(pc.tokenizer, reqs, hp)
    rng = np.random.RandomState(1)
    arrays["latents_mean"] = rng.randn(2, 2, 2, 8, 8, 4).astype(np.float32)
    arrays["latents_logvar"] = np.full((2, 2, 2, 8, 8, 4), -3.0, np.float32)
    batch = concept_batch_to_device(arrays, "cpu")
    optz = ZOptimizer(pc.text_encoder, pc.unet, pc.schedule, hp, layer=1,
                      eps_pool=3, lr_sched="const")
    ref = optz.run(batch, torch.Generator().manual_seed(0))
    got = optz.run(batch, torch.Generator().manual_seed(0),
                   mesh=get_mesh(["cpu"] * 3))
    for a, b in zip(ref, got):
        assert tuple(a.shape) == tuple(b.shape)
        assert rel_diff(a, b) <= 1e-5


def test_kv_edit_prompt_axis_sharded_equals_unsharded(pc):
    """``compute_z_unet_x_kv``: 2 prompts tiled to 6 rows on three
    entries."""
    from emcid_torch.engine import cross_attn as tca
    from emcid_torch.hparams import EMCIDHyperParams

    hp = EMCIDHyperParams.from_dict(dict(
        HP, layers=[3], objective="esd", esd_mu=1.0, v_num_grad_steps=2))
    req = {"prompts": ["a photo of {}", "{}"], "source": "cat",
           "dest": "dog", "seed_train": 0}
    rng = np.random.RandomState(0)
    mean = (rng.randn(2, 2, 8, 8, 4) * 0.18).astype(np.float32)
    logvar = np.full(mean.shape, -3.0, np.float32)
    kw = dict(verbose=False)
    ref = tca.compute_z_unet_x_kv(pc, req, hp, mean, logvar,
                                  gen=torch.Generator().manual_seed(0), **kw)
    got = tca.compute_z_unet_x_kv(pc, req, hp, mean, logvar,
                                  gen=torch.Generator().manual_seed(0),
                                  mesh=get_mesh(["cpu"] * 3), **kw)
    assert set(ref) == set(got)
    for n in ref:
        assert rel_diff(ref[n], got[n]) <= 1e-5, n


@pytest.mark.parametrize("no_mesh", [False, True])
def test_cli_setup_mesh_on_cpu(tmp_path, monkeypatch, no_mesh):
    """``workflows._setup`` and ``run_emcid`` on the CPU, with and without
    ``--no-mesh``: no mesh and no ``gen_kwargs["mesh"]``, even where two
    cards would be counted."""
    import json

    from emcid_torch.cli import run_emcid, workflows
    from emcid_torch.engine import editor
    from emcid_torch.models import pipeline

    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    flag = ["--no-mesh"] if no_mesh else []
    p = argparse.ArgumentParser()
    workflows._add_common(p)
    hp_dir = tmp_path / "hp"
    hp_dir.mkdir()
    (hp_dir / "hp.json").write_text(json.dumps(HP))
    args = p.parse_args(["--tiny", "--platform", "cpu", "--hparam", "hp",
                         "--hparams_dir", str(hp_dir), *flag])
    _, _, gen_kwargs, mesh = workflows._setup(args)
    assert mesh is None and "mesh" not in gen_kwargs

    seen = {}

    def fake_apply(comps, requests, hparams, **kw):
        seen["apply_mesh"] = kw.get("mesh")
        return comps, {}

    def fake_generate(comps, prompts, seeds, **kw):
        seen.setdefault("gen_keys", set()).update(kw)
        return np.zeros((len(prompts), 16, 16, 3), np.uint8)

    monkeypatch.setattr(editor, "apply_emcid", fake_apply)
    monkeypatch.setattr(pipeline, "generate", fake_generate)
    path = tmp_path / "run.json"
    path.write_text(json.dumps({
        "requests": [{"prompts": ["a photo of {}"], "source": "cat",
                      "dest": "dog", "seed_train": 0}],
        "hparams": "hp", "val_prompts": ["a cat"], "sample_num": 1,
        "out_dir": str(tmp_path / "out")}))
    run_emcid.main(["--instruction_path", str(path), "--tiny", "--platform",
                    "cpu", "--hparams_dir", str(hp_dir), "--steps", "2",
                    *flag])
    assert seen["apply_mesh"] is None and "mesh" not in seen["gen_keys"]


@pytest.mark.slow
def test_stage1_block_matches_jax_sharded(pc, monkeypatch):
    """The same 3-concept block against the JAX package sharded over the
    conftest's 8 virtual devices (the block pads to 8 there, to 4 on the
    port's two entries); both read the same training-image posterior and
    replay the same noise and timesteps."""
    import jax
    import jax.numpy as jnp

    from emcid_tpu.engine import compute_z as jcz
    from emcid_tpu.engine import editor as jeditor
    from emcid_tpu.hparams import EMCIDHyperParams as JHP
    from emcid_tpu.models.loader import build_tiny_pipeline as jbuild
    from emcid_tpu.parallel import get_mesh as jget_mesh

    from emcid_torch.engine import compute_z as tcz
    from emcid_torch.engine import editor as teditor
    from emcid_torch.hparams import EMCIDHyperParams as THP
    from torch_parity import port_components

    comps = jbuild(seed=0, words=TINY_WORDS)
    tpc = port_components(comps)
    C, P, steps = 3, 2, 3
    rng = np.random.RandomState(5)
    mean = rng.randn(C, 1, P, 8, 8, 4).astype(np.float32)
    logvar = np.full_like(mean, -60.0)
    noise = rng.randn(steps, C, P, 8, 8, 4).astype(np.float32)
    ts = rng.randint(0, 1000, (steps, C, P)).astype(np.int32)

    def pad_c(a, n):  # pad the concept axis (1) with the last concept
        return np.concatenate([a, np.repeat(a[:, -1:], n - a.shape[1], 1)],
                              1)

    jrun, trun = jcz.ZOptimizer.run, tcz.ZOptimizer.run
    monkeypatch.setattr(jcz.ZOptimizer, "run",
                        lambda self, tp, up, batch, key, **k: jrun(
                            self, tp, up, batch, key,
                            noise_override=pad_c(noise, batch[0].shape[0]),
                            ts_override=pad_c(ts, batch[0].shape[0])))
    monkeypatch.setattr(tcz.ZOptimizer, "run",
                        lambda self, batch, gen=None, **k: trun(
                            self, batch, gen, noise_override=noise,
                            ts_override=ts, mesh=k.get("mesh")))
    for mod in (jeditor, teditor):
        monkeypatch.setattr(
            mod, "training_latents_for_requests",
            lambda comps, block, *a, **k: (
                pad_c(mean[None], len(block))[0],
                pad_c(logvar[None], len(block))[0]))
    reqs = [{k: v for k, v in r.items() if k != "images"}
            for r in _requests(C)]
    jz = jeditor.compute_zs_for_requests(
        comps, reqs, JHP.from_dict(dict(HP)), block_size=8, eps_dest_pool=0,
        z_sched="const", mesh=jget_mesh(), verbose=False)
    tz = teditor.compute_zs_for_requests(
        tpc, reqs, THP.from_dict(dict(HP)), block_size=8, eps_dest_pool=0,
        z_sched="const", mesh=get_mesh(["cpu"] * 2), verbose=False)
    assert len(jax.devices()) == 8 and jnp.asarray(jz).shape == tz.shape
    assert rel_diff(np.asarray(jz), tz) <= 1e-4
