"""PyTorch port, the deviation-guard harness
(``emcid_torch/evals/deviation_harness.py``) against the JAX package.

Tolerances: the statistic (``null_band``, ``paired_report`` and the two
assert helpers) on JAX's own synthetic cases within 1e-12, with the same
verdicts and the same assertion messages; the registries equal, the
controls' ``z_transform`` compared by its effect on an array (exactly);
``metrics`` with ``generate`` stubbed in both packages and the same 4-label
guard-scorer weights in both: the triple within 1e-5; one ``run_mode``
seed on the tiny pipeline at the harness's 16 grad steps with the
Stage-1 draws replayed (the same training-image posterior, noise and
timesteps in both packages), the same covariance cache and the same
initial latents for the eval images,
through ``apply_emcid`` and through the ``z_transform`` seam: the metric
row within 1e-4.  The live lever and control runs of
``tests/test_deviation_guards.py`` are slow on the CPU; their copy runs on
the card (``chip_smoke.py``'s ``cert_path`` (b)), and a slow test runs
them through both packages at the JAX package's seed-0 weights (the
scorer's probabilities within 1e-5): the same verdicts.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

from emcid_tpu.evals import deviation_harness as jdh

from emcid_torch.evals import deviation_harness as tdh

from torch_parity import one_torch_thread, rel_diff  # noqa: F401

WORDS = ["cat", "dog", "bird", "fish"]


def _stat_case(case):
    """(function name, args) of JAX's statistic tests."""
    exact = np.zeros((3, 3))
    band = np.full(3, 0.05)
    if case == "null_band_se":
        return "null_band", ([np.full((4, 3), 0.1), np.full((4, 3), -0.1)],
                             np.zeros((4, 3)))
    if case == "paired_ok":
        return "paired_report", (exact + 0.01, exact, band)
    if case == "paired_bad":
        return "paired_report", (exact + np.array([0.2, 0.0, 0.0]), exact,
                                 band)
    if case == "within_raises":
        return "assert_within_noise", (exact + 0.2, exact, band, "x")
    if case == "outside_raises":
        return "assert_outside_noise", (exact + 0.01, exact, band, "x")
    if case == "within_ok":
        return "assert_within_noise", (exact + 0.01, exact, band, "x")
    return "assert_outside_noise", (exact + 0.2, exact, band, "x")


def _call(mod, name, args):
    try:
        return getattr(mod, name)(*args), None
    except AssertionError as e:
        return None, str(e)


@pytest.mark.parametrize("case", ["null_band_se", "paired_ok", "paired_bad",
                                  "within_raises", "outside_raises",
                                  "within_ok", "outside_ok"])
def test_statistic_matches_jax(case):
    name, args = _stat_case(case)
    ref, ref_err = _call(jdh, name, args)
    got, got_err = _call(tdh, name, args)
    assert got_err == ref_err
    assert (ref_err is None) == case.endswith(("_se", "_ok", "_bad"))
    if ref is None:
        return
    if isinstance(ref, dict):
        assert set(got) == set(ref)
        for k, v in ref.items():
            if isinstance(v, tuple):
                assert got[k] == v
            else:
                np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


def test_registries_match_jax():
    for name in ("SEEDS", "GEN", "N_STEPS", "NULL_RNGS", "NULL_SIGMAS",
                 "ABS_FLOOR", "TINY_HP", "LEVERS", "COMPOUND",
                 "SDXL_TINY_HP", "SDXL_LEVERS"):
        assert getattr(tdh, name) == getattr(jdh, name), name
    assert set(tdh.CONTROLS) == set(jdh.CONTROLS)
    z = np.random.RandomState(0).randn(2, 1, 8).astype(np.float32)
    for name, ctl in jdh.CONTROLS.items():
        for side, kw in ctl.items():
            tkw = dict(tdh.CONTROLS[name][side])
            jkw = dict(kw)
            jf, tf = jkw.pop("z_transform", None), tkw.pop("z_transform", None)
            assert tkw == jkw, (name, side)
            assert (jf is None) == (tf is None)
            if jf is not None:
                np.testing.assert_array_equal(np.asarray(tf(z)),
                                              np.asarray(jf(z)))
    assert tdh.edit_request(3) == jdh.edit_request(3)
    assert tdh.make_guard_scorer(device="cpu").model.config.num_labels == 4


def fake_generate(components, prompts, seeds, batch_size=None, **kwargs):
    """Images as a function of (prompt, seed) alone: 16x16 uint8."""
    return np.stack([
        np.random.RandomState((zlib.crc32(p.encode()) + 7919 * int(s))
                              % 2 ** 31).randint(0, 256, (16, 16, 3))
        .astype(np.uint8) for p, s in zip(prompts, seeds)])


@pytest.fixture(scope="module")
def guard_scorers():
    """The port's guard scorer and the JAX one on the same weights."""
    from emcid_tpu.evals.scorers import make_vit_scorer
    from emcid_tpu.models import vision as jv

    from emcid_torch.models import vision as tv
    from test_torch_scorers import _seeded_state

    cfg = dataclasses.replace(tv.TINY_VIT, num_labels=4)
    sd = _seeded_state(tv.ViTClassifier(cfg), seed=13)
    tscorer = tdh.make_guard_scorer(
        torch_state_dict={k: torch.from_numpy(v) for k, v in sd.items()},
        device="cpu")
    jscorer = make_vit_scorer(jv.ViTConfig(**dataclasses.asdict(cfg)),
                              torch_state_dict=sd)
    return tscorer, jscorer


@pytest.mark.parametrize("seed", [0, 5])
def test_metrics_match_jax(monkeypatch, guard_scorers, seed):
    import emcid_tpu.evals.iceb as jiceb
    import emcid_tpu.models.pipeline as jpipe

    import emcid_torch.evals.iceb as ticeb
    import emcid_torch.models.pipeline as tpipe

    for mod in (jiceb, ticeb, jpipe, tpipe):
        monkeypatch.setattr(mod, "generate", fake_generate)
    tscorer, jscorer = guard_scorers
    ref = jdh.metrics(None, jscorer, seed)
    got = tdh.metrics(None, tscorer, seed)
    assert got.shape == ref.shape == (3,)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_run_mode_matches_jax(monkeypatch, tmp_path, guard_scorers):
    """One seed of the exact protocol at the harness's own 16 grad steps,
    through ``apply_emcid`` and through the ``z_transform`` seam (z
    halved)."""
    import jax.numpy as jnp

    import emcid_tpu.engine.editor as jeditor
    import emcid_tpu.models.pipeline as jpipe
    from emcid_tpu.engine import compute_z as jcz
    from emcid_tpu.engine.layer_stats import COV_CACHE
    from emcid_tpu.models.loader import build_tiny_pipeline

    import emcid_torch.engine.editor as teditor
    import emcid_torch.models.pipeline as tpipe
    from emcid_torch.dsets.stat_dataset import make_synthetic_captions
    from emcid_torch.engine import compute_z as tcz
    from emcid_torch.engine.layer_stats import layer_stats_text_encoder
    from torch_parity import port_components

    comps = build_tiny_pipeline(seed=0, words=WORDS)
    pc = port_components(comps)
    steps, P = tdh.TINY_HP["v_num_grad_steps"], 2
    rng = np.random.RandomState(8)
    mean = rng.randn(1, 1, P, 8, 8, 4).astype(np.float32)
    logvar = np.full_like(mean, -60.0)
    noise = rng.randn(steps, 1, P, 8, 8, 4).astype(np.float32)
    ts = rng.randint(0, 1000, (steps, 1, P)).astype(np.int32)
    for mod in (jeditor, teditor):
        monkeypatch.setattr(mod, "training_latents_for_requests",
                            lambda *a, **k: (mean, logvar))
    jrun, trun = jcz.ZOptimizer.run, tcz.ZOptimizer.run
    monkeypatch.setattr(jcz.ZOptimizer, "run",
                        lambda self, tp, up, batch, key, **k: jrun(
                            self, tp, up, batch, key, noise_override=noise,
                            ts_override=ts))
    monkeypatch.setattr(tcz.ZOptimizer, "run",
                        lambda self, batch, gen=None, **k: trun(
                            self, batch, gen, noise_override=noise,
                            ts_override=ts))

    def lat(seeds, height, width, channels=4, vae_scale=8):
        return np.stack([np.random.RandomState(int(s)).randn(
            height // vae_scale, width // vae_scale, channels)
            .astype(np.float32) for s in seeds])

    monkeypatch.setattr(jpipe, "initial_latents",
                        lambda seeds, h, w, c=4, vs=8, dtype=None:
                        jnp.asarray(lat(seeds, h, w, c, vs)))
    monkeypatch.setattr(tpipe, "initial_latents",
                        lambda seeds, h, w, c=4, vs=8, device=None,
                        dtype=None: torch.from_numpy(lat(seeds, h, w, c, vs)))
    # one covariance cache, read by both packages
    hp = tdh.TINY_HP
    for layer in hp["layers"]:
        layer_stats_text_encoder(
            pc.text_encoder, pc.tokenizer,
            hp["rewrite_module_tmp"].format(layer), stats_dir=tmp_path,
            ds_name=hp["mom2_dataset"], sample_size=hp["mom2_n_samples"],
            captions=make_synthetic_captions(hp["mom2_n_samples"]))
    tscorer, jscorer = guard_scorers
    kw = dict(seeds=(0,),
              train_sampler="pndm", eps_dest_pool=0, z_sched="const")
    # both branches: apply_emcid, and the negative-control seam
    for extra in ({}, {"z_transform": lambda z: 0.5 * z}):
        COV_CACHE.clear()
        ref = jdh.run_mode(comps, jscorer, tmp_path, **kw, **extra)
        COV_CACHE.clear()
        got = tdh.run_mode(pc, tscorer, tmp_path, **kw, **extra)
        assert got.shape == ref.shape == (1, 3)
        assert rel_diff(ref, got) <= 1e-4, extra


def _vit_state_from_jax(params) -> dict:
    """JAX ``ViTClassifier`` params as the port's (HF-named) state dict:
    the inverse of ``emcid_tpu.models.vision.vit_from_torch``."""
    a = lambda x: torch.from_numpy(np.array(x, np.float32))
    sd = {"vit.embeddings.cls_token": a(params["cls_token"]),
          "vit.embeddings.position_embeddings": a(
              params["position_embeddings"]),
          "vit.embeddings.patch_embeddings.projection.weight": a(
              np.asarray(params["patch_embeddings"]["kernel"])
              .transpose(3, 2, 0, 1)),
          "vit.embeddings.patch_embeddings.projection.bias": a(
              params["patch_embeddings"]["bias"]),
          "vit.layernorm.weight": a(params["layernorm"]["scale"]),
          "vit.layernorm.bias": a(params["layernorm"]["bias"]),
          "classifier.weight": a(np.asarray(params["classifier"]["kernel"]).T),
          "classifier.bias": a(params["classifier"]["bias"])}
    i = 0
    while f"layer_{i}" in params:
        p, base = params[f"layer_{i}"], f"vit.encoder.layer.{i}"
        lin = {"attention.attention.query": p["attention"]["query"],
               "attention.attention.key": p["attention"]["key"],
               "attention.attention.value": p["attention"]["value"],
               "attention.output.dense": p["attention"]["output_dense"],
               "intermediate.dense": p["intermediate_dense"],
               "output.dense": p["output_dense"]}
        for n, q in lin.items():
            sd[f"{base}.{n}.weight"] = a(np.asarray(q["kernel"]).T)
            sd[f"{base}.{n}.bias"] = a(q["bias"])
        for n in ("layernorm_before", "layernorm_after"):
            sd[f"{base}.{n}.weight"] = a(p[n]["scale"])
            sd[f"{base}.{n}.bias"] = a(p[n]["bias"])
        i += 1
    return sd


@pytest.mark.slow
def test_live_control_verdict_matches_jax(tmp_path):
    """The live lever and z*0.5 control of ``tests/test_deviation_guards.py``
    at the JAX package's own seed-0 tiny pipeline and guard scorer, through
    both packages (each its own Stage-1 and eval draws; the scorer's
    probabilities within 1e-5 across packages): the same verdicts, lever
    inside its band and control outside it.  (At the port's own
    seed-0 weights both packages keep the control inside:
    ``scripts/torch_guard_witness.py``, ``scripts/guard_witness_jax.py``.)"""
    from emcid_tpu.models.loader import build_tiny_pipeline

    from torch_parity import port_components

    exact = dict(train_sampler="pndm", eps_dest_pool=0, z_sched="const",
                 cfg_interval=1.0, train_res=16)
    comps = build_tiny_pipeline(seed=0, words=WORDS)
    jscorer = jdh.make_guard_scorer()
    tscorer = tdh.make_guard_scorer(
        torch_state_dict=_vit_state_from_jax(jscorer.params), device="cpu")
    imgs = np.random.RandomState(0).randint(0, 256, (3, 16, 16, 3)).astype(
        np.uint8)
    np.testing.assert_allclose(tscorer.probs(imgs), jscorer.probs(imgs),
                               rtol=0, atol=1e-5)
    verdicts = {}
    for name, dh, c, s in (("jax", jdh, comps, jscorer),
                           ("port", tdh, port_components(comps), tscorer)):
        stats = tmp_path / name
        base = dh.run_mode(c, s, stats, **exact)
        band = dh.null_band([dh.run_mode(c, s, stats, rng_seed=r, **exact)
                             for r in dh.NULL_RNGS[:2]], base)
        lever = dh.run_mode(c, s, stats, **dict(exact, cfg_interval=0.6))
        control = dh.run_mode(c, s, stats, z_transform=lambda z: 0.5 * z,
                              **exact)
        lev, ctl = (dh.paired_report(x, base, band) for x in (lever, control))
        verdicts[name] = (bool(lev["ok"].all()), bool(ctl["ok"].all()))
        print(name, "band", band, "lever", lev["mean_delta"], "control",
              ctl["mean_delta"])  # the record, with -s
    assert verdicts["port"] == verdicts["jax"] == (True, False), verdicts
