"""PyTorch port, lever certification (``emcid_torch/evals/lever_cert.py``)
against the JAX package.

Tolerances: ``agreement`` within 1e-12 of JAX's and ``lever_specs`` equal;
``certify_levers`` with ``stage1_deltas`` stubbed by the same scripted
deltas and losses in both packages: every verdict equal, every cos, ratio
and loss within 1e-12, and the JSON equal to JAX's but for the two
deliberate compound-row fields (the rule ``"z-agreement-or-loss"`` with its
``guard_bands`` pointer, and ``functional_gate: "guard_bands pending"`` on
a KEEP); ``stage1_deltas`` on the tiny pipeline with the training-image
posterior fed and JAX's noise and timesteps replayed: delta within 1e-4
relative and the loss curve within 1e-4 relative; ``workflows
certify_levers --tiny --platform cpu`` writes the JSON.
"""

import json
import types
import zlib

import numpy as np
import pytest

from emcid_tpu.evals import lever_cert as jlc

from emcid_torch.evals import lever_cert as tlc

from torch_parity import TINY_WORDS, one_torch_thread, rel_diff  # noqa: F401

TINY_HP = {
    "layers": [2, 3], "clamp_norm_factor": 1.5, "layer_selection": "all",
    "fact_token": "subject_last", "v_num_grad_steps": 4, "v_lr": 0.1,
    "v_weight_decay": 5e-4, "mom2_adjustment": True,
    "mom2_update_weight": 4000,
    "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
    "layer_module_tmp": "text_model.encoder.layers.{}",
    "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
    "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
    "ln_f_module": "text_model.final_layer_norm",
    "mom2_dataset": "ccs_filtered", "mom2_n_samples": 100,
    "mom2_dtype": "float32", "objective": "ablate-dest", "esd_mu": "None",
    "cal_text_repr_loss": True, "text_repr_loss_scale_factor": 0.01,
}
REQS = [{"prompts": ["a photo of {}", "{}"], "source": s, "dest": d,
         "seed_train": i}
        for i, (s, d) in enumerate([("cat", "dog"), ("w1", "w2")])]


def _stand_in(native: int):
    """What ``lever_specs`` reads of a pipeline: the UNet's sample size and
    the VAE scale."""
    return types.SimpleNamespace(
        unet=types.SimpleNamespace(config=types.SimpleNamespace(
            sample_size=native // 8)), vae_scale=8)


@pytest.mark.parametrize("case", ["parallel", "orthogonal", "scaled",
                                  "random"])
def test_agreement_matches_jax(case):
    rng = np.random.RandomState(3)
    a = rng.randn(3, 2, 5)
    if case == "parallel":
        b = a * 3.0
    elif case == "orthogonal":  # JAX's own case
        a = np.array([[1.0, 0.0], [0.0, 2.0]])
        b = np.array([[0.0, 1.0], [2.0, 0.0]])
    elif case == "scaled":
        b = a * np.array([0.5, 1.0, 2.0])[:, None, None]
    else:
        b = rng.randn(3, 2, 5)
    for ref, got in zip(jlc.agreement(a, b), tlc.agreement(a, b)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.mark.parametrize("native", [512, 1024, 16])
def test_lever_specs_match_jax(native):
    comps = _stand_in(native)
    assert tlc.lever_specs(comps) == jlc.lever_specs(comps)
    assert set(tlc.lever_specs(comps)) == set(tlc.RESTORE_RECIPES)
    assert tlc.RESTORE_RECIPES == jlc.RESTORE_RECIPES
    assert (tlc.FLOOR_SIGMAS, tlc.RATIO_TOL, tlc.LOSS_TOL) == (
        jlc.FLOOR_SIGMAS, jlc.RATIO_TOL, jlc.LOSS_TOL)
    assert tlc.COMPOUND_RECIPE == jlc.COMPOUND_RECIPE
    assert tlc.default_requests(5) == jlc.default_requests(5)


def _resolved(kw):
    """The resolution a Stage-1 run with ``kw`` trains at, on a native-512
    pipeline (``editor.resolve_train_res``'s rule)."""
    import os

    if kw.get("train_res") is not None:
        return kw["train_res"]
    return 512 if os.environ.get("EMCID_TPU_TRAIN_RES") == "0" else 384


def _scripted(scenario, seen=None):
    """A ``stage1_deltas`` stand-in: deltas and losses from a seed of the
    run's kwargs (the resolution as resolved).  "keep": every default run
    close to the exact one; "restore": default runs far from it and their
    losses doubled.  ``seen`` collects each run's resolved kwargs."""
    base = np.random.RandomState(0).randn(2, 1, 8).astype(np.float32)

    def fake(components, requests, hparams, rng_seed=0,
             num_inference_steps=50, **kw):
        kw = dict(kw, train_res=_resolved(kw))
        if seen is not None:
            seen.append(kw)
        key = json.dumps(dict(kw, rng_seed=rng_seed), sort_keys=True)
        r = np.random.RandomState(zlib.crc32(key.encode()))
        exact = kw == dict(train_sampler="pndm", eps_dest_pool=0,
                           z_sched="const", cfg_interval=1.0, train_res=512)
        amp = 0.05 if exact or scenario == "keep" else 0.9
        delta = base + amp * r.randn(*base.shape).astype(np.float32)
        losses = (1.0 + 0.1 * r.rand(20)).astype(np.float32)
        if not exact and scenario == "restore":
            losses = 2.0 * losses
        return dict(delta=delta, losses=losses)

    return fake


@pytest.mark.parametrize("scenario", ["keep", "restore"])
def test_certify_levers_verdicts_match_jax(tmp_path, monkeypatch, scenario):
    """With ``EMCID_TPU_TRAIN_RES=0`` both packages' exact side trains at
    512 px, and every row agrees."""
    monkeypatch.setenv("EMCID_TPU_TRAIN_RES", "0")
    monkeypatch.setattr(jlc, "stage1_deltas", _scripted(scenario))
    monkeypatch.setattr(tlc, "stage1_deltas", _scripted(scenario))
    comps = _stand_in(512)
    kw = dict(requests=REQS, num_inference_steps=10, verbose=True)
    ref = jlc.certify_levers(comps, None, out_path=str(tmp_path / "j.json"),
                             **kw)
    got = tlc.certify_levers(comps, None, out_path=str(tmp_path / "t.json"),
                             **kw)
    assert set(got) == set(ref) == {"_floor", "compound"} | set(
        tlc.RESTORE_RECIPES)
    for name, row in ref.items():
        for k, v in row.items():
            if k == "rule" and name == "compound":
                continue
            if isinstance(v, float):
                assert abs(got[name][k] - v) <= 1e-12, (name, k)
            else:
                assert got[name][k] == v, (name, k)
    compound = got["compound"]
    assert ref["compound"]["rule"] == "z-agreement-or-loss+guards"
    assert compound["rule"] == "z-agreement-or-loss"
    assert compound["guard_bands"] == tlc.GUARD_BANDS
    if compound["keep"]:
        assert compound["functional_gate"] == "guard_bands pending"
    else:
        assert "functional_gate" not in compound
    assert compound["keep"] is (scenario == "keep")
    jj = json.loads((tmp_path / "j.json").read_text())
    tj = json.loads((tmp_path / "t.json").read_text())
    for row in (jj["compound"], tj["compound"]):
        for k in ("rule", "guard_bands", "functional_gate"):
            row.pop(k, None)
    assert tj == jj


def test_exact_side_trains_at_native_resolution(monkeypatch):
    """The fault the port repairs: without ``EMCID_TPU_TRAIN_RES``, the JAX
    package's exact side resolves to the product's 384 px, the same run as
    the train_res lever's default side; the port's exact side trains at
    the native 512 px."""
    monkeypatch.delenv("EMCID_TPU_TRAIN_RES", raising=False)
    seen = {"jax": [], "port": []}
    for name, mod in (("jax", jlc), ("port", tlc)):
        monkeypatch.setattr(mod, "stage1_deltas",
                            _scripted("keep", seen[name]))
        res = mod.certify_levers(_stand_in(512), None, requests=REQS,
                                 verbose=False, out_path=None)
        exact, train_res_default = seen[name][0], seen[name][3 + 2]
        assert train_res_default["train_res"] == 384
        if name == "jax":
            assert exact == train_res_default
            assert res["train_res"]["cos_mean"] == pytest.approx(1.0)
        else:
            assert exact["train_res"] == 512
            assert all(kw["train_res"] == 512 for kw in seen[name][:2])


def test_stage1_deltas_matches_jax(monkeypatch):
    """Both packages' ``stage1_deltas`` at the tiny size: the same
    training-image posterior (one image per prompt, logvar -60, so the
    image index and the posterior draw drop out) and JAX's noise and
    timesteps, fed to the port through ``draws=``."""
    import emcid_tpu.engine.training_images as jti
    import jax
    from emcid_tpu.engine import compute_z as jcz
    from emcid_tpu.hparams import EMCIDHyperParams as JHP
    from emcid_tpu.models.loader import build_tiny_pipeline

    import emcid_torch.engine.training_images as tti
    from emcid_torch.hparams import EMCIDHyperParams as THP
    from torch_parity import port_components

    comps = build_tiny_pipeline(seed=0, words=TINY_WORDS)
    pc = port_components(comps)
    C, P, steps = 2, 2, TINY_HP["v_num_grad_steps"]
    rng = np.random.RandomState(4)
    mean = rng.randn(C, 1, P, 8, 8, 4).astype(np.float32)
    logvar = np.full_like(mean, -60.0)
    noise = rng.randn(steps, C, P, 8, 8, 4).astype(np.float32)
    ts = rng.randint(0, 1000, (steps, C, P)).astype(np.int32)
    for mod in (jti, tti):
        monkeypatch.setattr(mod, "training_latents_for_requests",
                            lambda *a, **k: (mean, logvar))
    jrun = jcz.ZOptimizer.run
    monkeypatch.setattr(jcz.ZOptimizer, "run",
                        lambda self, tp, up, batch, key, **k: jrun(
                            self, tp, up, batch, key, noise_override=noise,
                            ts_override=ts))
    kw = dict(rng_seed=0, num_inference_steps=2, train_sampler="pndm",
              eps_dest_pool=0, z_sched="const")
    ref = jlc.stage1_deltas(comps, REQS, JHP.from_dict(TINY_HP), **kw)
    got = tlc.stage1_deltas(pc, REQS, THP.from_dict(TINY_HP),
                            draws=(noise, ts), **kw)
    assert got["delta"].dtype == got["losses"].dtype == np.float32
    assert got["delta"].shape == ref["delta"].shape
    assert rel_diff(ref["delta"], got["delta"], norm="fro") <= 1e-4
    assert rel_diff(ref["losses"], got["losses"]) <= 1e-4
    assert len(jax.devices()) >= 1


def test_workflows_certify_levers_tiny_cpu(tmp_path):
    """``workflows certify_levers --tiny --platform cpu --n_concepts 2
    --goldens``: the tiny pipeline's own goldens pass, a pipeline of
    another seed's goldens stop the run before Stage 1, and the verdict
    JSON lands under ``--results_dir``."""
    from emcid_torch.cli import workflows
    from emcid_torch.hparams import EMCIDHyperParams

    hp_dir = tmp_path / "hp"
    hp_dir.mkdir()
    (hp_dir / "hp.json").write_text(
        EMCIDHyperParams.from_dict(TINY_HP).to_json(hp_dir).read_text())
    goldens = {}
    for seed in (0, 1):
        goldens[seed] = tmp_path / f"goldens_{seed}.npz"
        workflows.main(["validate", "--tiny", "--platform", "cpu", "--seed",
                        str(seed), "--make_self_goldens",
                        str(goldens[seed])])
    argv = [
        "certify_levers", "--tiny", "--platform", "cpu", "--hparam", "hp",
        "--hparams_dir", str(hp_dir), "--results_dir", str(tmp_path / "r"),
        "--stats_dir", str(tmp_path / "s"), "--steps", "2",
        "--n_concepts", "2", "--seed", "0", "--goldens"]
    with pytest.raises(AssertionError):
        workflows.main(argv + [str(goldens[1])])
    assert not (tmp_path / "r").exists()
    res = workflows.main(argv + [str(goldens[0])])
    out = json.loads((tmp_path / "r" / "lever_cert.json").read_text())
    assert set(out) == {"_floor", "compound"} | set(tlc.RESTORE_RECIPES)
    assert out["_floor"]["n_concepts"] == 2
    assert all(isinstance(row["keep"], bool) for k, row in out.items()
               if not k.startswith("_"))
    assert res["compound"]["rule"] == "z-agreement-or-loss"
