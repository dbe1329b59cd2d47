"""PyTorch port, the baselines and experiments against the JAX package:

* ``experiments/finetune.py`` on the JAX tiny pipeline's weights, with the
  JAX run's posterior draws, noise and timesteps replayed
  (``FinetuneDraws``, recomputed from its key schedule): the loss curve and
  the fc2 weights after 3 steps;
* ``experiments/sequential.py``, the four sweeps of
  ``experiments/ablation.py`` and ``evals/mixed_safety.py`` with
  ``generate`` replaced in both packages by one numpy function of (prompt,
  seed) and the edits (``apply_emcid``, ``edit_model_uce``) by recorders
  that return the pipeline unchanged (both harnesses then score the same
  images with the same ViT): the same file names, summary keys, records
  and edit calls;
* the port's sequential chain and mixed edit end to end on its tiny
  pipeline: images per stage, which weights each round and each edit
  changed, the cached second call.

Tolerances: finetune 1e-4 relative to the largest reference value
(``rel_diff``; three Adam steps through the UNet's backward in f32);
records 1e-5 relative per field (one f32 ViT pass over the same uint8
images); names, keys and calls exact.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import emcid_tpu.engine.editor as jeditor
import emcid_tpu.engine.uce as juce
import emcid_tpu.evals.i2p_eval as ji2p
import emcid_tpu.evals.iceb as jiceb
import emcid_tpu.experiments.sequential as jseq
from emcid_tpu.experiments import ablation as jabl
from emcid_tpu.evals.mixed_safety import emcid_test_sd_imgnet_and_i2p as jmixed
from emcid_tpu.experiments.finetune import finetune_text_encoder as jfinetune
from emcid_tpu.hparams import EMCIDHyperParams as JHP
from emcid_tpu.models.loader import build_tiny_pipeline
from emcid_tpu.models.naming import get_weight

import emcid_torch.engine.editor as teditor
import emcid_torch.engine.uce as tuce
import emcid_torch.evals.i2p_eval as ti2p
import emcid_torch.evals.iceb as ticeb
import emcid_torch.experiments.sequential as tseq
from emcid_torch.evals import emcid_test_sd_imgnet_and_i2p as tmixed
from emcid_torch.experiments import ablation as tabl
from emcid_torch.experiments.finetune import (
    FinetuneDraws,
    finetune_text_encoder,
)
from emcid_torch.hparams import EMCIDHyperParams as THP

from test_torch_iceb import fake_generate, write_tree
from test_torch_scorers import TINY_1000, _vit_pair

from torch_parity import port_components, rel_diff, one_torch_thread  # noqa: F401

HP = dict(
    layers=[2, 3], clamp_norm_factor=1.5, layer_selection="all",
    fact_token="subject_last", v_num_grad_steps=2, v_lr=0.1,
    v_weight_decay=5e-4, mom2_adjustment=True, mom2_update_weight=100,
    rewrite_module_tmp="text_model.encoder.layers.{}.mlp.fc2",
    layer_module_tmp="text_model.encoder.layers.{}",
    mlp_module_tmp="text_model.encoder.layers.{}.mlp",
    attn_module_tmp="text_model.encoder.layers.{}.self_attn",
    ln_f_module="text_model.final_layer_norm",
    mom2_dataset="ccs_filtered", mom2_n_samples=30, mom2_dtype="float32",
    objective="ablate-dest", esd_mu="None")
GEN = dict(num_inference_steps=2, height=16, width=16)
FC2 = "text_model.encoder.layers.{}.mlp.fc2.weight"


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(words=["cat", "dog", "bird"])
    return comps, port_components(comps)


@pytest.fixture(scope="module")
def vits():
    tscorer, jscorer, _ = _vit_pair(TINY_1000, seed=11)
    return tscorer, jscorer


# ---------------------------------------------------------------------------
# finetune
# ---------------------------------------------------------------------------


def _jax_draws(rng, steps, shape, B, T):
    """The JAX finetune's draws: per step key, split in three (posterior,
    noise, timesteps)."""
    post, noise, ts = [], [], []
    for key in jax.random.split(rng, steps):
        k_post, k_noise, k_t = jax.random.split(key, 3)
        post.append(np.asarray(jax.random.normal(k_post, shape, jnp.float32)))
        noise.append(np.asarray(jax.random.normal(k_noise, shape,
                                                  jnp.float32)))
        ts.append(np.asarray(jax.random.randint(k_t, (B,), 0, T)))
    return FinetuneDraws(post, noise, ts)


def test_finetune_matches_jax_replayed(pair):
    """Both loss terms (the noise MSE and the pooled alignment)."""
    jc, tc = pair
    reqs = [{"prompts": ["a photo of {}", "{}"], "source": "cat",
             "dest": "dog", "seed_train": 0},
            {"prompts": ["a photo of {}", "{}"], "source": "bird",
             "dest": "cat", "seed_train": 1}]
    rng = np.random.RandomState(0)
    mean = rng.randn(2, 1, 2, 8, 8, 4).astype(np.float32) * 0.18
    logvar = np.full(mean.shape, -6.0, np.float32)
    steps, key = 3, jax.random.PRNGKey(4)
    jedited, jlosses = jfinetune(jc, reqs, JHP.from_dict(HP), mean, logvar,
                                 steps=steps, lr=1e-3, rng=key,
                                 verbose=False)
    draws = _jax_draws(key, steps, (4, 8, 8, 4), 4,
                       jc.schedule.num_train_timesteps)
    before = {k: v.clone() for k, v in tc.text_encoder.state_dict().items()}
    edited, losses = finetune_text_encoder(
        tc, reqs, THP.from_dict(HP), mean, logvar, steps=steps, lr=1e-3,
        replay=draws, verbose=False)
    assert len(losses) == steps and np.isfinite(losses).all()
    assert rel_diff(jlosses, np.asarray(losses)) <= 1e-4
    state = edited.text_encoder.state_dict()
    for layer in HP["layers"]:
        ref = np.asarray(get_weight(jedited.text_params,
                                    HP["rewrite_module_tmp"].format(layer)))
        assert rel_diff(ref, state[FC2.format(layer)]) <= 1e-4
    changed = {k for k, v in state.items() if not torch.equal(v, before[k])}
    assert changed == {FC2.format(l) for l in HP["layers"]}
    # the given components are left as they were
    assert all(torch.equal(v, before[k])
               for k, v in tc.text_encoder.state_dict().items())


def test_finetune_seeded_draws(pair):
    """Without a replay the draws come from the seed: the same seed gives
    the same curve."""
    _, tc = pair
    reqs = [{"prompts": ["{}"], "source": "cat", "dest": "dog",
             "seed_train": 0}]
    mean = np.random.RandomState(1).randn(1, 1, 1, 8, 8, 4).astype(
        np.float32) * 0.18
    logvar = np.full(mean.shape, -6.0, np.float32)
    runs = [finetune_text_encoder(tc, reqs, THP.from_dict(HP), mean, logvar,
                                  steps=2, lr=1e-3, seed=s, verbose=False)[1]
            for s in (5, 5, 6)]
    assert runs[0] == runs[1] and runs[0] != runs[2]


# ---------------------------------------------------------------------------
# sequential, ablations, mixed edit: the harnesses with generate and the
# edits stubbed in both packages
# ---------------------------------------------------------------------------


@pytest.fixture
def stubbed(monkeypatch):
    """generate -> ``fake_generate``; apply_emcid / edit_model_uce ->
    recorders returning the pipeline unchanged.  Yields {package: calls}."""
    calls = {"jax": [], "port": []}

    def recorder(name, label):
        def edit(components, *args, **kwargs):
            calls[label].append((name, args, kwargs))
            return (components, {}) if name == "apply_emcid" else components
        return edit

    for label, mods, editor, uce in (
            ("jax", (jiceb, jseq, ji2p), jeditor, juce),
            ("port", (ticeb, tseq, ti2p), teditor, tuce)):
        for mod in mods:
            monkeypatch.setattr(mod, "generate", fake_generate)
        monkeypatch.setattr(editor, "apply_emcid",
                            recorder("apply_emcid", label))
        monkeypatch.setattr(uce, "edit_model_uce",
                            recorder("edit_model_uce", label))
    return calls


def _close(ref, got):
    ref = {k: v for k, v in ref.items() if k != "edit_time_s"}
    got = {k: v for k, v in got.items() if k != "edit_time_s"}
    assert set(got) == set(ref)
    for k, v in ref.items():
        if isinstance(v, str) or v is None:
            assert got[k] == v, k
        else:
            assert abs(got[k] - v) <= 1e-5 * max(abs(v), 1e-30), (k, v,
                                                                 got[k])


def _hp_fields(call):
    """The edit settings an ``apply_emcid`` call received."""
    _, args, kwargs = call
    hp = args[1]
    return (list(hp.layers), hp.num_edit_tokens, kwargs.get("edit_weight"),
            kwargs.get("mom2_weight"), len(args[0]))


def test_sequential_matches_jax(stubbed, tmp_path):
    rounds = [[{"source": "cat", "dest": d, "prompts": ["a photo of {}"],
                "seed_train": i}] for i, d in enumerate(("dog", "bird"))]
    names = {}
    for label, mod, hp in (("jax", jseq, JHP.from_dict(HP)),
                           ("port", tseq, THP.from_dict(HP))):
        hist = mod.sequential_editing(
            None, rounds, hp, val_prompts=["a photo of cat", "w1"],
            save_dir=tmp_path / label, sample_num=2, gen_kwargs=GEN,
            verbose=False)
        assert len(hist) == 3
        names[label] = sorted(p.name for p in (tmp_path / label).glob("*"))
    assert names["port"] == names["jax"]
    assert len(names["port"]) == 2 * 2 * 3
    assert "a photo of cat_round1-seed1.png" in names["port"]
    assert [_hp_fields(c) for c in stubbed["port"]] == \
        [_hp_fields(c) for c in stubbed["jax"]]
    # images already on disk are not generated again
    n = len(stubbed["port"])
    tseq.sequential_editing(None, rounds[:1], THP.from_dict(HP),
                            val_prompts=["w1"], save_dir=tmp_path / "port",
                            sample_num=2, gen_kwargs=GEN, verbose=False)
    assert len(stubbed["port"]) == n + 1


SWEEPS = {
    "edit_weight": ("edit_weight_ablation", dict(edit_weights=(0.3, 0.7))),
    "layers": ("layer_combination_ablation",
               dict(layer_sets=[[2, 3], [1, 2, 3]])),
    "tokens": ("num_edit_tokens_ablation", dict(token_counts=(1, 2))),
}


@pytest.mark.parametrize("sweep", sorted(SWEEPS))
def test_ablation_matches_jax(stubbed, tmp_path, vits, sweep):
    fn, kw = SWEEPS[sweep]
    data = write_tree(tmp_path)
    tscorer, jscorer = vits
    out, files = {}, {}
    for label, mod, scorer, hp in (("jax", jabl, jscorer, JHP.from_dict(HP)),
                                   ("port", tabl, tscorer,
                                    THP.from_dict(HP))):
        res = tmp_path / f"results_{label}"
        out[label] = getattr(mod, fn)(
            None, scorer, hp, "tiny-hp", num_edit=2, data_dir=data,
            cache_dir=tmp_path / f"cache_{label}", results_dir=res,
            gen_kwargs=GEN, specificity_classes=2, **kw)
        files[label] = {str(p.relative_to(res)): json.loads(p.read_text())
                        for p in sorted(res.rglob("*.json"))}
    assert list(out["port"]) == list(out["jax"])
    for k in out["jax"]:
        _close(out["jax"][k], out["port"][k])
    assert list(files["port"]) == list(files["jax"])
    for f, summary in files["jax"].items():
        assert list(files["port"][f]) == list(summary)
        for key, rec in summary.items():
            _close(rec, files["port"][f][key])
    assert [_hp_fields(c) for c in stubbed["port"]] == \
        [_hp_fields(c) for c in stubbed["jax"]]


def test_i2p_guidance_ablation_matches_jax(stubbed, tmp_path):
    rows = [{"prompt": f"a photo of w{i}", "evaluation_seed": 7 + i,
             "case_number": i} for i in range(3)]
    dirs = {}
    for label, mod in (("jax", jabl), ("port", tabl)):
        dirs[label] = mod.i2p_guidance_ablation(
            None, rows, tmp_path / label, guidance_scales=(0.0, 7.5),
            gen_kwargs=GEN)
    assert list(dirs["port"]) == list(dirs["jax"]) == [0.0, 7.5]
    for g in (0.0, 7.5):
        a = sorted(p.name for p in (tmp_path / "jax" / f"g{g}").glob("*"))
        b = sorted(p.name for p in (tmp_path / "port" / f"g{g}").glob("*"))
        assert a == b == ["0.png", "1.png", "2.png"]


def test_mixed_edit_matches_jax(stubbed, tmp_path, vits):
    data = write_tree(tmp_path)
    tscorer, jscorer = vits
    i2p_rows = [{"prompt": f"a photo of w{i}", "evaluation_seed": 3 + i,
                 "evaluation_guidance": 7.5, "case_number": i}
                for i in range(2)]
    out, files = {}, {}
    for label, fn, scorer, hp in (("jax", jmixed, jscorer, JHP.from_dict(HP)),
                                  ("port", tmixed, tscorer,
                                   THP.from_dict(HP))):
        res = tmp_path / f"results_{label}"
        kw = dict(num_edit=2, data_dir=data,
                  cache_dir=tmp_path / f"cache_{label}", results_dir=res,
                  gen_kwargs=GEN, specificity_classes=2, i2p_rows=i2p_rows,
                  nsfw_keywords=("nudity", "w5"))
        out[label] = fn(None, scorer, hp, "tiny-hp", **kw)
        again = fn(None, scorer, hp, "tiny-hp", **kw)
        assert again == out[label]  # the cached record
        files[label] = {str(p.relative_to(res)) for p in res.rglob("*")
                        if p.is_file()}
    i2p_dir = out["port"].pop("i2p_image_dir")
    assert i2p_dir.endswith("images/i2p/tiny-hp_edit2_weight100")
    assert out["jax"].pop("i2p_image_dir").endswith(
        "images/i2p/tiny-hp_edit2_weight100")
    _close(out["jax"], out["port"])
    assert files["port"] == files["jax"]
    assert "tiny-hp/imgnet_aug_i2p_summary.json" in {
        f.split("emcid/")[-1] for f in files["port"]}
    names = lambda calls: [(c[0], c[1] if c[0] == "edit_model_uce"
                            else None) for c in calls]
    assert names(stubbed["port"]) == names(stubbed["jax"]) == [
        ("apply_emcid", None),
        ("edit_model_uce", (["nudity", "w5"], [" ", " "]))]


# ---------------------------------------------------------------------------
# the port's sequential chain and mixed edit end to end
# ---------------------------------------------------------------------------


def test_sequential_end_to_end(pair, tmp_path):
    _, tc = pair
    hp = THP.from_dict(HP)
    rounds = [[{"source": "cat", "dest": d, "prompts": ["a photo of {}"],
                "seed_train": i}] for i, d in enumerate(("dog", "bird"))]
    hist = tseq.sequential_editing(
        tc, rounds, hp, val_prompts=["a photo of cat"],
        save_dir=tmp_path / "seq", sample_num=2, gen_kwargs=GEN,
        apply_kwargs=dict(num_inference_steps=2, stats_dir=tmp_path / "s",
                          fim_dir=tmp_path / "f"),
        verbose=False)
    pngs = sorted(p.name for p in (tmp_path / "seq").glob("*.png"))
    assert pngs == [f"a photo of cat_{s}-seed{i}.png"
                    for s in ("pre", "round0", "round1") for i in (0, 1)]
    fc2 = {FC2.format(l) for l in HP["layers"]}
    for a, b in zip(hist, hist[1:]):
        sa, sb = a.text_encoder.state_dict(), b.text_encoder.state_dict()
        assert {k for k in sa if not torch.equal(sa[k], sb[k])} == fc2
        assert b.unet is a.unet


def test_mixed_edit_end_to_end(pair, tmp_path, vits, monkeypatch):
    """The EMCID edit then UCE on the same pipeline: the text encoder's fc2
    and the UNet's cross-attention K/V change; a second call returns the
    stored record without editing."""
    _, tc = pair
    tscorer, _ = vits
    data = write_tree(tmp_path)
    edits = []
    real_uce = tuce.edit_model_uce

    def spy(components, *args, **kwargs):
        out = real_uce(components, *args, **kwargs)
        edits.append((components, out))
        return out

    monkeypatch.setattr(tuce, "edit_model_uce", spy)
    kw = dict(num_edit=2, data_dir=data, cache_dir=tmp_path / "cache",
              results_dir=tmp_path / "results", gen_kwargs=GEN,
              specificity_classes=2,
              i2p_rows=[{"prompt": "a photo of w1", "evaluation_seed": 1,
                         "evaluation_guidance": 7.5, "case_number": 0}],
              apply_kwargs=dict(num_inference_steps=2,
                                stats_dir=tmp_path / "s",
                                fim_dir=tmp_path / "f", verbose=False))
    rec = tmixed(tc, tscorer, THP.from_dict(HP), "tiny-hp", **kw)
    assert len(edits) == 1
    before, after = edits[0]
    kv = {f"{n}.weight" for n in tuce.cross_attn_kv_layer_names(tc.unet)}
    ua, ub = before.unet.state_dict(), after.unet.state_dict()
    assert {k for k in ua if not torch.equal(ua[k], ub[k])} == kv
    ta, tb = tc.text_encoder.state_dict(), after.text_encoder.state_dict()
    assert {k for k in ta if not torch.equal(ta[k], tb[k])} == {
        FC2.format(l) for l in HP["layers"]}
    fields = [k for k in rec if k.startswith(("pre_", "post_"))]
    assert len(fields) == 20 and all(np.isfinite(rec[k]) for k in fields)
    assert (tmp_path / "results").exists()
    assert len(list((tmp_path / "results").rglob("0.png"))) == 1
    again = tmixed(tc, tscorer, THP.from_dict(HP), "tiny-hp", **kw)
    assert again == rec and len(edits) == 1
