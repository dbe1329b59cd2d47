"""PyTorch port, the gender debias and CLIP-tower edits against the JAX
package on the tiny pipeline: ``classify_ratio``, the factor search under a
scripted scorer (factors equal to the JAX factors: the same Python float
arithmetic over the same ratios), ``debias_ratios`` and the UCE debias
loop, ``compute_z_refact`` after its Adam steps, ``execute_emcid_clip`` on
one z, the debias evaluation's CSV, and the debias edit end to end.

Tolerances, relative to the largest reference value: 1e-4 for weights
after the closed-form solves and for z after Adam (f32 on both sides,
summation order only; the UCE solves at lamb 1, where mat2's condition
number stays near 2e3), 1e-5 for the Stage-2 deltas on one z.
"""

import weakref

import numpy as np
import pytest

import torch

import emcid_tpu.hparams as jhp
from emcid_tpu.engine import debias as jdeb
from emcid_tpu.engine import uce as juce
from emcid_tpu.models.loader import build_tiny_pipeline

import emcid_torch.hparams as thp
from emcid_torch.engine import debias as tdeb
from emcid_torch.engine import uce as tuce

from torch_parity import port_components, rel_diff, one_torch_thread  # noqa: F401

WORDS = ["nurse", "female", "male", "doctor", "person"]
GK = dict(num_inference_steps=2, height=16, width=16)


def _hp(pkg, layers=(2, 3), **over):
    d = {
        "layers": list(layers), "clamp_norm_factor": 1.5,
        "layer_selection": "all", "fact_token": "subject_last",
        "v_num_grad_steps": 2, "v_lr": 0.1, "v_weight_decay": 5e-4,
        "mom2_adjustment": True, "mom2_update_weight": 100,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 30,
        "mom2_dtype": "float32", "objective": "ablate-dest",
        "esd_mu": "None",
    }
    d.update(over)
    return pkg.EMCIDHyperParams.from_dict(d)


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(seed=0, words=WORDS)
    return comps, port_components(comps)


class ScriptedScorer:
    """Per-image class logits from a script: call k reads ratio
    ``script[min(k, len - 1)]`` (the images do not matter: what is under
    test is the ratio-feedback controller, not CLIP)."""

    def __init__(self, script):
        self.script = [np.asarray(s, np.float64) for s in script]
        self.calls = 0

    def logits_per_image(self, images, texts):
        ratio = self.script[min(self.calls, len(self.script) - 1)]
        self.calls += 1
        n = len(images)
        winners = (np.arange(n) < round(ratio[0] * n)).astype(int)
        logits = np.zeros((n, len(texts)))
        logits[winners == 1, 0] = 1.0
        logits[winners == 0, 1] = 1.0
        return logits


def _covs(n, dim=64, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        a = rng.randn(200, dim).astype(np.float32)
        out.append(a.T @ a / 200)
    return out


def test_classify_ratio_matches_jax():
    """The CLIP-argmax fractions over the dest texts: the same with the
    JAX package's and the port's CLIP scorer on the same towers."""
    from test_torch_scorers import _clip_pair

    tscorer, jscorer = _clip_pair(seed=21)
    imgs = np.random.RandomState(22).randint(0, 256, (8, 32, 32, 3)
                                             ).astype(np.uint8)
    dests = ["a photo of a cat", "a photo of a dog"]
    got = tdeb.classify_ratio(tscorer, imgs, dests)
    assert got == jdeb.classify_ratio(jscorer, imgs, dests)
    assert abs(sum(got) - 1.0) <= 1e-6
    assert tdeb.classify_ratio(ScriptedScorer([[0.25, 0.75]]), imgs,
                               dests) == [0.25, 0.75]


@pytest.mark.parametrize("script", [
    [[0.75, 0.25]], [[1.0, 0.0], [0.75, 0.25], [0.5, 0.5]],
    [[0.0, 1.0], [0.25, 0.75]]], ids=["steady", "converging", "other_way"])
def test_factor_search_equals_jax(pair, script):
    """``get_factors`` with its compounding step-length decay: given the
    same ratios, the port's factors equal the JAX factors exactly, and the
    caller's text encoder is unchanged."""
    comps, pc = pair
    rng = np.random.RandomState(4)
    zs = [rng.randn(1, 32).astype(np.float32) * 0.1 for _ in range(2)]
    reqs = [{"prompts": ["an image of {}"], "source": "nurse", "dest": d,
             "seed": 5} for d in ("a female nurse", "a male nurse")]
    before = {k: v.clone() for k, v in pc.text_encoder.state_dict().items()}
    kw = dict(num_samples=4, max_iter=3, gen_kwargs=GK, verbose=False)
    ref = jdeb.get_factors(comps, ScriptedScorer(script), _hp(jhp, (3,)),
                           zs, reqs, _covs(1), **kw)
    got = tdeb.get_factors(pc, ScriptedScorer(script), _hp(thp, (3,)), zs,
                           reqs, _covs(1), **kw)
    assert got == ref
    assert abs(sum(got) - 1.0) <= 1e-12
    assert all(torch.equal(v, before[k])
               for k, v in pc.text_encoder.state_dict().items())


def test_factor_search_drops_each_candidate(pair, monkeypatch):
    """Each iteration's edited text-encoder copy is gone before the next
    candidate is made, so memory does not grow with ``max_iter``."""
    comps, pc = pair
    real = tdeb.execute_emcid_text_encoder
    alive = []

    def spy(*args, **kwargs):
        assert all(r() is None for r in alive), "a candidate copy lived on"
        deltas, model = real(*args, **kwargs)
        alive.append(weakref.ref(model))
        return deltas, model

    monkeypatch.setattr(tdeb, "execute_emcid_text_encoder", spy)
    rng = np.random.RandomState(4)
    zs = [rng.randn(1, 32).astype(np.float32) * 0.1 for _ in range(2)]
    reqs = [{"prompts": ["an image of {}"], "source": "nurse", "dest": d,
             "seed": 5} for d in ("a female nurse", "a male nurse")]
    tdeb.get_factors(pc, ScriptedScorer([[1.0, 0.0]]), _hp(thp, (3,)), zs,
                     reqs, _covs(1), num_samples=2, max_iter=3,
                     gen_kwargs=GK, verbose=False)
    assert len(alive) == 3


def test_factor_search_repr_matches_jax(pair):
    """The representation-feedback search (no images): the port's factors
    follow the JAX package's to 1e-4 (the distances are f32 forwards)."""
    comps, pc = pair
    rng = np.random.RandomState(6)
    zs = [rng.randn(1, 32).astype(np.float32) for _ in range(2)]
    reqs = [{"prompts": ["an image of {}"], "source": "nurse", "dest": d,
             "seed": 5} for d in ("a female nurse", "a male nurse")]
    ref = jdeb.get_factors_repr(comps, _hp(jhp, (3,)), zs, reqs, _covs(1),
                                max_iter=3, verbose=False)
    got = tdeb.get_factors_repr(pc, _hp(thp, (3,)), zs, reqs, _covs(1),
                                max_iter=3, verbose=False)
    assert rel_diff(ref, got) <= 1e-4


def test_debias_ratios_matches_jax_and_bypasses(pair):
    comps, pc = pair
    kw = dict(num_samples=4, num_seeds=2, gen_kwargs=GK)
    ref = juce.debias_ratios(comps, ScriptedScorer([[0.75, 0.25]]),
                             ["doctor"], [["male", "female"]], **kw)
    scorer = ScriptedScorer([[0.75, 0.25]])
    got = tuce.debias_ratios(pc, scorer, ["doctor"], [["male", "female"]],
                             **kw)
    np.testing.assert_array_equal(got[0], ref[0])
    calls = scorer.calls
    again = tuce.debias_ratios(pc, scorer, ["doctor"], [["male", "female"]],
                               prev_ratio=got, ratio_diff=[0.01],
                               max_ratio_gap=0.05, **kw)
    assert scorer.calls == calls
    np.testing.assert_array_equal(again[0], got[0])


@pytest.mark.parametrize("case", ["converging", "with_k_retain"])
def test_edit_model_debias_matches_jax(pair, case):
    """The UCE debias loop: the same ratios and weights, two re-solves from
    the current weights, then convergence; every K/V projection within
    1e-4 (Frobenius) of the JAX package's; the caller's UNet unchanged and
    every other parameter shared with it."""
    comps, pc = pair
    script = [[1.0, 0.0], [0.8, 0.2], [0.5, 0.5]]
    kw = dict(max_iters=4, num_samples=10, num_seeds=1, gen_kwargs=GK,
              lamb=1.0, erase_scale=1.0, preserve_scale=0.5, verbose=False)
    if case == "with_k_retain":
        kw.update(retain_texts=["a person"], with_to_k=True)
    else:
        kw.update(with_to_k=False)
    jout, jw, jinit, jfinal = juce.edit_model_debias(
        comps, ScriptedScorer(script), ["doctor"], [["male", "female"]], **kw)
    before = {k: v.clone() for k, v in pc.unet.state_dict().items()}
    tout, tw, tinit, tfinal = tuce.edit_model_debias(
        pc, ScriptedScorer(script), ["doctor"], [["male", "female"]], **kw)
    for a, b in zip(jw + jinit + jfinal, tw + tinit + tfinal):
        np.testing.assert_allclose(b, a, rtol=1e-12)
    names = tuce.cross_attn_kv_layer_names(pc.unet)
    edited = [n for n in names if n.endswith(".to_v") or
              (case == "with_k_retain" and n.endswith(".to_k"))]
    for n in names:
        w_t = tout.unet.get_submodule(n).weight
        w_j = np.asarray(juce.get_unet_weight(jout.unet_params, n))
        assert rel_diff(w_j, w_t, "fro") <= 1e-4, n
        assert torch.equal(w_t, pc.unet.get_submodule(n).weight) == (
            n not in edited), n
    assert all(torch.equal(v, before[k])
               for k, v in pc.unet.state_dict().items())
    shared = dict(pc.unet.named_parameters())
    assert all(p is shared[k] for k, p in tout.unet.named_parameters()
               if k[:-len(".weight")] not in edited)


def test_edit_model_debias_balanced_is_a_no_op(pair):
    comps, pc = pair
    out, _, _, final = tuce.edit_model_debias(
        pc, ScriptedScorer([[0.5, 0.5]]), ["doctor"], [["male", "female"]],
        max_iters=3, num_samples=4, num_seeds=1, gen_kwargs=GK,
        verbose=False)
    assert out.unet is pc.unet
    np.testing.assert_allclose(final[0], [0.5, 0.5])


def test_compute_z_refact_matches_jax(pair):
    """The contrastive z after 5 Adam steps (dest + 2 negatives, edit layer
    2): <= 1e-4 of the JAX package's; with 0 steps it is z0."""
    from emcid_tpu.engine.compute_z_variants import compute_z_refact as jref

    from emcid_torch.engine.compute_z_variants import compute_z_refact

    comps, pc = pair
    req = {"prompts": ["a photo of a {}", "{}"], "source": "nurse",
           "dest": "a female doctor",
           "negative_prompts": ["a male person", "a nurse"]}
    ref = jref(comps, req, _hp(jhp, v_num_grad_steps=5), layer=2,
               verbose=False)
    got = compute_z_refact(pc, req, _hp(thp, v_num_grad_steps=5), layer=2,
                           rng=torch.Generator().manual_seed(0),
                           verbose=False)
    assert got.shape == (32,)
    assert rel_diff(ref, got) <= 1e-4
    z0 = compute_z_refact(pc, req, _hp(thp, v_num_grad_steps=0), layer=2,
                          verbose=False)
    assert not np.allclose(z0, got)


def test_execute_emcid_clip_matches_jax(pair, tmp_path):
    """The CLIP-tower edit on one cached z per request: the Stage-2 deltas
    (key x residual products) within 1e-5 of the JAX package's, only the
    edit layers' fc2 weights changed, the caller's tower unchanged."""
    from emcid_tpu.engine.clip_edit import execute_emcid_clip as jexec

    from emcid_torch.engine.clip_edit import apply_emcid_to_clip
    from emcid_torch.engine.emcid import save_z_cache

    comps, pc = pair
    reqs = [{"prompts": ["a photo of a {}", "{}"], "source": s, "dest": d}
            for s, d in (("nurse", "a doctor"), ("person", "a male"))]
    rng = np.random.RandomState(8)
    hp_t = _hp(thp)
    cache = f"{tmp_path}/z/"
    for i, r in enumerate(reqs):
        save_z_cache(cache, r, rng.randn(32).astype(np.float32), hp_t, idx=i)
    covs = _covs(2)
    jd, _ = jexec(comps.text_encoder, comps.text_params, comps.tokenizer,
                  reqs, _hp(jhp), covs=covs, cache_name=cache, verbose=False)
    before = {k: v.clone() for k, v in pc.text_encoder.state_dict().items()}
    edited, td = apply_emcid_to_clip(pc.text_encoder, pc.tokenizer, reqs,
                                     hp_t, covs=covs, cache_name=cache,
                                     verbose=False)
    assert set(td) == set(jd)
    for k in jd:
        ref = np.asarray(jd[k][0]) @ np.asarray(jd[k][1]).T
        got = td[k][0] @ td[k][1].T
        assert rel_diff(ref, got, "fro") <= 1e-5, k
    changed = sorted(k for k, v in edited.state_dict().items()
                     if not torch.equal(v, before[k]))
    assert changed == [f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                       for i in (2, 3)]
    assert all(torch.equal(v, before[k])
               for k, v in pc.text_encoder.state_dict().items())


def test_apply_debias_end_to_end(pair, tmp_path):
    """Per-dest z, the factor search and the blended insert on the port's
    tiny pipeline: one factor pair summing to 1, only the edit layers' fc2
    weights changed."""
    from types import SimpleNamespace

    from emcid_torch.cli.workflows import _clip_scorer

    _, pc = pair
    # the CLI's random tiny CLIP scorer over the pipeline's tokenizer
    tscorer = _clip_scorer(SimpleNamespace(clip_checkpoint=None, tiny=True),
                           pc)
    hp = _hp(thp)
    requests = [{"prompts": ["an image of {}"], "source": "nurse",
                 "dests": ["a female nurse", "a male nurse"],
                 "seed_train": 3, "seed": 3}]
    edited, deltas, factors = tdeb.apply_emcid_to_text_encoder_debias(
        pc, requests, hp, tscorer, max_iter=2, num_samples=4,
        num_inference_steps=2, gen_kwargs=GK, stats_dir=tmp_path,
        cache_name=f"{tmp_path}/z/", verbose=False)
    assert len(factors) == 1 and len(factors[0]) == 2
    assert abs(sum(factors[0]) - 1.0) <= 1e-9 and min(factors[0]) >= 0
    before = dict(pc.text_encoder.named_parameters())
    changed = sorted(k for k, v in edited.text_encoder.named_parameters()
                     if not torch.equal(v, before[k]))
    assert changed == [f"text_model.encoder.layers.{i}.mlp.fc2.weight"
                       for i in (2, 3)]


def test_debias_eval_matches_jax(pair, tmp_path):
    """The debias evaluation: the port's seeded image grid, then the
    per-profession deltas and the CSV from one image folder, equal with
    the JAX package's and the port's CLIP scorer on the same towers."""
    import csv

    from emcid_tpu.evals.debias_eval import eval_ratios as jeval
    from emcid_tpu.evals.debias_shared import ratio_delta as jdelta

    from emcid_torch.evals.debias_eval import (
        eval_ratios,
        generate_debias_eval_imgs,
    )
    from emcid_torch.evals.debias_shared import ratio_delta

    from test_torch_scorers import _clip_pair

    _, pc = pair
    prompts = ["an image of nurse"]
    generate_debias_eval_imgs(pc, prompts, tmp_path / "imgs",
                              imgs_per_prompt=3, num_seeds=2, gen_kwargs=GK)
    assert len(list((tmp_path / "imgs").rglob("*.png"))) == 6
    tscorer, jscorer = _clip_pair(seed=24)
    rows = [{"source": "nurse", "dests": ["a female nurse", "a male nurse"],
             "val_prompts": prompts}]
    got = eval_ratios(tscorer, rows, tmp_path / "imgs", tmp_path / "t.csv",
                      num_seeds=2, imgs_per_prompt=3)
    ref = jeval(jscorer, rows, tmp_path / "imgs", tmp_path / "j.csv",
                num_seeds=2, imgs_per_prompt=3)
    assert got == ref
    assert list(csv.reader(open(tmp_path / "t.csv"))) == \
        list(csv.reader(open(tmp_path / "j.csv")))
    for r in (0.0, 0.25, 0.5, 1.0):
        assert ratio_delta(r) == jdelta(r)
