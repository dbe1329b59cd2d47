"""PyTorch port, the ICEB harnesses against the JAX package: the AICE metric
bundle (``eval_pipe_imgnet``) and the Concept Rectification bundle with
``generate`` replaced in both harness modules by one numpy function of
(prompt, seed) (initial latents cannot match across frameworks), the same
ViT weights in both (a tiny tower with a 1000-label head), and a PNG cache
written by the JAX harness read by the port's; then the port's AICE and
rectification runs end to end on its tiny pipeline: schema, idempotence,
the pre-edit cache names and which parameters changed.

Tolerance: 1e-5 relative per field (one f32 ViT pass over the same uint8
images in both).
"""

import json
import zlib

import numpy as np
import pytest
import torch

import emcid_tpu.evals.iceb as jiceb
import emcid_tpu.evals.rectification as jrect

import emcid_torch.evals.iceb as ticeb
import emcid_torch.evals.rectification as trect
from emcid_torch.evals import scorers as ts

from test_torch_scorers import TINY_1000, _vit_pair

from torch_parity import one_torch_thread  # noqa: F401

FIELDS = ("source_cls_score_edit", "dest_cls_score_edit",
          "source_dest_cls_score_edit", "cls_score_specificity",
          "source_cls_score_general", "dest_cls_score_general",
          "source_dest_cls_score_general", "source_cls_score_alias",
          "dest_cls_score_alias", "source_dest_cls_score_alias")


def fake_generate(components, prompts, seeds, batch_size=None, **kwargs):
    """Images as a function of (prompt, seed) alone: 24x24 uint8."""
    return np.stack([
        np.random.RandomState((zlib.crc32(p.encode()) + 7919 * int(s))
                              % 2 ** 31).randint(0, 256, (24, 24, 3))
        .astype(np.uint8) for p, s in zip(prompts, seeds)])


def write_tree(root):
    """Two edit classes (5 prompts each, one with an alias), two held-out
    classes, and the mend files (two classes, each with a badly scored
    name)."""
    data = root / "data" / "iceb_data"
    data.mkdir(parents=True)
    rows, idx = [], 0
    for cls, cid, dest, did in [("cat", 0, "dog", 1), ("w3", 2, "w4", 3)]:
        for _ in range(5):
            rows.append({"class name": cls,
                         "text prompt": f"an image of a {{}} v{idx}",
                         "random seed": 100 + idx, "idx": idx,
                         "class id": cid, "checked": True, "dest": dest,
                         "dest id": did})
            idx += 1
    (data / "imgnet_aug_edit.json").write_text(json.dumps(rows))
    (data / "imgnet_aug_test.json").write_text(json.dumps(
        [{"class name": c, "text prompt": f"a photo of {c} n{i}",
          "random seed": 55 + i + 3 * k, "idx": i + 3 * k, "class id": cid}
         for k, (c, cid) in enumerate([("w9", 5), ("w8", 6)])
         for i in range(3)]))
    (data / "vit_classifier_config.json").write_text(json.dumps(
        {"id2label": {"0": "cat, kitty", "2": "w3"}}))
    (data / "imgnet_prompts_cls.json").write_text(json.dumps({
        "0": {"cat": {"mean": 0.8, "std": 0.1, "number": 8},
              "kitty": {"mean": 0.05, "std": 0.01, "number": 8}},
        "7": {"w5": {"mean": 0.7, "std": 0.1, "number": 8},
              "w6": {"mean": 0.02, "std": 0.01, "number": 8}}}))
    (data / "imgnet_aug_full.json").write_text(json.dumps(
        [{"class name": c, "text prompt": f"an image of {c} {i}",
          "random seed": 300 + i + 3 * k, "idx": i + 3 * k, "class id": cid}
         for k, (c, cid) in enumerate([("cat", 0), ("w5", 7)])
         for i in range(3)]))
    return root / "data"


@pytest.fixture(scope="module")
def vits():
    tscorer, jscorer, _ = _vit_pair(TINY_1000, seed=11)
    return tscorer, jscorer


@pytest.fixture
def stubbed(monkeypatch):
    for mod in (jiceb, ticeb):
        monkeypatch.setattr(mod, "generate", fake_generate)


def _close(ref, got):
    assert set(got) == set(ref)
    for k, v in ref.items():
        if v is None:
            assert got[k] is None, k
        else:
            assert abs(got[k] - v) <= 1e-5 * max(abs(v), 1e-30), (k, v,
                                                                 got[k])


@pytest.mark.parametrize("is_edited", [False, True], ids=["pre", "post"])
def test_eval_pipe_imgnet_matches_jax(tmp_path, vits, stubbed, is_edited):
    """The 10-field bundle: the same plan, grouping (the source images
    scored again under the dest id), cache and scores as the JAX harness."""
    from emcid_tpu.dsets import RequestDataset as JReq
    from emcid_tpu.dsets import compose_alias_test_requests as jalias

    from emcid_torch.dsets import RequestDataset, compose_alias_test_requests

    data = write_tree(tmp_path)
    tscorer, jscorer = vits
    out = {}
    for name, mod, scorer, req, alias in (
            ("jax", jiceb, jscorer, JReq, jalias),
            ("port", ticeb, tscorer, RequestDataset,
             compose_alias_test_requests)):
        requests = req(data_dir=data, type="edit")[:2]
        val = req(data_dir=data, type="val")[:2]
        out[name] = mod.eval_pipe_imgnet(
            None, scorer, requests, alias(val, data_dir=data), 2,
            is_edited=is_edited, data_dir=data,
            cache_dir=tmp_path / f"cache_{name}", val_requests=val,
            batch_size=4)
    p = "post" if is_edited else "pre"
    assert set(out["port"]) == {f"{p}_{f}" for f in FIELDS}
    _close(out["jax"], out["port"])
    for name in ("jax", "port"):
        pngs = sorted(x.name for x in
                      (tmp_path / f"cache_{name}" / "images" / "imgnet_aug")
                      .glob("*.png")) if not is_edited else []
        out[name + "_pngs"] = pngs
    assert out["port_pngs"] == out["jax_pngs"]
    if not is_edited:
        assert "train_cat_pre_0.png" in out["port_pngs"]
        assert "val_dog_pre_4.png" in out["port_pngs"]
        assert "w8_3.png" in out["port_pngs"]


def test_port_reads_the_jax_png_cache(tmp_path, vits, monkeypatch):
    """Pre-edit images cached by the JAX harness are read by the port's:
    it generates nothing and scores what the JAX harness scored."""
    from emcid_tpu.dsets import RequestDataset as JReq

    from emcid_torch.dsets import RequestDataset

    data = write_tree(tmp_path)
    tscorer, jscorer = vits
    monkeypatch.setattr(jiceb, "generate", fake_generate)
    cache = tmp_path / "cache"
    ref = jiceb.measure_scores(None, jscorer, JReq(data_dir=data)[:2], False,
                               "imgnet_aug", cache_dir=cache)
    jspec = jiceb.measure_specificity(None, jscorer, False, "imgnet_aug",
                                      data_dir=data, cache_dir=cache)

    def no_generate(*args, **kwargs):
        raise AssertionError("the port generated an image it had cached")

    monkeypatch.setattr(ticeb, "generate", no_generate)
    timings = {}
    got = ticeb.measure_scores(None, tscorer, RequestDataset(data_dir=data)[:2],
                               False, "imgnet_aug", cache_dir=cache,
                               timings=timings)
    spec = ticeb.measure_specificity(None, tscorer, False, "imgnet_aug",
                                     data_dir=data, cache_dir=cache,
                                     timings=timings)
    assert rel(ref, got) <= 1e-5 and rel([jspec], [spec]) <= 1e-5
    assert "generated_images" not in timings
    assert timings["scored_images"] == 2 * 3 * 3 + 6


def rel(ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    return float(np.abs(ref - got).max() / np.abs(ref).max())


def test_rectification_bundle_matches_jax(tmp_path, vits, stubbed,
                                          monkeypatch):
    """``emcid_test_imgnet_mend`` with the UCE baseline replaced by the
    identity in both packages: the same mend requests, the same five pre
    and five post fields (<= 1e-5), stored under ``edit{N}`` in the
    baselines folder."""
    import emcid_tpu.engine.uce as juce

    import emcid_torch.engine.uce as tuce

    data = write_tree(tmp_path)
    tscorer, jscorer = vits
    seen = {}
    for name, eng in (("jax", juce), ("port", tuce)):
        monkeypatch.setattr(eng, "edit_model_uce", lambda comps, old, new,
                            __n=name, **kw: seen.setdefault(__n, (old, new))
                            and comps)
    out = {}
    for name, mod, scorer in (("jax", jrect, jscorer),
                              ("port", trect, tscorer)):
        import random

        random.seed(3)
        out[name] = mod.emcid_test_imgnet_mend(
            None, scorer, _tiny_hp(), "hp", num_edit=2, method="uce",
            data_dir=data, cache_dir=tmp_path / f"c_{name}",
            results_dir=tmp_path / f"r_{name}")
    assert seen["port"] == seen["jax"]
    assert sorted(seen["port"][0]) == ["kitty", "w6"]
    ref = {k: v for k, v in out["jax"].items() if k != "edit_time_s"}
    got = {k: v for k, v in out["port"].items() if k != "edit_time_s"}
    assert len(got) == 10
    _close(ref, got)
    spath = tmp_path / "r_port" / "baselines" / "uce" / "imgnet_mend_summary.json"
    assert json.loads(spath.read_text())["edit2"] == out["port"]


# ---------------------------------------------------------------------------
# end to end on the port's tiny pipeline
# ---------------------------------------------------------------------------


def _tiny_hp():
    from emcid_torch.hparams import EMCIDHyperParams

    return EMCIDHyperParams.from_dict({
        "layers": [2, 3], "clamp_norm_factor": 1.5, "layer_selection": "all",
        "fact_token": "subject_last", "v_num_grad_steps": 2, "v_lr": 0.1,
        "v_weight_decay": 5e-4, "mom2_adjustment": True,
        "mom2_update_weight": 100,
        "rewrite_module_tmp": "text_model.encoder.layers.{}.mlp.fc2",
        "layer_module_tmp": "text_model.encoder.layers.{}",
        "mlp_module_tmp": "text_model.encoder.layers.{}.mlp",
        "attn_module_tmp": "text_model.encoder.layers.{}.self_attn",
        "ln_f_module": "text_model.final_layer_norm",
        "mom2_dataset": "ccs_filtered", "mom2_n_samples": 30,
        "mom2_dtype": "float32", "objective": "ablate-dest",
        "esd_mu": "None",
    })


@pytest.fixture(scope="module")
def tiny():
    from emcid_torch.models.loader import build_tiny_pipeline

    return build_tiny_pipeline(seed=0, words=["kitty", "w9", "w8"],
                               device="cpu")


GEN = dict(num_inference_steps=2, height=16, width=16)


def _changed(before, after):
    ref = dict(before.named_parameters())
    return sorted(k for k, v in after.named_parameters()
                  if not torch.equal(v, ref[k]))


def _spy(monkeypatch, module, name, calls):
    real = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append((args, out))
        return out

    monkeypatch.setattr(module, name, wrapper)


def test_aice_end_to_end_tiny(tmp_path, tiny, monkeypatch):
    """The AICE harness on the tiny pipeline: 20 finite fields and the edit
    time, stored under ``edit2_weight100``; a second call returns the stored
    record without generating; the pre-edit cache holds the reference
    names; only the edit layers' fc2 weights changed."""
    import emcid_torch.engine.editor as editor

    data = write_tree(tmp_path)
    scorer = ts.make_vit_scorer(device="cpu")
    calls = []
    _spy(monkeypatch, editor, "apply_emcid", calls)
    kw = dict(num_edit=2, data_dir=data, cache_dir=tmp_path / "cache",
              results_dir=tmp_path / "results", gen_kwargs=GEN,
              batch_size=8, apply_kwargs=dict(
                  num_inference_steps=2, stats_dir=tmp_path / "stats"))
    timings = {}
    record = ticeb.emcid_test_text_encoder_imgnet(
        tiny, scorer, _tiny_hp(), "tiny-hp", timings=timings, **kw)
    for p in ("pre", "post"):
        for f in FIELDS:
            assert np.isfinite(record[f"{p}_{f}"]), (p, f)
    assert record["edit_time_s"] > 0
    assert {"pre_edit_eval", "edit", "post_edit_eval", "generation",
            "scoring"} <= set(timings)
    assert timings["generated_images"] == 43 + 48
    spath = tmp_path / "results" / "emcid" / "tiny-hp" / "imgnet_aug_summary.json"
    assert json.loads(spath.read_text())["edit2_weight100"] == record
    (before, *_), (edited, _) = calls[-1]
    assert _changed(before.text_encoder, edited.text_encoder) == [
        f"text_model.encoder.layers.{i}.mlp.fc2.weight" for i in (2, 3)]
    pngs = {p.name for p in
            (tmp_path / "cache" / "images" / "imgnet_aug").glob("*.png")}
    assert {"train_cat_pre_0.png", "train_dog_pre_2.png", "val_w3_pre_9.png",
            "val_kitty_pre_4.png", "w9_0.png", "w8_5.png"} <= pngs

    monkeypatch.setattr(ticeb, "generate", lambda *a, **k: 1 / 0)
    again = ticeb.emcid_test_text_encoder_imgnet(
        tiny, scorer, _tiny_hp(), "tiny-hp", **kw)
    assert again == record and len(calls) == 1


@pytest.mark.parametrize("method", ["emcid", "uce"])
def test_mend_end_to_end_tiny(tmp_path, tiny, monkeypatch, method):
    """Concept Rectification on the tiny pipeline: five pre and five post
    fields and the edit time under the method's key and folder; a second
    call is served from the summary; EMCID changes only the edit layers'
    fc2 weights, UCE only the cross-attention K/V projections."""
    import emcid_torch.engine.editor as editor
    import emcid_torch.engine.uce as tuce

    data = write_tree(tmp_path)
    scorer = ts.make_vit_scorer(device="cpu")
    calls = []
    engine = (editor, "apply_emcid") if method == "emcid" else \
        (tuce, "edit_model_uce")
    _spy(monkeypatch, *engine, calls)
    kw = dict(num_edit=2, method=method, data_dir=data,
              cache_dir=tmp_path / "cache", results_dir=tmp_path / "results",
              gen_kwargs=GEN, apply_kwargs=dict(
                  num_inference_steps=2, stats_dir=tmp_path / "stats"))
    record = trect.emcid_test_imgnet_mend(tiny, scorer, _tiny_hp(), "hp",
                                          **kw)
    assert len([k for k in record if k.startswith(("pre_", "post_"))]) == 10
    assert all(np.isfinite(v) for v in record.values())
    (before, *_), out = calls[-1]
    if method == "emcid":
        assert _changed(before.text_encoder, out[0].text_encoder) == [
            f"text_model.encoder.layers.{i}.mlp.fc2.weight" for i in (2, 3)]
        spath = tmp_path / "results" / "emcid" / "hp" / "imgnet_mend_summary.json"
        key = "edit2_weight100"
    else:
        kv = sorted(f"{n}.weight" for n in
                    tuce.cross_attn_kv_layer_names(before.unet))
        assert _changed(before.unet, out.unet) == kv
        spath = (tmp_path / "results" / "baselines" / "uce"
                 / "imgnet_mend_summary.json")
        key = "edit2"
    assert json.loads(spath.read_text())[key] == record
    again = trect.emcid_test_imgnet_mend(tiny, scorer, _tiny_hp(), "hp", **kw)
    assert again == record and len(calls) == 1
