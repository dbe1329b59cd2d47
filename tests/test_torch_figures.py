"""PyTorch port, the figures and the folder sweep against the JAX package:
``evals/plotting.py``'s key parsers (``parse_summary_key``,
``load_summary_records``, ``load_artists_summary``, ``ablation_metrics``)
equal the JAX package's on sample keys and files; every ``workflows
plots`` figure, and each plotter the CLI does not reach, writes its file
(matplotlib is imported only there, so those tests skip without it);
``evals/folder_sweep.py``'s ``ImageItem`` codec, ``find_trace_images``,
the scored sweeps with stand-in scorers and ``cal_heatmap`` equal the JAX
package's.

Tolerance: none — parsed fields, derived metrics, item fields, saved JSON
and heatmaps are equal.
"""

import csv
import json

import numpy as np
import pytest
from PIL import Image

from emcid_tpu.evals import folder_sweep as jfs
from emcid_tpu.evals import plotting as jplot

from emcid_torch.cli import workflows
from emcid_torch.evals import folder_sweep as tfs
from emcid_torch.evals import plotting as tplot

KEYS = ["edit30_weight4000_ew0.6", "edit_30_weight4000", "edit1_weight0.5",
        "edit5_weight100_ew.3", "edit10_weight4000"]


@pytest.mark.parametrize("key", KEYS)
def test_parse_summary_key_matches_jax(key):
    assert tplot.parse_summary_key(key) == jplot.parse_summary_key(key)


@pytest.mark.parametrize("key", ["sd_orig_100", "edit_x_weight", ""])
def test_parse_summary_key_rejects_like_jax(key):
    with pytest.raises(ValueError):
        jplot.parse_summary_key(key)
    with pytest.raises(ValueError):
        tplot.parse_summary_key(key)


def _aice_record(s2d_post=0.5, spec_post=0.8):
    return {
        "pre_source_dest_cls_score_general": 0.1,
        "post_source_dest_cls_score_general": s2d_post,
        "pre_cls_score_specificity": 0.9,
        "post_cls_score_specificity": spec_post,
        "pre_source_dest_cls_score_alias": 0.2,
        "post_source_dest_cls_score_alias": 0.4,
    }


def _artists_summary(scale=1.0):
    out = {}
    for n in (1, 5, 10):
        out[f"edit_{n}_weight4000"] = {
            "edit_lpips": {"mean": 0.1 * n * scale, "std": 0.02},
            "hold_out_lpips": {"mean": 0.02 * n * scale, "std": 0.01},
            "edit_clip": {"mean": 30 - n * scale, "std": 1.0},
            "hold_out_clip": {"mean": 29.5, "std": 1.1},
        }
    out["sd_orig_100"] = {"edit_clip": {"mean": 31.0, "std": 0.9}}
    return out


def test_loaders_and_metrics_match_jax(tmp_path):
    s = tmp_path / "imgnet_aug_summary.json"
    summary = {k: _aice_record(0.1 * i) for i, k in enumerate(KEYS)}
    summary["not a key"] = {"x": 1}
    s.write_text(json.dumps(summary))
    assert tplot.load_summary_records(s) == jplot.load_summary_records(s)
    a = tmp_path / "artists_summary.json"
    a.write_text(json.dumps(_artists_summary()))
    for max_x in (5, 300):
        assert tplot.load_artists_summary(a, max_x=max_x) == \
            jplot.load_artists_summary(a, max_x=max_x)
    for rec in (_aice_record(), {k: v for k, v in _aice_record().items()
                                 if "alias" not in k}):
        assert tplot.ablation_metrics(rec) == jplot.ablation_metrics(rec)


def _plots(argv):
    return workflows.main(["plots", *argv])


FIGURES = ["artists", "coco", "debias_ratios", "edit_weight_ablation",
           "token_ablation", "layer_ablation"]


@pytest.mark.parametrize("figure", FIGURES)
def test_workflows_plots_writes_each_figure(tmp_path, figure):
    pytest.importorskip("matplotlib")
    out = tmp_path / f"{figure}.png"
    if figure == "artists":
        a = tmp_path / "artists_summary.json"
        a.write_text(json.dumps(_artists_summary()))
        argv = ["--summary", f"emcid={a}", "--orig_summary", str(a)]
    elif figure == "coco":
        paths = []
        for name in ("emcid", "uce"):
            p = tmp_path / f"{name}_coco_summary.json"
            p.write_text(json.dumps({
                f"edit_{n}_weight4000": {
                    "lpips": {"mean": 0.05 * n, "std": 0.01},
                    "clip_vit_large": {"mean": 26.0 - 0.1 * n, "std": 1.0},
                    "fid": 14.0 + 0.2 * n} for n in (5, 50)}))
            paths += ["--summary", f"{name}={p}"]
        argv = paths + ["--plot_lpips", "--direction", "horizontal"]
    elif figure == "debias_ratios":
        p = tmp_path / "ratios.csv"
        with open(p, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["", "female", "male", "delta", "delta_std"])
            w.writerow(["doctor", 0.4, 0.6, 0.2, 0.05])
            w.writerow(["nurse", 0.8, 0.2, 0.6, 0.1])
            w.writerow(["total", "", "", 0.4, 0.08])
        argv = ["--csv", str(p)]
    elif figure == "edit_weight_ablation":
        ew = {f"edit10_weight4000_ew{w}": _aice_record(0.3 + w / 2)
              for w in (0.3, 0.7)}
        ew["edit10_weight4000"] = _aice_record()
        s = tmp_path / "imgnet_aug_summary.json"
        s.write_text(json.dumps(ew))
        argv = ["--summary", str(s), "--num_edit", "10"]
    else:
        tags = ([f"tok{t}" for t in (1, 2)] if figure == "token_ablation"
                else ["ly7-9", "ly8-9", "ly7-10"])
        for i, tag in enumerate(tags):
            d = tmp_path / "sweep" / f"hp_{tag}"
            d.mkdir(parents=True)
            (d / "imgnet_aug_summary.json").write_text(json.dumps(
                {"edit10_weight4000": _aice_record(0.3 + 0.1 * i)}))
        argv = ["--glob", str(tmp_path / "sweep" / "*" /
                              "imgnet_aug_summary.json")]
    assert _plots(["--figure", figure, "--out", str(out), *argv]) == out
    assert out.exists() and out.stat().st_size > 0


def test_other_plotters_write(tmp_path):
    pytest.importorskip("matplotlib")
    s = tmp_path / "imgnet_aug_summary.json"
    s.write_text(json.dumps({
        f"edit{n}_weight{w}": {**_aice_record(), "fid": 14.0 + n,
                               "clip_vit_large": 26.0, "lpips": 0.1,
                               "post_source_cls_score_edit": 0.1 * n}
        for n in (1, 5) for w in (100, 4000)}))
    outs = [
        tplot.plot_tradeoff_vs_edit_num(s, tmp_path / "a.png",
                                        mom2_weight=100.0),
        tplot.plot_tradeoff_vs_mom2(s, tmp_path / "b.png", num_edit=5),
        tplot.plot_coco_preservation(s, tmp_path / "c.png"),
        tplot.plot_heatmap(np.arange(6.0).reshape(3, 2), ["a", "b", "c"],
                           tmp_path / "d.png", layers=[7, 8]),
    ]
    assert all(p.exists() for p in map(type(tmp_path), outs))


NAMES = ["cat_3_x_clean.png", "cat_3_x_corrupt.png",
         "cat_3_x_l0_restore_a.png", "cat_3_x_l7_restore_cat.png",
         "cat_3_mlp_s4_w3_restore_photo.png", "dog_1_attn_l2_restore_t4.png",
         "dog_1_attn_s0_w5_restore_dog.png"]


@pytest.fixture
def trace_folder(tmp_path):
    rng = np.random.RandomState(0)
    for i, name in enumerate(NAMES):
        d = tmp_path / ("sub" if i % 2 else "")
        d.mkdir(exist_ok=True)
        Image.fromarray(rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
                        ).save(d / name)
    (tmp_path / "summary").mkdir()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(
        tmp_path / "summary" / "cat_9_x_clean.png")
    return tmp_path


FIELDS = ("image_name", "class_name", "idx", "kind", "is_corrupted",
          "is_clean", "is_restore", "restore_type", "token_to_restore",
          "restore_layer", "restore_window", "start_layer")


def _fields(item):
    return {f: getattr(item, f, None) for f in FIELDS}


def test_folder_sweep_codec_matches_jax(trace_folder):
    ref = jfs.find_trace_images(trace_folder)
    got = tfs.find_trace_images(trace_folder)
    assert [i.image_path for i in got] == [i.image_path for i in ref]
    assert len(got) == len(NAMES)
    for a, b in zip(ref, got):
        assert _fields(b) == _fields(a)
        assert b.to_dict() == a.to_dict()


class _Stand:
    """A stand-in scorer: the mean pixel for ``probs``' class ``c`` is
    ``mean * (c + 1)``; the CLIP score is the mean plus the prompt length."""

    def probs(self, imgs):
        m = float(np.asarray(imgs, np.float64).mean())
        return np.array([[m * (c + 1) for c in range(4)]])

    def clip_score(self, imgs, prompts, prefix=""):
        return np.array([float(np.asarray(imgs, np.float64).mean())
                         + len(prefix + prompts[0])])


def test_scored_sweeps_and_heatmap_match_jax(trace_folder, tmp_path):
    out = {}
    for label, mod in (("jax", jfs), ("port", tfs)):
        cls = mod.extract_all_images_cls(
            trace_folder, _Stand(), lambda it: it.idx % 4,
            file_path=tmp_path / label / "cls.json")
        clip = mod.extract_all_images_clip(
            trace_folder, _Stand(), lambda it: it.class_name,
            file_path=tmp_path / label / "clip.json")
        heat = mod.cal_heatmap(cls, 8, ["a", "cat", "photo", "t4"])
        out[label] = (cls, clip, heat)
        out[label + "_json"] = [(tmp_path / label / f).read_text()
                                for f in ("cls.json", "clip.json")]
    for k in (0, 1):
        assert [i.matching_score for i in out["port"][k]] == \
            [i.matching_score for i in out["jax"][k]]
    np.testing.assert_array_equal(out["port"][2], out["jax"][2])
    assert np.isfinite(out["port"][2]).sum() == 3
    assert out["port_json"] == out["jax_json"]
