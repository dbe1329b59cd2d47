"""PyTorch port, the preservation evals against the JAX package: the FID
InceptionV3 (``models/inception``), LPIPS (``models/lpips``), and the COCO,
artist and I2P harnesses (``evals/{coco_eval,artists_eval,i2p_eval}``)
with ``generate`` replaced in both packages by one numpy function of
(prompt, seed) (initial latents cannot match across frameworks).

Weights come from seeds and cross over through each package's converter.
Tolerances are relative to the largest reference value (``rel_diff``):
InceptionV3's pool3 features at 299 px 1e-5 (5.5e-7 measured on this
test's inputs; the JAX package's own test holds it to rtol 2e-3, atol 2e-4
against torch), at 75 px 1e-5; the 512 -> 299 and 512 -> 64 antialiased
resizes 1e-5; LPIPS 1e-5; a CLIP score's mean and std 1e-5 of its range
(100 for the logit-scaled cosine, 2.5 for the clip score: the means sum
scores of either sign); file names, CSVs and summary keys exactly.  The
299-px Inception parity runs once; the rest runs at 75x75 with
``resize_input=False`` or on 24-px images.
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import emcid_tpu.evals.artists_eval as jart
import emcid_tpu.evals.coco_eval as jcoco
import emcid_tpu.evals.i2p_eval as ji2p
from emcid_tpu.models import inception as jinc
from emcid_tpu.models import lpips as jlp

import emcid_torch.evals.artists_eval as tart
import emcid_torch.evals.coco_eval as tcoco
import emcid_torch.evals.i2p_eval as ti2p
from emcid_torch.models import inception as tinc
from emcid_torch.models import lpips as tlp

from test_torch_iceb import fake_generate
from test_torch_scorers import _clip_pair

from torch_parity import one_torch_thread, rel_diff, write_eval_tree  # noqa: F401

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def inception():
    """The port's InceptionV3 (random weights from seed 0, BatchNorm
    statistics randomised so the test reaches them) and the JAX package's
    params from its state dict through ``inception_from_torch``."""
    model = tinc.load_inception(device="cpu")
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, b in model.named_buffers():
            if name.endswith("running_mean"):
                b.copy_(torch.rand(b.shape, generator=g) * 0.6 - 0.3)
            elif name.endswith("running_var"):
                b.copy_(torch.rand(b.shape, generator=g) + 0.5)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return model, jinc.inception_from_torch(sd), sd


def _jax_features(params, x, resize):
    m = jinc.InceptionV3Features(fid=True, resize_input=resize)
    return np.asarray(jax.jit(lambda p, x: m.apply({"params": p}, x))(
        params, jnp.asarray(x)))


def test_inception_299_matches_jax(inception):
    """Two 299-px images through the full trunk (no resize): the 2048-d
    pool3 features at 1e-5."""
    model, params, _ = inception
    x = np.random.RandomState(0).rand(2, 299, 299, 3).astype(np.float32)
    ref = _jax_features(params, x, resize=False)
    got = tinc.fid_features(model, x, batch_size=2)
    assert got.shape == (2, tinc.FID_DIMS) and got.dtype == np.float32
    assert rel_diff(ref, got) <= 1e-5


def test_inception_batches_and_padding(inception, monkeypatch):
    """Five 75-px uint8 images in batches of 2 (the last one short): the
    same rows as one batch of 5 (1e-6), and as the JAX package's padded
    batches (1e-5): padding leaks into no kept row."""
    model, params, _ = inception
    monkeypatch.setattr(model, "resize_input", False)
    imgs = (np.random.RandomState(2).rand(5, 75, 75, 3) * 255).astype(
        np.uint8)
    got = tinc.fid_features(model, imgs, batch_size=2)
    whole = tinc.fid_features(model, imgs, batch_size=5)
    assert got.shape == (5, 2048)
    assert rel_diff(whole, got) <= 1e-6
    ref = jinc.fid_features(jinc.InceptionV3Features(resize_input=False),
                            params, imgs, batch_size=2)
    assert rel_diff(ref, got) <= 1e-5


@pytest.mark.parametrize("size", [299, 64])
def test_resize_from_512_matches_jax(size):
    """The antialiased bilinear shrink of 512-px images
    (``jax.image.resize(..., "bilinear")``) at 1e-5."""
    x = np.random.RandomState(3).rand(2, 512, 512, 3).astype(np.float32)
    ref = jax.image.resize(jnp.asarray(x), (2, size, size, 3), "bilinear")
    got = tinc.resize_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), size)
    assert rel_diff(ref, got.permute(0, 2, 3, 1)) <= 1e-5


def test_inception_weight_files(inception, tmp_path):
    """``inception_from_torch`` drops the classifier (``fc.*``,
    ``AuxLogits.*``) and ``num_batches_tracked`` and raises on any other
    unknown key; ``load_inception`` reads a torch file with those keys and
    an npz of the JAX package's leaves (``/``-joined), each to the same
    weights; ``inception_from_jax`` inverts the JAX converter."""
    model, params, sd = inception
    extra = {"fc.weight": np.zeros((10, 2048), np.float32),
             "AuxLogits.fc.bias": np.zeros(10, np.float32),
             "Mixed_5b.branch1x1.bn.num_batches_tracked": np.array(3)}
    conv = tinc.inception_from_torch({**sd, **extra})
    assert set(conv) == set(sd)
    with pytest.raises(ValueError, match="unexpected inception key"):
        tinc.inception_from_torch({**sd, "Mixed_5b.branch1x1.foo": 1.0})
    back = tinc.inception_from_jax(jax.tree.map(np.asarray, params))
    assert set(back) == set(sd)
    for k in sd:
        np.testing.assert_array_equal(back[k].numpy(), sd[k])
    torch.save({k: torch.from_numpy(np.asarray(v))
                for k, v in {**sd, **extra}.items()}, tmp_path / "w.pth")
    from flax.traverse_util import flatten_dict

    np.savez(tmp_path / "w.npz", **{"/".join(k): np.asarray(v) for k, v in
                                    flatten_dict(params).items()})
    for path in ("w.pth", "w.npz"):
        loaded = tinc.load_inception(tmp_path / path, device="cpu")
        for k, v in loaded.state_dict().items():
            np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=path)


def test_make_fid_extractor(inception, monkeypatch):
    """``make_fid_extractor`` loads the model once and returns
    ``fid_features`` of it in batches of ``batch_size`` (the FID of a
    folder with itself is checked on the card, ``chip_smoke.py``; its
    2048-d matrix square roots take half a minute here)."""
    model = inception[0]
    monkeypatch.setattr(model, "resize_input", False)
    loads = []
    monkeypatch.setattr(tinc, "load_inception",
                        lambda *a, **k: loads.append((a, k)) or model)
    extractor = tinc.make_fid_extractor("w.pth", batch_size=2, device="cpu")
    imgs = (np.random.RandomState(4).rand(3, 75, 75, 3) * 255).astype(
        np.uint8)
    got = extractor(imgs)
    assert loads == [(("w.pth",), dict(device="cpu"))]
    assert got.shape == (3, 2048)
    assert rel_diff(tinc.fid_features(model, imgs, 3), got) <= 1e-6


@pytest.fixture(scope="module")
def lpips_pair():
    """The JAX package's LPIPS scorer (random params, seed 0) and the
    port's on the same weights through ``lpips_from_jax``."""
    j = jlp.LPIPSScorer(seed=0)
    t = tlp.LPIPSScorer(state_dict=tlp.lpips_from_jax(
        jax.tree.map(np.asarray, j.params)), device="cpu")
    return j, t


def test_lpips_matches_jax(lpips_pair):
    """Distances of 512-px uint8 pairs (the resize to 64 included) and of
    64-px float pairs at 1e-5; a pair with itself is 0."""
    j, t = lpips_pair
    rng = np.random.RandomState(5)
    a = (rng.rand(3, 512, 512, 3) * 255).astype(np.uint8)
    b = (rng.rand(3, 512, 512, 3) * 255).astype(np.uint8)
    got = t.distance(a, b)
    assert got.shape == (3,)
    assert rel_diff(j.distance(a, b), got) <= 1e-5
    c, d = rng.rand(2, 64, 64, 3), rng.rand(2, 64, 64, 3)
    assert rel_diff(j.distance(c, d), t.distance(c, d)) <= 1e-5
    assert np.abs(t.distance(a[:1], a[:1])).max() == 0.0


@pytest.mark.parametrize("naming", ["slice", "features"])
def test_lpips_from_torch_renamed_checkpoint(lpips_pair, naming):
    """The ``lpips`` package's names (``net.slice{i}.{idx}`` and
    ``lin{i}.model.1``, or ``net.features.{idx}`` and ``lins.{i}.model.1``)
    map to the port's state dict and to the JAX package's tree alike."""
    j, t = lpips_pair
    sd = t.model.state_dict()
    ren = {}
    for i, idx in enumerate([0, 3, 6, 8, 10]):
        conv = (f"net.slice{i + 1}.{idx}" if naming == "slice"
                else f"net.features.{idx}")
        lin = f"lin{i}" if naming == "slice" else f"lins.{i}"
        ren[f"{conv}.weight"] = sd[f"net.conv{i}.weight"]
        ren[f"{conv}.bias"] = sd[f"net.conv{i}.bias"]
        ren[f"{lin}.model.1.weight"] = sd[f"lin{i}.weight"]
    got = tlp.lpips_from_torch(ren)
    assert set(got) == set(sd)
    for k in sd:
        assert torch.equal(got[k], sd[k]), k
    jtree = jlp.lpips_from_torch(ren)
    for path, leaf in jax.tree_util.tree_leaves_with_path(j.params):
        ref = jtree
        for key in path:
            ref = ref[key.key]
        np.testing.assert_array_equal(np.asarray(ref), np.asarray(leaf))


@pytest.mark.parametrize("args,key", [
    ((2, 4000), "edit_2_weight4000"), ((2, 4000, 0.5), "edit_2_weight4000"),
    ((10, 100.0, 0.3), "edit_10_weight100.0_ew0.3"),
    ((1, 4000, None), "edit_1_weight4000")])
def test_coco_summary_key_matches_jax(args, key):
    assert tcoco.coco_summary_key(*args) == jcoco.coco_summary_key(*args) \
        == key


def _scale(key, ref):
    """What a record field's 1e-5 is relative to: a CLIP field's range
    (logit scale 100 or the clip score's 2.5; its means are differences
    of scores near 0), else the reference value."""
    if "clip_vit_large" in key:
        return 100.0
    if key.startswith("clip"):
        return 2.5
    return max(abs(ref), 1e-30)


def _stub(monkeypatch, calls, *modules):
    def gen(components, prompts, seeds, **kwargs):
        calls.append((list(prompts), list(seeds),
                      kwargs.get("guidance_scale")))
        return fake_generate(components, prompts, seeds)

    for m in modules:
        monkeypatch.setattr(m, "generate", gen)


def _files(folder):
    return {p.name: p.read_bytes() for p in sorted(Path(folder).rglob("*"))
            if p.is_file()}


def test_coco_flow_matches_jax(tmp_path, monkeypatch, lpips_pair):
    """``generate_coco`` (seeded names, the existing files skipped),
    ``cal_lpips_coco`` and ``cal_clip_score_coco`` on pre/post folders, and
    ``write_coco_summary``: the same files, records at 1e-5 and the same
    summary key in both packages."""
    from emcid_tpu.dsets import load_coco_30k as jload

    from emcid_torch.dsets import load_coco_30k

    data = write_eval_tree(tmp_path / "data")
    rows = load_coco_30k(data_dir=data)
    assert rows == jload(data_dir=data)
    calls = []
    _stub(monkeypatch, calls, jcoco, tcoco)
    tclip, jclip = _clip_pair()
    jlpips, tlpips = lpips_pair
    out = {}
    for side, mod, lp, clip in (("jax", jcoco, jlpips, jclip),
                                ("torch", tcoco, tlpips, tclip)):
        root = tmp_path / side
        mod.generate_coco(None, rows, root / "pre", gen_kwargs={},
                          batch_size=2)
        # post-edit images: other seeds (the stub knows no model)
        mod.generate_coco(None, [dict(r, evaluation_seed=r[
            "evaluation_seed"] + 1) for r in rows], root / "post",
                          batch_size=2)
        mod.generate_coco(None, rows, root / "pre", batch_size=2)  # skips
        rec = {**mod.cal_lpips_coco(lp, rows, root / "post", root / "pre"),
               **mod.cal_clip_score_coco(clip, rows, root / "post")}
        summary, key = mod.write_coco_summary("hp", 2, 4000, rec,
                                              results_dir=root / "results")
        out[side] = (rec, summary, key, _files(root / "pre"),
                     _files(root / "post"))
    assert len(calls) == 8  # 2 batches per folder and package, no re-render
    (jrec, jsum, jkey, jpre, jpost), (trec, tsum, tkey, tpre, tpost) = \
        out["jax"], out["torch"]
    assert jpre == tpre and jpost == tpost
    assert sorted(tpre) == ["0.png", "1.png", "2.png"]
    assert jkey == tkey == "edit_2_weight4000" and set(jsum) == set(tsum)
    assert set(jrec) == set(trec) == {"lpips", "lpips_std", "n",
                                      "clip_vit_large", "clip_vit_large_std"}
    for k in jrec:
        assert abs(jrec[k] - trec[k]) <= 1e-5 * _scale(k, jrec[k]), k
    path = tmp_path / "torch" / "results" / "emcid" / "hp" / \
        "coco_summary.json"
    assert json.loads(path.read_text())[tkey] == trec


def test_artists_flow_matches_jax(tmp_path, monkeypatch, lpips_pair):
    """``generate_artist_images`` and ``eval_artists`` (LPIPS(pre, post),
    CLIP(post, prompt), erased and held-out buckets): the same files, the
    same keys, values at 1e-5."""
    from emcid_tpu.dsets import load_artist_eval_prompts as jload

    from emcid_torch.dsets import load_artist_eval_prompts

    data = write_eval_tree(tmp_path / "data")
    rows = load_artist_eval_prompts(2, data_dir=data)
    assert rows == jload(2, data_dir=data)
    _stub(monkeypatch, [], jart, tart)
    tclip, jclip = _clip_pair()
    jlpips, tlpips = lpips_pair
    res, files = {}, {}
    for side, mod, lp, clip in (("jax", jart, jlpips, jclip),
                                ("torch", tart, tlpips, tclip)):
        root = tmp_path / side
        mod.generate_artist_images(None, rows, root / "pre")
        mod.generate_artist_images(None, [dict(r, prompt=r["prompt"] + " w1")
                                          for r in rows], root / "post")
        res[side] = mod.eval_artists(rows, root / "pre", root / "post",
                                     lpips=lp, clip=clip,
                                     out_json=root / "artists.json")
        files[side] = (_files(root / "pre"), _files(root / "post"))
    assert files["jax"] == files["torch"]
    assert sorted(files["torch"][0]) == [
        "0_100.png", "1_101.png", "2_102.png", "3_103.png"]
    j, t = res["jax"], res["torch"]
    assert json.loads((tmp_path / "torch" / "artists.json").read_text()) == t
    assert set(j) == set(t) == {"erased", "holdout"}
    for kind in j:
        assert set(j[kind]) == set(t[kind]) and j[kind]["n"] == t[kind]["n"]
        for k, v in j[kind].items():
            assert abs(v - t[kind][k]) <= 1e-5 * _scale(k, v), (kind, k)


def test_i2p_flow_matches_jax(tmp_path, monkeypatch):
    """``generate_i2p_imgs`` (one call per guidance scale), the detector
    subprocess (``scripts/fake_nudenet.py``, which imports neither package)
    and ``i2p_nudity_summary``: the same calls, detections and summary
    bytes in both packages; an existing CSV loads without a detector, a
    missing one raises, and so does one without ``NudeNet_label``."""
    from emcid_torch.dsets.global_concepts import load_i2p_prompts

    data = write_eval_tree(tmp_path / "data")
    rows = load_i2p_prompts(data_dir=data)
    cmd = f"{sys.executable} {REPO / 'scripts' / 'fake_nudenet.py'}"
    out = {}
    for side, mod in (("jax", ji2p), ("torch", ti2p)):
        calls = []
        _stub(monkeypatch, calls, mod)
        root = tmp_path / side
        mod.generate_i2p_imgs(None, rows, root / "imgs",
                              gen_kwargs={"num_inference_steps": 2})
        dets = mod.detect_nude_classes(root / "imgs", root / "dets.csv",
                                       detector_cmd=cmd)
        cnt = mod.i2p_nudity_summary(dets, out_json=root / "cnt.json")
        out[side] = (calls, dets, cnt, (root / "cnt.json").read_bytes(),
                     _files(root / "imgs"))
    assert out["jax"] == out["torch"]
    calls, dets, cnt, _, imgs = out["torch"]
    assert [c[2] for c in calls] == [7.0, 9.0] and len(imgs) == 4
    assert len(dets) == 4 and cnt["total_images"] == 4
    assert set(json.loads((tmp_path / "torch" / "cnt.json").read_text())) \
        == {*ti2p.NUDENET_EXPOSED_LABELS, "total"}
    again = ti2p.detect_nude_classes(tmp_path / "torch" / "imgs",
                                     tmp_path / "torch" / "dets.csv")
    assert again == dets
    with pytest.raises(FileNotFoundError):
        ti2p.detect_nude_classes(tmp_path, tmp_path / "none.csv")
    (tmp_path / "other.csv").write_text("image,labels\n0.png,FEET_EXPOSED\n")
    with pytest.raises(ValueError, match="NudeNet_label"):
        ti2p.detect_nude_classes(tmp_path, tmp_path / "other.csv")
