"""PyTorch port, the evaluation scorers against the JAX package: the ViT
classifier (one HF state dict loads into both), the full CLIP scorer,
``ViTScorer.probs`` with the 512 -> 224 resize, the grouped class scores,
the FID and nudity math and the summary codec both ways.

Weights and images come from numpy seeds.  Tolerances are relative to the
largest reference value (``rel_diff``): 1e-5 through one f32 forward (the
two differ only in the order of their sums); the numpy parts are held
exactly.
"""

import dataclasses
import json

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from emcid_tpu.evals import scorers as js
from emcid_tpu.evals import summary as jsum
from emcid_tpu.models import vision as jv

from emcid_torch.evals import scorers as ts
from emcid_torch.evals import summary as tsum
from emcid_torch.models import vision as tv

from torch_parity import rel_diff, one_torch_thread  # noqa: F401

TINY_1000 = dataclasses.replace(tv.TINY_VIT, num_labels=1000)


def _seeded_state(model, seed):
    """A numpy state dict for ``model``: unit-centred norm scales, the
    rest normal(0, 0.2) (what both packages load)."""
    rng = np.random.RandomState(seed)
    sd = {}
    for k, v in model.state_dict().items():
        base = 1.0 if "norm" in k and k.endswith("weight") else 0.0
        sd[k] = (base + 0.2 * rng.randn(*v.shape)).astype(np.float32)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    return sd


def _vit_pair(config, seed=0):
    """The port's ViT (f32, CPU) and the JAX scorer on the same weights."""
    model = tv.ViTClassifier(config).eval()
    sd = _seeded_state(model, seed)
    jcfg = jv.ViTConfig(**dataclasses.asdict(config))
    jscorer = js.make_vit_scorer(jcfg, torch_state_dict=sd)
    return ts.ViTScorer(model.requires_grad_(False)), jscorer, sd


@pytest.mark.parametrize("config", [
    tv.TINY_VIT, dataclasses.replace(tv.VIT_BASE_224, num_hidden_layers=1)],
    ids=["tiny", "base224_1layer"])
def test_vit_logits_match_jax(config):
    """Logits of the port's ViT and of the JAX ViT on the port's state dict
    (through ``vit_from_torch``), f32: max rel <= 1e-5."""
    tscorer, jscorer, sd = _vit_pair(config)
    x = np.random.RandomState(1).randn(
        2, config.image_size, config.image_size, 3).astype(np.float32)
    ref = jscorer.model.apply({"params": jscorer.params}, jnp.asarray(x))
    with torch.no_grad():
        got = tscorer.model(torch.from_numpy(x))
    assert got.shape == (2, config.num_labels)
    assert rel_diff(ref, got) <= 1e-5


def test_vit_scorer_probs_512_to_224():
    """``ViTScorer.probs`` on 512 px uint8 images: the resize to 224 and
    the ViT's mean/std, then the softmax, as in the JAX package (<= 1e-5)."""
    config = dataclasses.replace(tv.VIT_BASE_224, num_hidden_layers=1)
    tscorer, jscorer, _ = _vit_pair(config, seed=2)
    imgs = np.random.RandomState(3).randint(0, 256, (2, 512, 512, 3)
                                            ).astype(np.uint8)
    jx = jv.preprocess_for_model(imgs, 224, jv.VIT_IMAGE_MEAN,
                                 jv.VIT_IMAGE_STD)
    tx = tv.preprocess_for_model(imgs, 224, tv.VIT_IMAGE_MEAN,
                                 tv.VIT_IMAGE_STD)
    assert rel_diff(jx, tx) <= 1e-5
    ref = jscorer.probs(imgs)
    got = tscorer.probs(imgs)
    assert got.shape == (2, 1000)
    np.testing.assert_allclose(got.sum(-1), 1.0, atol=1e-5)
    assert rel_diff(ref, got) <= 1e-5


def test_make_vit_scorer_default_and_state_dict(tmp_path):
    """No weights: a tiny tower with a 1000-label head, as in the JAX
    package; an HF state dict saved with ``torch.save`` loads into the
    ViT-B/16 layout."""
    scorer = ts.make_vit_scorer(device="cpu")
    assert scorer.model.config == TINY_1000
    imgs = np.random.RandomState(4).randint(0, 256, (3, 40, 40, 3)
                                            ).astype(np.uint8)
    assert scorer.probs(imgs).shape == (3, 1000)
    sd = scorer.model.state_dict()
    again = ts.make_vit_scorer(TINY_1000, torch_state_dict=sd, device="cpu")
    np.testing.assert_array_equal(again.probs(imgs), scorer.probs(imgs))


def test_cls_scores_batched_grouping_matches_jax():
    """Grouped class scores: contiguous groups reduced against their own
    class id, equal to per-group single scores and to the JAX package's
    (<= 1e-5)."""
    tscorer, jscorer, _ = _vit_pair(TINY_1000, seed=5)
    imgs = np.random.RandomState(6).randint(0, 256, (7, 32, 32, 3)
                                            ).astype(np.uint8)
    ids, sizes = [3, 999, 3], [2, 4, 1]
    got = ts.cls_scores_batched(tscorer, imgs, ids, sizes)
    ref = js.cls_scores_batched(jscorer, imgs, ids, sizes)
    assert rel_diff(ref, got) <= 1e-5
    manual = [ts.calculate_single_cls_score(tscorer, imgs[a:a + n], c)
              for c, a, n in zip(ids, (0, 2, 6), sizes)]
    np.testing.assert_allclose(got, manual, rtol=1e-6)
    m, sd = ts.calculate_single_cls_score(tscorer, imgs, 3, return_std=True)
    jm, jsd = js.calculate_single_cls_score(jscorer, imgs, 3,
                                            return_std=True)
    assert abs(m - jm) <= 1e-5 * max(abs(jm), 1e-30) and sd >= 0


def _clip_pair(seed=7):
    """The port's and the JAX package's full CLIP scorer on the same tiny
    towers (vision: TINY_CLIP_VISION; text: two width-32 layers with a
    16-wide projection) and the same tiny tokenizer."""
    from emcid_tpu.models.clip_text import CLIPTextEncoder as JText
    from emcid_tpu.models.configs import CLIPTextConfig as JCfg
    from emcid_tpu.models.convert_hf import clip_text_from_torch
    from emcid_tpu.text.tokenizer import make_tiny_tokenizer

    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.configs import CLIPTextConfig

    from torch_parity import TINY_WORDS, port_tokenizer

    jtok = make_tiny_tokenizer(TINY_WORDS + ["photo", "of", "a"],
                               model_max_length=32)
    tcfg = CLIPTextConfig(
        vocab_size=jtok.vocab_size, hidden_size=32, intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4,
        max_position_embeddings=32, eos_token_id=jtok.eos_token_id,
        projection_dim=16)
    text = CLIPTextEncoder(tcfg).eval()
    vision = tv.CLIPVisionEncoder(tv.TINY_CLIP_VISION).eval()
    tsd = _seeded_state(text, seed)
    vsd = _seeded_state(vision, seed + 1)
    tscorer = tv.CLIPScorer(text.requires_grad_(False),
                            vision.requires_grad_(False),
                            port_tokenizer(jtok))
    jtext = JText(JCfg(**dataclasses.asdict(tcfg)))
    jvision = jv.CLIPVisionEncoder(jv.TINY_CLIP_VISION)
    jscorer = jv.CLIPScorer(jtext, clip_text_from_torch(tsd), jvision,
                            jv.clip_vision_from_torch(vsd), jtok)
    return tscorer, jscorer


def test_clip_scorer_matches_jax():
    """Image and text embeddings, logits per image and ``clip_score`` of
    the full CLIP scorer: <= 1e-5 against the JAX package's (its towers
    run jitted here; the scorer's own formulas: logit_scale * cosine, and
    2.5 * cosine with the "A photo depicts " prefix)."""
    import jax

    tscorer, jscorer = _clip_pair()
    imgs = np.random.RandomState(8).randint(0, 256, (3, 48, 48, 3)
                                            ).astype(np.uint8)
    texts = ["a photo of a cat", "dog", "w1 w2 cat"]
    vision = jax.jit(lambda p, x: jscorer.vision_model.apply({"params": p},
                                                             x))
    text = jax.jit(lambda p, ids: jscorer.text_model.apply(
        {"params": p}, ids).pooled_output)
    unit = lambda e: np.asarray(e) / np.linalg.norm(np.asarray(e), axis=-1,
                                                    keepdims=True)
    jimg = unit(vision(jscorer.vision_params, jv.preprocess_for_model(
        imgs, 32, jv.CLIP_IMAGE_MEAN, jv.CLIP_IMAGE_STD)))

    def jtxt(ts):
        return unit(text(jscorer.text_params, jnp.asarray(
            jscorer.tokenizer(list(ts))["input_ids"])))

    assert rel_diff(jimg, tscorer.image_embeds(imgs)) <= 1e-5
    assert rel_diff(jtxt(texts), tscorer.text_embeds(texts)) <= 1e-5
    assert rel_diff(jscorer.logit_scale * jimg @ jtxt(texts).T,
                    tscorer.logits_per_image(imgs, texts)) <= 1e-5
    got = tscorer.clip_score(imgs, texts)
    assert got.shape == (3,)
    ref = 2.5 * (jimg * jtxt(["A photo depicts " + t for t in texts])
                 ).sum(-1)
    assert rel_diff(ref, got) <= 1e-5


def test_frechet_distance_and_fid_exact(rng):
    """The numpy FID math is the JAX package's, bit for bit."""
    f1, f2 = rng.randn(300, 6), rng.randn(300, 6) * 1.5 + 1.0
    assert ts.fid_from_features(f1, f2) == js.fid_from_features(f1, f2)
    mu, sig = np.zeros(4), np.eye(4)
    assert ts.frechet_distance(mu, sig, np.ones(4) * 2, sig) == \
        js.frechet_distance(mu, sig, np.ones(4) * 2, sig)
    for a, b in zip(ts.activation_statistics(f1),
                    js.activation_statistics(f1)):
        np.testing.assert_array_equal(a, b)


def test_fid_between_folders_matches_jax(tmp_path):
    """Folder FID with its activation cache: the same images and the same
    extractor give the JAX package's number; the cache file reloads."""
    from PIL import Image

    rng = np.random.RandomState(9)
    for folder in ("a", "b"):
        (tmp_path / "t" / folder).mkdir(parents=True)
        (tmp_path / "j" / folder).mkdir(parents=True)
        for i in range(6):
            img = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
            for root in ("t", "j"):
                Image.fromarray(img).save(tmp_path / root / folder / f"{i}.png")
    extractor = lambda x: np.asarray(x, np.float64).reshape(len(x), -1)[:, :5]
    got = ts.fid_between_folders(tmp_path / "t" / "a", tmp_path / "t" / "b",
                                 extractor, batch_size=4)
    ref = js.fid_between_folders(tmp_path / "j" / "a", tmp_path / "j" / "b",
                                 extractor, batch_size=4)
    assert got == ref
    assert (tmp_path / "t" / "a_fid_acts.npz").exists()
    assert ts.fid_between_folders(tmp_path / "t" / "a", tmp_path / "t" / "b",
                                  None) == got


@pytest.mark.parametrize("dets", [
    [["BELLY_EXPOSED", "FACE_FEMALE"], [],
     ["FEMALE_BREAST_EXPOSED", "BELLY_EXPOSED"]],
    [["ANUS_EXPOSED", "ANUS_EXPOSED"]],
    [["FEMALE_GENITALIA_EXPOSED"], ["BUTTOCKS_COVERED", "FEET_EXPOSED"]],
], ids=["mixed", "duplicate", "quirks"])
def test_nudity_rate_exact(dets):
    assert ts.cal_nudity_rate(dets) == js.cal_nudity_rate(dets)
    assert ts.NUDENET_EXPOSED_LABELS == js.NUDENET_EXPOSED_LABELS


@pytest.mark.parametrize("args", [(30, 4000), (30, 4000, 0.5),
                                  (30, 4000, 0.6), (1, 4000, 0.5, "edit_")])
def test_summary_key_codec_matches_jax(args):
    assert tsum.summary_key(*args) == jsum.summary_key(*args)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_summary_written_by_one_reads_in_the_other(tmp_path, writer):
    """A summary written and merged by one package reads, key for key, in
    the other; the path layout is the same."""
    w, r = (jsum, tsum) if writer == "jax" else (tsum, jsum)
    assert (w.summary_path("hp", "imgnet_aug", tmp_path)
            == r.summary_path("hp", "imgnet_aug", tmp_path))
    p = w.summary_path("hp", "imgnet_aug", tmp_path)
    w.update_summary(p, "edit5_weight4000", {"pre_a": 1.0})
    w.update_summary(p, "edit5_weight4000", {"post_a": 2.5})
    assert r.lookup_summary(p, "edit5_weight4000") == {"pre_a": 1.0,
                                                       "post_a": 2.5}
    assert r.lookup_summary(p, "edit7_weight4000") is None
    r.update_summary(p, "edit7_weight4000", {"pre_a": 3.0})
    assert w.read_summary(p) == json.loads(p.read_text())
    assert set(w.read_summary(p)) == {"edit5_weight4000", "edit7_weight4000"}
