"""PyTorch port, BLIP ITM (``models/blip.py``, ``evals/blip.py``) against
the JAX package and HF: ``BlipITM`` against the JAX model on the tiny
configs (random HF weights through the JAX package's ``blip_from_torch``,
that tree carried into the port by ``blip_from_jax``), against HF's
``BlipForImageTextRetrieval`` through ``blip_from_torch`` (the JAX test's
fixture, ``tests/test_blip.py``), and ``load_native_blip_scorer`` of both
packages on one written checkpoint folder (HF weights, config and a
``vocab.txt``).

Tolerances, relative to the largest reference value (``rel_diff``): 1e-5
for the logits and the ITM scores (one f32 forward each); 2e-4 relative
plus 2e-5 absolute against HF, the JAX test's own bound.
"""

import os

import numpy as np
import pytest
import torch

os.environ.setdefault("USE_TF", "0")  # transformers without TensorFlow
transformers = pytest.importorskip("transformers")

import jax
import jax.numpy as jnp

from emcid_tpu.models import blip as jb

from emcid_torch.models import blip as tb

from torch_parity import rel_diff, one_torch_thread  # noqa: F401


def _hf_config(vocab_size=100):
    from transformers import BlipConfig, BlipTextConfig, BlipVisionConfig

    return BlipConfig(
        text_config=BlipTextConfig(
            hidden_size=32, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=64, vocab_size=vocab_size,
            encoder_hidden_size=24).to_dict(),
        vision_config=BlipVisionConfig(
            hidden_size=24, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=48, image_size=32, patch_size=16).to_dict(),
    )


@pytest.fixture(scope="module")
def hf_model():
    from transformers import BlipForImageTextRetrieval

    torch.manual_seed(0)
    return BlipForImageTextRetrieval(_hf_config()).eval()


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    px = rng.rand(2, 32, 32, 3).astype(np.float32) * 2 - 1
    ids = rng.randint(1, 100, (2, 7)).astype(np.int64)
    mask = np.ones((2, 7), np.float32)
    mask[1, 5:] = 0.0
    return px, ids, mask


def _port(state):
    model = tb.BlipITM(tb.TINY_BLIP_VISION, tb.TINY_BLIP_TEXT)
    model.load_state_dict(state, strict=True)
    return model.eval()


def test_blip_itm_matches_jax(hf_model):
    """The JAX model on the HF weights (its own ``blip_from_torch``) against
    the port's on the same weights carried over from the JAX tree."""
    jmodel = jb.BlipITM(jb.TINY_BLIP_VISION, jb.TINY_BLIP_TEXT)
    params = jax.tree.map(np.asarray, jb.blip_from_torch(
        hf_model.state_dict(), jb.TINY_BLIP_VISION, jb.TINY_BLIP_TEXT))
    px, ids, mask = _inputs()
    ref = np.asarray(jmodel.apply({"params": params}, jnp.asarray(px),
                                  jnp.asarray(ids, jnp.int32),
                                  jnp.asarray(mask)))
    model = _port(tb.blip_from_jax(params))
    with torch.no_grad():
        got = model(torch.tensor(px), torch.tensor(ids), torch.tensor(mask))
    assert got.shape == (2, 2)
    assert rel_diff(ref, got) <= 1e-5


def test_blip_itm_matches_hf(hf_model):
    model = tb.BlipITM(tb.TINY_BLIP_VISION, tb.TINY_BLIP_TEXT)
    model.load_state_dict(tb.blip_from_torch(hf_model.state_dict(), model),
                          strict=True)
    px, ids, mask = _inputs()
    with torch.no_grad():
        ref = hf_model(
            input_ids=torch.from_numpy(ids),
            pixel_values=torch.from_numpy(px.transpose(0, 3, 1, 2)),
            attention_mask=torch.from_numpy(mask.astype(np.int64)),
        ).itm_score.numpy()
        got = model.eval()(torch.tensor(px), torch.tensor(ids),
                           torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


def test_blip_from_torch_rejects_unknown_keys(hf_model):
    model = tb.BlipITM(tb.TINY_BLIP_VISION, tb.TINY_BLIP_TEXT)
    sd = dict(hf_model.state_dict())
    kept = tb.blip_from_torch(sd, model)
    assert not any(k.startswith(("vision_proj", "text_proj")) for k in kept)
    sd["text_encoder.extra.weight"] = torch.zeros(2)
    with pytest.raises(ValueError, match="unknown"):
        tb.blip_from_torch(sd, model)


def test_load_native_blip_scorer_matches_jax(tmp_path):
    """One checkpoint folder (HF weights, config, a written vocab): the
    JAX package's loader (HF model + ``AutoTokenizer``) and the port's
    (its folder reader + WordPiece) give the same ITM scores."""
    from transformers import BlipForImageTextRetrieval

    from emcid_tpu.evals.blip import load_native_blip_scorer as jload

    from emcid_torch.evals.blip import (
        calculate_single_blip_score,
        load_native_blip_scorer,
    )
    from emcid_torch.text.wordpiece import write_vocab

    write_vocab(tmp_path, ["a", "photo", "depicts", "cat", "dog", "##s"],
                vocab_size=300)
    torch.manual_seed(1)
    BlipForImageTextRetrieval(_hf_config(300)).save_pretrained(tmp_path)
    imgs = (np.random.RandomState(1).rand(2, 48, 48, 3) * 255).astype(
        np.uint8)
    texts = ["cat", "two dogs!"]
    ref = jload(str(tmp_path)).itm_score(imgs, texts)
    scorer = load_native_blip_scorer(tmp_path, device="cpu")
    got = scorer.itm_score(imgs, texts)
    assert got.shape == (2,) and np.all((0 <= got) & (got <= 1))
    assert rel_diff(ref, got) <= 1e-5
    one = calculate_single_blip_score(scorer, imgs[1], texts[1])
    assert abs(one - got[1]) <= 1e-6
