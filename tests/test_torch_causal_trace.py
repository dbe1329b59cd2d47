"""PyTorch port, causal tracing (``interp/causal_trace.py`` and the text
encoder's ``embed_noise`` / ``patch_spec`` seams) against the JAX package
on its tiny pipeline (the JAX weights carried over): the cases of
``tests/test_causal_trace.py`` in parity.  Both packages draw the
corruption noise from ``RandomState(1)``; the port's traces take the JAX
package's ``initial_latents`` through ``latents=``.

Tolerances: the embedding std and the text contexts 1e-5 relative to the
largest reference value (``rel_diff``); the traced images within 2/255
per pixel (the same latents through two f32 samplers, rounded to uint8);
the heatmap under a deterministic score (the image mean over 255) within
2/255; the default forward bitwise equal to the stepping API's.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import emcid_tpu.interp.causal_trace as jct
from emcid_tpu.models.loader import build_tiny_pipeline
from emcid_tpu.models.pipeline import initial_latents as jlatents

import emcid_torch.interp.causal_trace as tct
from emcid_torch.evals.folder_sweep import find_trace_images

from torch_parity import port_components, rel_diff, one_torch_thread  # noqa: F401

GEN = dict(num_inference_steps=2, height=16, width=16)
PROMPT, SUBJECT = "a photo of a cat", "cat"


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline(words=["cat", "dog", "photo"])
    return comps, port_components(comps)


def _lat(jc, n, seed):
    return np.asarray(jlatents([seed] * n, GEN["height"], GEN["width"],
                               jc.latent_channels, jc.vae_scale))


def test_layername_codec():
    for layer, kind in ((3, None), (3, "mlp"), (3, "attn"), (0, "embed")):
        assert tct.layername_text_encoder(layer, kind) == \
            jct.layername_text_encoder(layer, kind)
    with pytest.raises(ValueError):
        tct.layername_text_encoder(1, "conv")


def test_collect_embedding_std(pair):
    jc, tc = pair
    ref = jct.collect_embedding_std(jc, ["cat", "dog"])
    got = tct.collect_embedding_std(tc, ["cat", "dog"])
    assert got > 0 and abs(got - ref) <= 1e-5 * ref


@pytest.mark.parametrize("patched", [False, True], ids=["corrupt", "patch"])
def test_corrupted_embeddings_match(pair, patched):
    """Row 0 clean, row 1 corrupted (and, patched, restored at layer 1 on
    the subject token and at the last layer on the first four tokens)."""
    jc, tc = pair
    S = jc.tokenizer.model_max_length
    spec = None
    if patched:
        n = jc.text_encoder.config.num_hidden_layers
        spec = {1: np.eye(S, dtype=np.float32)[5],
                n - 1: (np.arange(S) < 4).astype(np.float32)}
    ref, rtr = jct.corrupted_embeddings(jc, PROMPT, SUBJECT, 0.5,
                                        patch_spec=spec)
    got, tr = tct.corrupted_embeddings(tc, PROMPT, SUBJECT, 0.5,
                                       patch_spec=spec)
    assert tuple(tr) == tuple(rtr)
    assert rel_diff(np.asarray(ref), got) <= 1e-5
    assert not torch.allclose(got[0], got[1])


def test_zero_noise_and_full_patch(pair):
    _, tc = pair
    ctx0, _ = tct.corrupted_embeddings(tc, PROMPT, SUBJECT, 0.0)
    assert torch.equal(ctx0[0], ctx0[1])
    n = tc.text_encoder.config.num_hidden_layers
    S = tc.tokenizer.model_max_length
    full = {l: np.ones(S, np.float32) for l in range(n)}
    ctx, _ = tct.corrupted_embeddings(tc, PROMPT, SUBJECT, 0.5,
                                      patch_spec=full)
    assert torch.equal(ctx[0], ctx[1])


def test_default_forward_bitwise(pair):
    """With both seams left at None, ``forward`` is the stepping API."""
    from emcid_torch.models.clip_text import causal_attention_mask

    _, tc = pair
    te = tc.text_encoder
    ids = torch.as_tensor(tc.tokenizer([PROMPT, "a dog"])["input_ids"],
                          dtype=torch.long)
    with torch.no_grad():
        out = te(ids)
        h = te.embed(ids)
        mask = causal_attention_mask(ids.shape[1])
        for i in range(te.config.num_hidden_layers):
            h = te.layer_forward(h, mask, i)[0]
        ref, pooled = te.final(h, ids)
        seamed = te(ids, embed_noise=None, patch_spec=None)
    assert torch.equal(out.last_hidden_state, ref)
    assert torch.equal(out.pooled_output, pooled)
    assert torch.equal(seamed.last_hidden_state, ref)


def test_trace_with_patch_matches(pair):
    jc, tc = pair
    ref = jct.trace_with_patch_text_encoder(jc, PROMPT, SUBJECT, [(1, 4)],
                                            0.5, seed=3, gen_kwargs=GEN)
    got = tct.trace_with_patch_text_encoder(tc, PROMPT, SUBJECT, [(1, 4)],
                                            0.5, seed=3, gen_kwargs=GEN,
                                            latents=_lat(jc, 2, 3))
    assert got.shape == ref.shape == (2, 16, 16, 3)
    assert np.abs(got.astype(int) - np.asarray(ref).astype(int)).max() <= 2
    assert not np.array_equal(got[0], got[1])


def test_trace_important_states_matches(pair):
    jc, tc = pair
    score = lambda img: float(np.asarray(img, np.float32).mean()) / 255.0
    kw = dict(layers=[0, 1], tokens=[1, 2], score_fn=score, gen_kwargs=GEN)
    ref = jct.trace_important_states(jc, "a cat", "cat", 0.5, **kw)
    calls = []
    got = tct.trace_important_states(
        tc, "a cat", "cat", 0.5, latents=_lat(jc, 3, 0),
        **dict(kw, score_fn=lambda img: calls.append(1) or score(img)))
    assert got.shape == (2, 2) and len(calls) == 4
    assert np.isfinite(got).all()
    assert np.abs(got - ref).max() <= 2 / 255


def test_save_trace_images_codec(pair, tmp_path):
    """The same file names as the JAX package's, read back by the folder
    sweep's codec."""
    jc, tc = pair
    kw = dict(layers=[1], tokens=[2], gen_kwargs=GEN)
    jct_dir = jct.save_trace_images(jc, PROMPT, SUBJECT, 0.5,
                                    tmp_path / "jax", "cat", 7, **kw)
    tct_dir = tct.save_trace_images(tc, PROMPT, SUBJECT, 0.5,
                                    tmp_path / "port", "cat", 7, **kw)
    names = lambda d: sorted(p.name for p in d.glob("*.png"))
    assert names(tct_dir) == names(jct_dir) == [
        "cat_7_x_clean.png", "cat_7_x_corrupt.png",
        "cat_7_x_l1_restore_photo.png"]
    items = find_trace_images(tct_dir)
    restore = [i for i in items if i.is_restore]
    assert len(restore) == 1 and restore[0].restore_layer == 1
    assert restore[0].token_to_restore == "photo"


def test_hidden_flow_bundle(pair):
    jc, tc = pair
    score = lambda img: float(np.asarray(img, np.float32).mean())
    got = tct.calculate_hidden_flow_text_encoder(tc, "a cat", "cat",
                                                 score_fn=score,
                                                 gen_kwargs=GEN, seed=1)
    ref_std = jct.collect_embedding_std(jc, ["cat"])
    assert got["scores"].shape == (len(got["tokens"]),
                                   tc.text_encoder.config.num_hidden_layers)
    assert got["tokens"] == [jc.tokenizer.decode([int(i)]) for i in
                             jc.tokenizer(["a cat"])["input_ids"][0][:4]]
    assert tuple(got["subject_range"]) == (2, 3)
    assert np.isfinite(got["clean_score"]) and np.isfinite(got["scores"]).all()
    assert abs(got["noise_scale"] - 3.0 * ref_std) <= 1e-5 * ref_std
