"""PyTorch port, checkpoint validation and profiling against the JAX
package: ``cli/validate.py``'s goldens both ways (the JAX package's
goldens validate the port's copy of its tiny pipeline, and the port's
goldens validate the JAX pipeline), wrong weights and scheduler drift
caught as ``tests/test_validate.py`` does, ``workflows validate`` on the
CPU; ``models/convert_openclip.py`` against the JAX converter on a
templated open_clip state dict (``tests/test_openclip_convert.py``),
``validate_openclip``'s mechanics and its default device (the card);
``profiling.StepReport``'s arithmetic and its H100 peak.

Tolerances: goldens across the two packages 1e-4 relative plus 1e-4
absolute (the f32 CLI bound; the PNDM trajectory 1e-4 too), the port's own
self-goldens 1e-5; the converted towers' outputs 1e-5 relative to the
largest reference value (``rel_diff``); the FLOP counts exact.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from emcid_tpu.cli import validate as jval
from emcid_tpu.models.clip_text import CLIPTextEncoder as JText
from emcid_tpu.models.configs import CLIPTextConfig as JTextConfig
from emcid_tpu.models.convert_openclip import (
    openclip_text_from_torch as j_oc_text,
    openclip_vision_from_torch as j_oc_vision,
)
from emcid_tpu.models.loader import build_tiny_pipeline
from emcid_tpu.models.vision import CLIPVisionEncoder as JVision
from emcid_tpu.models.vision import TINY_CLIP_VISION as J_TINY_VISION

from emcid_torch import profiling as tprof
from emcid_torch.cli import validate as tval
from emcid_torch.models.clip_text import CLIPTextEncoder
from emcid_torch.models.configs import CLIPTextConfig
from emcid_torch.models.convert_openclip import (
    openclip_text_from_torch,
    openclip_vision_from_torch,
)
from emcid_torch.models.loader import build_tiny_pipeline as tiny_port
from emcid_torch.models.scheduler import Schedule
from emcid_torch.models.vision import CLIPVisionEncoder, TINY_CLIP_VISION

from test_openclip_convert import _synthetic_openclip_text

from torch_parity import port_components, rel_diff, one_torch_thread  # noqa: F401

CHECKS = {"text_hidden", "text_pooled", "unet_eps", "vae_decode",
          "vae_enc_mean", "vae_enc_logvar", "pndm_traj"}


@pytest.fixture(scope="module")
def pair():
    comps = build_tiny_pipeline()
    return comps, port_components(comps)


@pytest.mark.parametrize("direction", ["jax_goldens", "port_goldens"])
def test_goldens_cross_validate(pair, tmp_path, direction):
    jc, tc = pair
    p = tmp_path / "goldens.npz"
    if direction == "jax_goldens":
        jval.make_self_goldens(jc, p, num_pndm_steps=4)
        errs = tval.validate_against_goldens(tc, p, rtol=1e-4, atol=1e-4,
                                             verbose=False)
    else:
        tval.make_self_goldens(tc, p, num_pndm_steps=4)
        errs = jval.validate_against_goldens(jc, p, rtol=1e-4, atol=1e-4,
                                             verbose=False)
    assert set(errs) == CHECKS


def test_goldens_schema_matches_jax(pair, tmp_path):
    """The same keys, shapes and inputs in both packages' npz."""
    jc, tc = pair
    ref = jval.make_self_goldens(jc, None, num_pndm_steps=4)
    got = tval.make_self_goldens(tc, None, num_pndm_steps=4)
    assert set(got) == set(ref)
    for k, v in ref.items():
        assert np.asarray(got[k]).shape == np.asarray(v).shape, k
    for k in ("input_ids", "latents", "timesteps", "context", "vae_latents",
              "image"):
        np.testing.assert_array_equal(got[k], ref[k])
    assert rel_diff(ref["pndm_traj"], got["pndm_traj"]) <= 1e-5


def test_self_goldens_roundtrip(pair, tmp_path):
    _, tc = pair
    p = tmp_path / "goldens.npz"
    tval.make_self_goldens(tc, p, num_pndm_steps=4)
    errs = tval.validate_against_goldens(tc, p, rtol=1e-5, atol=1e-5,
                                         verbose=False)
    assert set(errs) == CHECKS and max(errs.values()) == 0.0


def test_validation_catches_wrong_weights(pair, tmp_path):
    _, tc = pair
    p = tmp_path / "goldens.npz"
    tval.make_self_goldens(tc, p, num_pndm_steps=4)
    other = tiny_port(seed=1, device="cpu")
    with pytest.raises(AssertionError):
        tval.validate_against_goldens(other, p, rtol=1e-5, atol=1e-5,
                                      verbose=False)


def test_validation_catches_scheduler_drift(pair, tmp_path):
    _, tc = pair
    p = tmp_path / "goldens.npz"
    tval.make_self_goldens(tc, p, num_pndm_steps=4)
    wrong = dataclasses.replace(
        tc, schedule=Schedule.scaled_linear(beta_end=0.02))
    with pytest.raises(AssertionError, match="pndm_traj"):
        tval.validate_against_goldens(wrong, p, rtol=1e-5, atol=1e-5,
                                      verbose=False)


def test_workflows_validate_cpu(tmp_path, capsys):
    from emcid_torch.cli import workflows

    p = tmp_path / "g.npz"
    base = ["validate", "--tiny", "--platform", "cpu", "--seed", "3"]
    assert workflows.main(base + ["--make_self_goldens", str(p)]) is None
    assert p.exists()
    errs = workflows.main(base + ["--goldens", str(p)])
    assert set(errs) == CHECKS
    assert "certified" in capsys.readouterr().out
    with pytest.raises(AssertionError):
        workflows.main(["validate", "--tiny", "--platform", "cpu",
                        "--seed", "4", "--goldens", str(p)])


# ---------------------------------------------------------------------------
# open_clip
# ---------------------------------------------------------------------------


def _text_cfgs(H=16, vocab=64, ctx=8, inter=32, proj=8, heads=4):
    kw = dict(vocab_size=vocab, hidden_size=H, intermediate_size=inter,
              num_hidden_layers=2, num_attention_heads=heads,
              max_position_embeddings=ctx, hidden_act="gelu",
              projection_dim=proj, eos_token_id=vocab - 1)
    return JTextConfig(**kw), CLIPTextConfig(**kw)


def test_openclip_text_matches_jax_converter():
    rng = np.random.RandomState(0)
    sd = _synthetic_openclip_text(rng)
    jcfg, tcfg = _text_cfgs()
    jparams = j_oc_text(sd)
    model = CLIPTextEncoder(tcfg)
    model.load_state_dict(openclip_text_from_torch(
        {k: torch.from_numpy(v) for k, v in sd.items()}), strict=True)
    ids = rng.randint(0, 62, (2, 8)).astype(np.int64)
    ids[:, -1] = 63
    ref = JText(jcfg).apply({"params": jparams}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(ids))
    assert rel_diff(np.asarray(ref.last_hidden_state),
                    got.last_hidden_state) <= 1e-5
    assert rel_diff(np.asarray(ref.pooled_output), got.pooled_output) <= 1e-5
    # the fused-qkv split: q_proj is the first H rows of the fused weight
    np.testing.assert_array_equal(
        model.text_model.encoder.layers[0].self_attn.q_proj.weight.detach()
        .numpy(),
        sd["transformer.resblocks.0.attn.in_proj_weight"][:16])


def _synthetic_openclip_vision(rng, H=32, L=2, inter=64):
    sd = {"visual.class_embedding": rng.randn(H).astype(np.float32),
          "visual.conv1.weight": rng.randn(H, 3, 8, 8).astype(np.float32),
          "visual.positional_embedding": rng.randn(17, H).astype(np.float32),
          "visual.proj": rng.randn(H, 16).astype(np.float32)}
    for ln in ("ln_pre", "ln_post"):
        sd[f"visual.{ln}.weight"] = rng.randn(H).astype(np.float32)
        sd[f"visual.{ln}.bias"] = rng.randn(H).astype(np.float32)
    for i in range(L):
        pre = f"visual.transformer.resblocks.{i}"
        for name, shape in (("attn.in_proj_weight", (3 * H, H)),
                            ("attn.in_proj_bias", (3 * H,)),
                            ("attn.out_proj.weight", (H, H)),
                            ("attn.out_proj.bias", (H,)),
                            ("mlp.c_fc.weight", (inter, H)),
                            ("mlp.c_fc.bias", (inter,)),
                            ("mlp.c_proj.weight", (H, inter)),
                            ("mlp.c_proj.bias", (H,)),
                            ("ln_1.weight", (H,)), ("ln_1.bias", (H,)),
                            ("ln_2.weight", (H,)), ("ln_2.bias", (H,))):
            sd[f"{pre}.{name}"] = (rng.randn(*shape) * 0.2).astype(
                np.float32)
    return sd


def test_openclip_vision_matches_jax_converter():
    rng = np.random.RandomState(1)
    sd = _synthetic_openclip_vision(rng)
    jparams = j_oc_vision(sd)
    model = CLIPVisionEncoder(TINY_CLIP_VISION)
    model.load_state_dict(openclip_vision_from_torch(
        {k: torch.from_numpy(v) for k, v in sd.items()}), strict=True)
    x = rng.randn(2, 32, 32, 3).astype(np.float32)
    ref = JVision(J_TINY_VISION).apply({"params": jparams}, jnp.asarray(x))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x))
    assert got.shape == (2, 16)
    assert rel_diff(np.asarray(ref), got) <= 1e-5


def test_validate_openclip_mechanics(tmp_path):
    """Goldens from the JAX package's converted model certify the port's
    converter; perturbed goldens fail."""
    rng = np.random.RandomState(0)
    H, ctx, vocab = 64, 8, 64
    sd = _synthetic_openclip_text(rng, H=H, L=2, vocab=vocab, ctx=ctx,
                                  inter=128, proj=16)
    ckpt = tmp_path / "oc.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    jcfg, _ = _text_cfgs(H=H, vocab=vocab, ctx=ctx, inter=128, proj=16,
                         heads=1)
    ids = np.zeros((2, ctx), np.int64)
    ids[:, 0] = 1
    ids[0, 1:4] = [5, 6, vocab - 1]
    ids[1, 1:4] = [7, 8, vocab - 1]
    out = JText(jcfg).apply({"params": j_oc_text(sd)},
                            jnp.asarray(ids, jnp.int32))
    g = tmp_path / "goldens.npz"
    np.savez(g, input_ids=ids,
             pixel_values=np.zeros((2, 4, 4, 3), np.float32),
             text_embeds=np.asarray(out.pooled_output),
             image_embeds=np.zeros((2, 16), np.float32),
             context_length=np.asarray(ctx), image_size=np.asarray(4))
    errs = tval.validate_openclip(ckpt, g, verbose=False, device="cpu")
    assert errs["text_embeds"] < 1e-4
    bad = dict(np.load(g))
    bad["text_embeds"] = bad["text_embeds"] + 1.0
    g2 = tmp_path / "bad.npz"
    np.savez(g2, **bad)
    with pytest.raises(AssertionError):
        tval.validate_openclip(ckpt, g2, verbose=False, device="cpu")


def test_validate_openclip_default_platform_wants_the_card(tmp_path):
    """``validate_openclip`` runs on the card unless asked otherwise: with
    no card present the default raises before any file is read, from the
    function and from ``workflows validate_openclip``."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default platform would run")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tval.validate_openclip(tmp_path / "c.pt", tmp_path / "g.npz")
    from emcid_torch.cli import workflows

    with pytest.raises(RuntimeError, match="no CUDA device"):
        workflows.main(["validate_openclip", "--checkpoint",
                        str(tmp_path / "c.pt"), "--goldens", "g.npz"])


# ---------------------------------------------------------------------------
# profiling
# ---------------------------------------------------------------------------


def test_step_report_arithmetic_and_peak():
    rep = tprof.StepReport(seconds=2.0, steps=4, flops_per_step=989e12)
    assert rep.ms_per_step == 500.0
    assert rep.tflops == pytest.approx(2 * 989.0)
    assert rep.mfu == pytest.approx(2.0)
    assert tprof.PEAK_TFLOPS == 989.0  # H100 SXM dense bf16
    assert str(rep) == "500 ms/step, 1978.0 TFLOP/s (200% MFU)"
    assert tprof.StepReport(1.0, 0, 1e12).ms_per_step == 1000.0


def test_stage1_flops_pooled_matches_jax():
    from emcid_tpu import profiling as jprof
    from emcid_tpu.models.configs import sd_v14_unet as j_sd

    from emcid_torch.models.configs import sd_v14_unet

    for pooled in (False, True):
        assert tprof.stage1_step_flops(sd_v14_unet(), 4, 3, 48,
                                       eps_dest_pooled=pooled) == \
            jprof.stage1_step_flops(j_sd(), 4, 3, 48,
                                    eps_dest_pooled=pooled)
