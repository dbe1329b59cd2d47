"""Real-checkpoint parity harness: certify a local SD checkpoint end to end.

Counterpart of ``emcid_tpu/cli/validate.py``.  Two halves:

* ``scripts/make_goldens_torch.py`` (run where diffusers is installed)
  writes a ``goldens.npz``: fixed inputs and reference outputs of the CLIP
  text encoder, the UNet, the VAE decode/encode, and a PNDM latent
  trajectory driven by a synthetic eps function (the scheduler's math
  without a UNet);
* ``python -m emcid_torch.cli.workflows validate --checkpoint_dir ...
  --goldens goldens.npz`` loads the checkpoint through the port's loader
  and asserts every output within tolerance.

``make_self_goldens`` writes the same npz from the port's own models (the
harness's self-test, and a regression baseline once a real checkpoint has
been validated).  The npz keeps the JAX package's schema and its
channel-last layout (latents, context, images, eps); the port transposes
at the edge, so either package's goldens validate the other's models.
Every forward here runs in exact f32 matmuls and convolutions
(``runtime.precise_matmuls``).
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from emcid_torch.runtime import precise_matmuls


def _fixed_inputs(text_cfg, latent_hw: int = 32, ctx_len: int = 77,
                  hidden: int = 768, seed: int = 0) -> Dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    ids = np.full((2, ctx_len), 49407, np.int64)
    ids[:, 0] = 49406
    ids[0, 1:6] = [320, 1125, 539, 320, 2368]    # "a photo of a cat"
    ids[1, 1:6] = [320, 1125, 539, 320, 1929]    # "a photo of a dog"
    return {
        "input_ids": ids,
        "latents": rng.randn(2, latent_hw, latent_hw, 4).astype(np.float32),
        "timesteps": np.array([17, 501], np.int64),
        "context": rng.randn(2, ctx_len, hidden).astype(np.float32),
        "vae_latents": rng.randn(1, latent_hw, latent_hw, 4).astype(
            np.float32),
        "image": rng.rand(1, latent_hw * 8, latent_hw * 8, 3).astype(
            np.float32) * 2 - 1,
    }


def synthetic_eps(latents: np.ndarray, t: int) -> np.ndarray:
    """Deterministic fake eps for scheduler-only parity: a fixed elementwise
    map of (latent, t) both sides can compute without a UNet."""
    return np.tanh(latents * 0.7 + float(t) / 1000.0).astype(np.float32)


def pndm_trajectory_ours(schedule, shape, num_steps: int = 8,
                         seed: int = 3) -> np.ndarray:
    """The latents after every PNDM step on ``synthetic_eps``, from seeded
    normal latents of ``shape`` (the port's ``pndm_step`` on the host)."""
    from emcid_torch.models.scheduler import (
        ddim_timesteps, pndm_init, pndm_step,
    )

    rng = np.random.RandomState(seed)
    lat = torch.tensor(rng.randn(*shape).astype(np.float32))
    ts = ddim_timesteps(schedule, num_steps)
    ts_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    # diffusers skip-prk PNDM duplicates the second timestep and Heun-
    # corrects the first transition (the arrays run_sampler builds); the
    # torch golden script iterates sched.timesteps, which includes the
    # duplicate, so both sides simulate N+1 steps
    ts_eval = np.concatenate([ts[:1], ts[1:2], ts[1:]])
    ts_tr = np.concatenate([ts[:1], ts[:1], ts[1:]])
    ts_tr_prev = np.concatenate([ts_prev[:1], ts_prev[:1], ts_prev[1:]])
    state = pndm_init()
    traj = []
    for te, t, tp in zip(ts_eval, ts_tr, ts_tr_prev):
        eps = torch.tensor(synthetic_eps(lat.numpy(), int(te)))
        state, lat = pndm_step(schedule, state, lat, eps, int(t), int(tp))
        traj.append(lat.numpy().copy())
    return np.stack(traj)


@torch.no_grad()
def _outputs(components, inp) -> Dict[str, np.ndarray]:
    """The models' outputs on the goldens' inputs, channel-last f32."""
    dev, dtype = components.device, components.dtype
    nchw = lambda a: torch.tensor(np.asarray(a, np.float32), device=dev
                                  ).permute(0, 3, 1, 2).to(dtype)
    nhwc = lambda t: t.float().permute(0, 2, 3, 1).cpu().numpy()
    out = {}
    with precise_matmuls():
        ids = torch.as_tensor(np.asarray(inp["input_ids"]), dtype=torch.long,
                              device=dev)
        t_out = components.text_encoder(ids)
        out["text_hidden"] = t_out.last_hidden_state.float().cpu().numpy()
        out["text_pooled"] = t_out.pooled_output.float().cpu().numpy()
        ts = torch.as_tensor(np.asarray(inp["timesteps"]), dtype=torch.long,
                             device=dev)
        ctx = torch.tensor(np.asarray(inp["context"], np.float32),
                           device=dev).to(dtype)
        out["unet_eps"] = nhwc(components.unet(nchw(inp["latents"]), ts,
                                               ctx).sample)
        out["vae_decode"] = nhwc(components.vae.decode(
            nchw(inp["vae_latents"])))
        dist = components.vae.encode(nchw(inp["image"]))
        out["vae_enc_mean"] = nhwc(dist.mean)
        out["vae_enc_logvar"] = nhwc(dist.logvar)
    return out


def make_self_goldens(components, out_path, num_pndm_steps: int = 8) -> Dict:
    """Goldens from the port's models (harness self-test / regression
    baseline)."""
    cfg = components.text_encoder.config
    hw = components.unet.config.sample_size
    inp = _fixed_inputs(cfg, latent_hw=hw, ctx_len=cfg.max_position_embeddings,
                        hidden=cfg.hidden_size)
    inp["input_ids"] = np.clip(inp["input_ids"], 0, cfg.vocab_size - 1)
    out = dict(inp)
    out.update(_outputs(components, inp))
    out["pndm_traj"] = pndm_trajectory_ours(
        components.schedule, inp["latents"].shape[:1] + (hw, hw, 4),
        num_pndm_steps)
    out["pndm_steps"] = np.asarray(num_pndm_steps)
    if out_path is not None:
        Path(out_path).parent.mkdir(parents=True, exist_ok=True)
        np.savez(out_path, **out)
    return out


def validate_against_goldens(components, goldens, rtol=None,
                             atol=None, verbose: bool = True) -> Dict[str, float]:
    """Compare the loaded checkpoint's outputs against a goldens npz.

    Returns {check: max_abs_err}; raises AssertionError on failure.
    Default tolerances assume the checkpoint loaded in bf16 (the deploy
    dtype) — pass tighter ones for f32 runs."""
    if isinstance(goldens, (str, Path)):
        goldens = dict(np.load(goldens))
    errs: Dict[str, float] = {}
    # bf16 weights -> ~1e-2 relative on unit-scale activations
    atol = 3e-2 if atol is None else atol
    rtol = 3e-2 if rtol is None else rtol

    def check(name, got, want, a=None, r=None):
        got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
        errs[name] = float(np.abs(got - want).max())
        np.testing.assert_allclose(got, want, rtol=r or rtol, atol=a or atol,
                                   err_msg=name)
        if verbose:
            print(f"  {name:14s} max|err| {errs[name]:.2e}  OK")

    ours = _outputs(components, goldens)
    for name in ("text_hidden", "text_pooled", "unet_eps", "vae_decode",
                 "vae_enc_mean", "vae_enc_logvar"):
        check(name, ours[name], goldens[name])
    traj = pndm_trajectory_ours(
        components.schedule, goldens["pndm_traj"].shape[1:],
        int(goldens["pndm_steps"]))
    # scheduler math is model-free -> tight tolerance regardless of dtype
    check("pndm_traj", traj, goldens["pndm_traj"], a=1e-4, r=1e-4)
    if verbose:
        print("checkpoint certified against goldens")
    return errs


def cmd_validate(args):
    """``workflows validate``: self-goldens (``--make_self_goldens``) or a
    validation against ``--goldens``, on ``--platform`` (the card unless
    the flags ask for the CPU).  Returns the errors of a validation."""
    import sys

    from emcid_torch.models.loader import build_tiny_pipeline, load_pipeline
    from emcid_torch.runtime import resolve_device

    dev = resolve_device(getattr(args, "platform", None))
    if args.tiny:
        comps = build_tiny_pipeline(seed=args.seed, device=dev)
    elif args.checkpoint_dir:
        comps = load_pipeline(
            args.checkpoint_dir, device=dev,
            dtype=torch.float32 if args.f32 else torch.bfloat16)
    else:
        sys.exit("validate: pass --checkpoint_dir (local HF checkpoint) "
                 "or --tiny")
    if args.make_self_goldens:
        make_self_goldens(comps, args.make_self_goldens)
        print(f"self-goldens written to {args.make_self_goldens}")
        return None
    if not args.goldens:
        sys.exit("validate: pass --goldens goldens.npz (generate one with "
                 "scripts/make_goldens_torch.py in a diffusers environment, "
                 "or --make_self_goldens PATH for a regression baseline)")
    return validate_against_goldens(
        comps, args.goldens,
        rtol=(1e-4 if args.f32 else None),
        atol=(1e-4 if args.f32 else None),
    )


# open_clip vision towers whose head count is NOT width//64 (head_width
# 80 for ViT-H-14, 104 for ViT-bigG-14, 88 for ViT-g-14) — keyed by
# tower width
_OPENCLIP_VISION_HEADS = {1280: 16, 1664: 16, 1408: 16}
# widths where width//64 IS the right head count (ViT-B/L families) — any
# other width falls back to width//64 with a warning so a heads mismatch
# is diagnosable instead of a confusing golden failure
_OPENCLIP_HEADS_BY_64 = {512, 640, 768, 896, 1024}


@torch.no_grad()
def validate_openclip(checkpoint, goldens, rtol=2e-3, atol=2e-3,
                      act: str = "gelu", vision_heads: Optional[int] = None,
                      verbose: bool = True, device=None) -> Dict[str, float]:
    """Compare the open_clip converters against goldens from
    scripts/make_goldens_openclip.py (a real open_clip checkpoint run
    through the original torch implementation), in exact f32 on
    ``device`` (the card unless the caller asks for another one); the
    comparison runs on the host.

    Text heads default to hidden//64 (open_clip's convention for the CLIP
    families, incl. bigG's 1280/64=20); vision heads use a known-width
    table for the head_width!=64 towers (ViT-H-14, ViT-bigG-14) with
    ``vision_heads`` as the explicit override.  ``act='quick_gelu'`` for
    OpenAI-pretrained checkpoints."""
    from emcid_torch.models.clip_text import CLIPTextEncoder
    from emcid_torch.models.configs import CLIPTextConfig
    from emcid_torch.models.convert_openclip import (
        openclip_text_from_torch, openclip_vision_from_torch,
    )
    from emcid_torch.models.vision import CLIPVisionConfig, CLIPVisionEncoder
    from emcid_torch.runtime import resolve_device

    dev = resolve_device(device)
    sd = torch.load(checkpoint, map_location="cpu", weights_only=True)
    if hasattr(sd, "state_dict"):
        sd = sd.state_dict()
    sd = dict(sd)
    g = dict(np.load(goldens))
    errs: Dict[str, float] = {}

    # ---- text tower -------------------------------------------------------
    H = sd["ln_final.weight"].shape[0]
    vocab, _ = sd["token_embedding.weight"].shape
    ctx = sd["positional_embedding"].shape[0]
    inter = sd["transformer.resblocks.0.mlp.c_fc.weight"].shape[0]
    L = 0
    while f"transformer.resblocks.{L}.attn.in_proj_weight" in sd:
        L += 1
    proj = sd["text_projection"].shape[1] if "text_projection" in sd else None
    cfg = CLIPTextConfig(
        vocab_size=vocab, hidden_size=H, intermediate_size=inter,
        num_hidden_layers=L, num_attention_heads=H // 64,
        max_position_embeddings=ctx, hidden_act=act,
        projection_dim=proj, eos_token_id=vocab - 1,
    )
    text = CLIPTextEncoder(cfg)
    text.load_state_dict(openclip_text_from_torch(
        {k: v for k, v in sd.items() if not k.startswith("visual.")}),
        strict=True)
    text = text.float().eval().to(dev)
    with precise_matmuls():
        pooled = text(torch.as_tensor(g["input_ids"], dtype=torch.long,
                                      device=dev)).pooled_output.cpu().numpy()
    errs["text_embeds"] = float(np.abs(pooled - g["text_embeds"]).max())
    np.testing.assert_allclose(pooled, g["text_embeds"], rtol=rtol,
                               atol=atol, err_msg="text_embeds")
    if verbose:
        print(f"  text_embeds   max|err| {errs['text_embeds']:.2e}  OK")

    # ---- vision tower -----------------------------------------------------
    vsd = {k: v for k, v in sd.items() if k.startswith("visual.")}
    if vsd:
        Hv = vsd["visual.ln_post.weight"].shape[0]
        patch = vsd["visual.conv1.weight"].shape[-1]
        interv = vsd["visual.transformer.resblocks.0.mlp.c_fc.weight"].shape[0]
        Lv = 0
        while f"visual.transformer.resblocks.{Lv}.attn.in_proj_weight" in vsd:
            Lv += 1
        heads_v = (vision_heads if vision_heads is not None
                   else _OPENCLIP_VISION_HEADS.get(Hv, Hv // 64))
        if (vision_heads is None and Hv not in _OPENCLIP_VISION_HEADS
                and Hv not in _OPENCLIP_HEADS_BY_64):
            print(f"[validate_openclip] WARNING: vision width {Hv} is not "
                  f"in the known-heads table; assuming {Hv // 64} heads "
                  "(width//64). If the tower uses head_width != 64 pass "
                  "--vision_heads explicitly — a wrong head count shows up "
                  "as a large image_embeds golden mismatch.")
        vcfg = CLIPVisionConfig(
            hidden_size=Hv, num_hidden_layers=Lv,
            num_attention_heads=heads_v, intermediate_size=interv,
            image_size=int(g["image_size"]), patch_size=patch,
            projection_dim=vsd["visual.proj"].shape[1],
            hidden_act=act,
        )
        vision = CLIPVisionEncoder(vcfg)
        vision.load_state_dict(openclip_vision_from_torch(vsd), strict=True)
        vision = vision.float().eval().to(dev)
        with precise_matmuls():
            emb = vision(torch.tensor(np.asarray(g["pixel_values"],
                                                 np.float32), device=dev)
                         ).cpu().numpy()
        errs["image_embeds"] = float(np.abs(emb - g["image_embeds"]).max())
        np.testing.assert_allclose(emb, g["image_embeds"], rtol=rtol,
                                   atol=atol, err_msg="image_embeds")
        if verbose:
            print(f"  image_embeds  max|err| {errs['image_embeds']:.2e}  OK")
    if verbose:
        print("open_clip converters certified")
    return errs
