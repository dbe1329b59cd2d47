"""Stable-Diffusion sampling: seeded, batched, with CFG; latents to images
and back through the VAE.

Counterpart of ``emcid_tpu/models/pipeline.py``.  Latents at this module's
public functions are channel-last (B, h, w, c), as in the JAX package; the
UNet runs NCHW inside.  Each image's initial latents come from its own
``torch.Generator`` seeded with the image's seed, so an image does not
depend on its batch (the streams differ from JAX's by construction: tests
hand both packages the same latents through ``sample_latents(latents=)``).
"""

from __future__ import annotations

import dataclasses
import os
from dataclasses import dataclass, field
from typing import Any, Optional, Sequence

import numpy as np
import torch

from emcid_torch.models.scheduler import (
    Schedule,
    ddim_timesteps,
    run_sampler,
    sd_schedule,
)


@dataclass
class SDComponents:
    """The models of one Stable Diffusion pipeline (weights live in the
    modules; an edit returns new components with a new text encoder or
    UNet)."""

    tokenizer: Any
    text_encoder: torch.nn.Module  # CLIPTextEncoder
    unet: torch.nn.Module  # UNet2DCondition
    vae: torch.nn.Module  # AutoencoderKL
    schedule: Schedule = field(default_factory=sd_schedule)
    scaling_factor: float = 0.18215
    latent_channels: int = 4
    vae_scale: int = 8

    @property
    def device(self) -> torch.device:
        return next(self.unet.parameters()).device

    @property
    def dtype(self) -> torch.dtype:
        return next(self.unet.parameters()).dtype

    def replace_text_encoder(self, text_encoder) -> "SDComponents":
        return dataclasses.replace(self, text_encoder=text_encoder)

    def replace_unet(self, unet) -> "SDComponents":
        return dataclasses.replace(self, unet=unet)


def tokenize(components: SDComponents, prompts: Sequence[str],
             max_length: Optional[int] = None) -> torch.Tensor:
    tok = components.tokenizer
    enc = tok(list(prompts), padding="max_length", truncation=True,
              max_length=max_length or tok.model_max_length)
    return torch.as_tensor(enc["input_ids"], dtype=torch.long,
                           device=components.device)


@torch.no_grad()
def encode_prompts(components: SDComponents, prompts: Sequence[str],
                   max_length: Optional[int] = None) -> torch.Tensor:
    """Prompts -> (B, S, H) text-encoder hidden states."""
    ids = tokenize(components, prompts, max_length)
    return components.text_encoder(ids).last_hidden_state


def initial_latents(seeds: Sequence[int], height: int, width: int,
                    channels: int = 4, vae_scale: int = 8, device=None,
                    dtype=torch.float32) -> torch.Tensor:
    """(B, h, w, c) standard-normal latents, one generator per seed."""
    out = []
    for s in seeds:
        g = torch.Generator(device=device).manual_seed(int(s))
        out.append(torch.randn((height // vae_scale, width // vae_scale,
                                channels), generator=g, device=device,
                               dtype=dtype))
    return torch.stack(out)


@torch.no_grad()
def sample_latents(
    components: SDComponents,
    prompts: Sequence[str],
    seeds: Sequence[int],
    *,
    negative_prompts: Optional[Sequence[str]] = None,
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    height: int = 512,
    width: int = 512,
    sampler: str = "pndm",
    cfg_interval: float = 1.0,
    latents: Optional[torch.Tensor] = None,
    mesh=None,
) -> torch.Tensor:
    """Denoise to final latents (B, h, w, c), f32.

    ``cfg_interval < 1`` applies classifier-free guidance only for the
    first ``cfg_interval`` fraction of steps; the tail runs the
    conditional half-batch only.  ``latents`` (channel-last) replaces the
    seeded initial latents."""
    if mesh is not None:
        raise NotImplementedError("mesh= sharding (ROADMAP M14)")
    if len(prompts) != len(seeds):
        raise ValueError("one seed per prompt")
    if not 0.0 < cfg_interval <= 1.0:
        raise ValueError(f"cfg_interval={cfg_interval} must be in (0, 1]")
    dev = components.device
    ctx_cond = encode_prompts(components, prompts)
    ctx_uncond = None
    if guidance_scale > 1.0:
        neg = (negative_prompts if negative_prompts is not None
               else [""] * len(prompts))
        ctx_uncond = encode_prompts(components, neg)
    if latents is None:
        latents = initial_latents(seeds, height, width,
                                  components.latent_channels,
                                  components.vae_scale, device=dev)
    return denoise(components, latents, ctx_cond, ctx_uncond,
                   num_inference_steps=num_inference_steps,
                   guidance_scale=guidance_scale, sampler=sampler,
                   cfg_interval=cfg_interval)


@torch.no_grad()
def denoise(components: SDComponents, latents, ctx_cond: torch.Tensor,
            ctx_uncond: Optional[torch.Tensor] = None, *,
            num_inference_steps: int = 50, guidance_scale: float = 7.5,
            sampler: str = "pndm", cfg_interval: float = 1.0
            ) -> torch.Tensor:
    """The sampler loop on given text states: channel-last ``latents``
    (B, h, w, c) -> final latents (B, h, w, c), f32; CFG against
    ``ctx_uncond`` when ``guidance_scale > 1`` (the JAX package's
    ``_get_sampler`` run)."""
    dev, dtype = components.device, components.dtype
    unet = components.unet
    do_cfg = guidance_scale > 1.0
    if do_cfg:
        ctx2 = torch.cat([ctx_uncond, ctx_cond])
    lat = torch.as_tensor(latents, device=dev).float().permute(0, 3, 1, 2)

    def t_of(t):
        return torch.tensor([t], device=dev)

    def eps_plain(x, t):
        return unet(x.to(dtype), t_of(t), ctx_cond).sample.float()

    def eps_cfg(x, t):
        x2 = torch.cat([x, x]).to(dtype)
        eps_u, eps_c = unet(x2, t_of(t), ctx2).sample.float().chunk(2)
        return eps_u + guidance_scale * (eps_c - eps_u)

    ts = ddim_timesteps(components.schedule, num_inference_steps)
    ts_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    n_head = (max(1, int(round(cfg_interval * num_inference_steps)))
              if do_cfg and cfg_interval < 1.0 else None)
    out = run_sampler(sampler, components.schedule,
                      eps_cfg if do_cfg else eps_plain, lat, ts, ts_prev,
                      unet_eps_tail=eps_plain, n_head=n_head)
    return out.permute(0, 2, 3, 1).contiguous()


@torch.no_grad()
def decode_latents(components: SDComponents, latents) -> np.ndarray:
    """Channel-last latents -> uint8 RGB images (B, H, W, 3) on the host."""
    vae, sf = components.vae, components.scaling_factor
    lat = torch.as_tensor(latents, device=components.device).float()
    img = vae.decode((lat.permute(0, 3, 1, 2) / sf).to(components.dtype))
    img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
    img = torch.round(img * 255).to(torch.uint8).permute(0, 2, 3, 1)
    return img.cpu().numpy()


@torch.no_grad()
def encode_images(components: SDComponents, images,
                  generator: Optional[torch.Generator] = None
                  ) -> torch.Tensor:
    """uint8 or float RGB (B, H, W, 3) -> scaled latents (B, h, w, c): the
    posterior mode, or a draw from it with ``generator``."""
    dev = components.device
    x = torch.tensor(np.asarray(images), device=dev)
    x = x.float() / 255.0 if x.dtype == torch.uint8 else x.float()
    dist = components.vae.encode((x * 2.0 - 1.0).permute(0, 3, 1, 2)
                                 .to(components.dtype))
    z = dist.mean.float()
    if generator is not None:
        std = torch.exp(0.5 * torch.clamp(dist.logvar.float(), -30.0, 20.0))
        z = z + std * torch.randn(z.shape, generator=generator, device=dev)
    return (z * components.scaling_factor).permute(0, 2, 3, 1).contiguous()


def generate(components: SDComponents, prompts: Sequence[str],
             seeds: Sequence[int], batch_size: Optional[int] = None,
             mesh=None, **kwargs) -> np.ndarray:
    """Text -> uint8 images (B, H, W, 3), in chunks of ``batch_size``
    prompts (default: all; ``EMCID_TPU_GEN_BATCH`` caps it).  Each image
    has its own seed, so the chunking does not change the images."""
    if mesh is not None:
        raise NotImplementedError("mesh= sharding (ROADMAP M14)")
    prompts, seeds = list(prompts), list(seeds)
    n = len(prompts)
    if batch_size is None:
        env_bs = int(os.environ.get("EMCID_TPU_GEN_BATCH", "0") or 0)
        batch_size = min(env_bs, n) if env_bs else None
    bs = batch_size or n
    images = []
    for i in range(0, n, bs):
        lat = sample_latents(components, prompts[i:i + bs], seeds[i:i + bs],
                             **kwargs)
        images.append(decode_latents(components, lat))
    return np.concatenate(images, axis=0)
