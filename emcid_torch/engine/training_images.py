"""Training images for Stage 1: generate, decode, quantize, re-encode.

Counterpart of ``emcid_tpu/engine/training_images.py`` (the generation
path; training images loaded from files wait, ROADMAP M7).  The output is
the scaled VAE posterior (mean, logvar), channel-last: Stage 1 re-samples
the posterior every step.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from emcid_torch.models.pipeline import SDComponents, sample_latents


def resolve_cfg_interval(cfg_interval: Optional[float],
                         num_inference_steps: int) -> float:
    """CFG interval for training-image generation: the explicit value, else
    ``EMCID_TPU_CFG_INTERVAL``, else 0.6 for samplers of >= 10 steps and
    1.0 (the reference protocol) below that."""
    if cfg_interval is not None:
        return float(cfg_interval)
    env = os.environ.get("EMCID_TPU_CFG_INTERVAL")
    if env is not None:
        return float(env)
    return 0.6 if num_inference_steps >= 10 else 1.0


@torch.no_grad()
def posterior_of_latents(components: SDComponents, lat: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Channel-last latents -> scaled posterior (mean, logvar) of their
    decoded images, quantized to uint8 levels (round half to even) as a
    save-to-disk round trip would."""
    vae, sf, dtype = components.vae, components.scaling_factor, components.dtype
    img = vae.decode((lat.permute(0, 3, 1, 2) / sf).to(dtype)).float()
    img = torch.clamp(img / 2 + 0.5, 0.0, 1.0)
    img = torch.round(img * 255.0) / 255.0 * 2.0 - 1.0
    dist = vae.encode(img.to(dtype))
    mean = dist.mean.float() * sf
    logvar = dist.logvar.float() + 2.0 * math.log(sf)
    return (mean.permute(0, 2, 3, 1).contiguous(),
            logvar.permute(0, 2, 3, 1).contiguous())


def generate_posteriors(
    components: SDComponents,
    prompts,
    seeds,
    batch_size: Optional[int] = None,
    mesh=None,
    latents: Optional[torch.Tensor] = None,
    **sample_kwargs,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Text -> scaled posterior (mean, logvar), (n, h, w, c) each, on the
    device.  ``latents`` (n, h, w, c) replaces the seeded initial latents."""
    if mesh is not None:
        raise NotImplementedError("mesh= sharding (ROADMAP M14)")
    prompts, seeds = list(prompts), list(seeds)
    n = len(prompts)
    bs = batch_size or n
    means, logvars = [], []
    for i in range(0, n, bs):
        lat = sample_latents(
            components, prompts[i:i + bs], seeds[i:i + bs],
            latents=None if latents is None else latents[i:i + bs],
            **sample_kwargs)
        m, lv = posterior_of_latents(components, lat)
        means.append(m)
        logvars.append(lv)
    return torch.cat(means), torch.cat(logvars)


def training_latents_for_requests(
    components: SDComponents,
    requests: Sequence[Dict],
    hparams,
    height: int = 512,
    width: int = 512,
    num_inference_steps: int = 50,
    guidance_scale: float = 7.5,
    batch_size: Optional[int] = None,
    sampler: str = "pndm",
    cfg_interval: Optional[float] = None,
    verbose: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, Simg, P, h, w, c) scaled posterior mean/logvar for all requests,
    from ``samples_per_prompt`` images per source prompt generated with
    the frozen pipeline, seeded by ``seed_train``."""
    cfg_interval = resolve_cfg_interval(cfg_interval, num_inference_steps)
    Simg = getattr(hparams, "samples_per_prompt", 1)
    P = len(requests[0]["prompts"])
    gen_prompts: List[str] = []
    gen_seeds: List[int] = []
    for request in requests:
        if "training_img_paths" in request or "images" in request:
            raise NotImplementedError(
                "training images from files (ROADMAP M7: training images "
                "loaded from disk)")
        seed0 = int(request.get("seed_train") or 0)
        src_prompts = [p.format(request["source"]) for p in request["prompts"]]
        for s in range(Simg):
            for p, prompt in enumerate(src_prompts):
                gen_prompts.append(prompt)
                # distinct, reproducible seed per (concept, sample, prompt)
                gen_seeds.append(seed0 * 10007 + s * 101 + p)
    if verbose:
        print(f"generating {len(gen_prompts)} training images (fused)")
    mean, logvar = generate_posteriors(
        components, gen_prompts, gen_seeds, batch_size=batch_size,
        num_inference_steps=num_inference_steps,
        guidance_scale=guidance_scale, height=height, width=width,
        sampler=sampler, cfg_interval=cfg_interval)
    C = len(requests)
    shape = (C, Simg, P) + tuple(mean.shape[1:])
    return mean.reshape(shape), logvar.reshape(shape)
