"""Training images for Stage 1: generated with the frozen pipeline, or
given (``images``) or read from files (``training_img_paths``).

Counterpart of ``emcid_tpu/engine/training_images.py``.  The output is the
scaled VAE posterior (mean, logvar), channel-last: Stage 1 re-samples the
posterior every step.  A block of generated images only takes the fused
path (decode, quantize to uint8 levels, re-encode on the device); a block
with given images, or one whose images are returned, goes through uint8
images and ``encode_posterior`` as the JAX package does.
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.models.pipeline import SDComponents, generate, sample_latents


def preprocess_images(images, resolution: int = 512) -> np.ndarray:
    """PIL images or arrays -> float32 NHWC in [-1, 1]; PIL images are
    resized to ``resolution``, arrays above 1.5 are read as 0-255."""
    out = []
    for img in images:
        if hasattr(img, "convert"):  # PIL
            img = img.convert("RGB").resize((resolution, resolution))
            arr = np.asarray(img, dtype=np.float32) / 255.0
        else:
            arr = np.asarray(img, dtype=np.float32)
            if arr.max() > 1.5:
                arr = arr / 255.0
        out.append(arr * 2.0 - 1.0)
    return np.stack(out)


@torch.no_grad()
def encode_posterior(components: SDComponents, images
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Images in [-1, 1] (B, H, W, 3) -> scaled posterior (mean, logvar),
    channel-last, on the device."""
    vae, sf = components.vae, components.scaling_factor
    x = torch.as_tensor(np.asarray(images, np.float32)
                        if not torch.is_tensor(images) else images,
                        device=components.device).float()
    dist = vae.encode(x.permute(0, 3, 1, 2).to(components.dtype))
    mean = dist.mean.float() * sf
    logvar = dist.logvar.float() + 2.0 * math.log(sf)
    return (mean.permute(0, 2, 3, 1).contiguous(),
            logvar.permute(0, 2, 3, 1).contiguous())


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
    sf, dtype = components.scaling_factor, components.dtype
    img = components.vae.decode((lat.permute(0, 3, 1, 2) / sf).to(dtype))
    img = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
    img = torch.round(img * 255.0) / 255.0 * 2.0 - 1.0
    return encode_posterior(components, img.permute(0, 2, 3, 1))


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
    device.  ``latents`` (n, h, w, c) replaces the seeded initial latents.
    With ``batch_size`` None, ``EMCID_TPU_GEN_BATCH`` caps the batch (a
    cap: a shorter prompt list runs in one batch of its own length); every
    image has its own seed, so the chunks change nothing but peak memory."""
    if mesh is not None:
        raise NotImplementedError("mesh= sharding (ROADMAP M14)")
    prompts, seeds = list(prompts), list(seeds)
    n = len(prompts)
    if batch_size is None:
        env_bs = int(os.environ.get("EMCID_TPU_GEN_BATCH", "0") or 0)
        batch_size = min(env_bs, n) if env_bs else None
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
    use_dest_prompts=False,
    return_images: bool = False,
    sampler: str = "pndm",
    cfg_interval: Optional[float] = None,
    verbose: bool = False,
):
    """(C, Simg, P, h, w, c) scaled posterior mean/logvar for all requests.

    Per request: the ``images`` or ``training_img_paths`` it carries (paths
    missing on disk fall back to generation), else ``samples_per_prompt``
    images per prompt generated with the frozen pipeline, seeded by
    ``seed_train``.  ``use_dest_prompts`` (a bool, or one per request)
    generates from the dest-formatted prompts instead.  ``return_images``
    also returns the [-1, 1] images (C*Simg*P, H, W, 3), a float32 tensor on
    the device."""
    cfg_interval = resolve_cfg_interval(cfg_interval, num_inference_steps)
    Simg = getattr(hparams, "samples_per_prompt", 1)
    P = len(requests[0]["prompts"])
    C = len(requests)
    if isinstance(use_dest_prompts, bool):
        use_dest = [use_dest_prompts] * C
    else:
        use_dest = [bool(u) for u in use_dest_prompts]
        if len(use_dest) != C:
            raise ValueError("one use_dest_prompts flag per request")

    gen_prompts: List[str] = []
    gen_seeds: List[int] = []
    gen_slots: List[Tuple[int, int, int]] = []
    loaded: Dict[Tuple[int, int, int], np.ndarray] = {}
    for c, request in enumerate(requests):
        word = request["dest"] if use_dest[c] else request["source"]
        src_prompts = [p.format(word) for p in request["prompts"]]
        imgs = None
        if "training_img_paths" in request:
            from PIL import Image

            paths = request["training_img_paths"]
            if all(os.path.exists(pp) for pp in paths):
                imgs = [Image.open(pp) for pp in paths]
            else:
                print(f"[emcid_torch] training_img_paths missing on disk "
                      f"({paths[0]}...): falling back to generation")
        elif "images" in request:
            imgs = request["images"]
        if imgs is not None:
            arr = preprocess_images(imgs, resolution=height)
            # tile or truncate to (Simg, P)
            need = Simg * P
            reps = int(np.ceil(need / len(arr)))
            arr = np.tile(arr, (reps, 1, 1, 1))[:need]
            for s in range(Simg):
                for p in range(P):
                    loaded[(c, s, p)] = arr[s * P + p]
        else:
            seed0 = int(request.get("seed_train") or 0)
            for s in range(Simg):
                for p, prompt in enumerate(src_prompts):
                    gen_prompts.append(prompt)
                    # distinct, reproducible seed per (concept, sample, prompt)
                    gen_seeds.append(seed0 * 10007 + s * 101 + p)
                    gen_slots.append((c, s, p))

    gen_kw = dict(batch_size=batch_size,
                  num_inference_steps=num_inference_steps,
                  guidance_scale=guidance_scale, height=height, width=width,
                  sampler=sampler, cfg_interval=cfg_interval)
    if gen_prompts and not loaded and not return_images:
        # generation only: the fused path, images never leave the device
        if verbose:
            print(f"generating {len(gen_prompts)} training images (fused)")
        # every request generates, so the slots run in (c, s, p) order
        mean, logvar = generate_posteriors(components, gen_prompts,
                                           gen_seeds, **gen_kw)
        shape = (C, Simg, P) + tuple(mean.shape[1:])
        return mean.reshape(shape), logvar.reshape(shape)

    if gen_prompts:
        if verbose:
            print(f"generating {len(gen_prompts)} training images")
        imgs = generate(components, gen_prompts, gen_seeds, **gen_kw)
        arr = imgs.astype(np.float32) / 255.0 * 2.0 - 1.0
        for slot, im in zip(gen_slots, arr):
            loaded[slot] = im
    all_imgs = np.stack([loaded[(c, s, p)] for c in range(C)
                         for s in range(Simg) for p in range(P)])
    mean, logvar = encode_posterior(components, all_imgs)
    shape = (C, Simg, P) + tuple(mean.shape[1:])
    out = (mean.reshape(shape), logvar.reshape(shape))
    if return_images:
        return out + (torch.as_tensor(all_imgs, device=mean.device),)
    return out
