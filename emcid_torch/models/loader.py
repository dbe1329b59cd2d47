"""Build ``SDComponents``: a full-width random pipeline, or one carried over
from the JAX package's weights.

Counterpart of ``emcid_tpu/models/loader.py``.  ``load_pipeline`` from a
local HF checkpoint folder is not ported yet (ROADMAP: no checkpoint is
available offline to test it against).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from emcid_torch.models import convert
from emcid_torch.models.clip_text import CLIPTextEncoder
from emcid_torch.models.configs import (
    CLIPTextConfig,
    SD_V14_TEXT,
    UNetConfig,
    VAEConfig,
    sd_v14_unet,
    sd_vae,
)
from emcid_torch.models.pipeline import SDComponents
from emcid_torch.models.scheduler import Schedule, sd_schedule
from emcid_torch.models.unet import UNet2DCondition
from emcid_torch.models.vae import AutoencoderKL
from emcid_torch.runtime import resolve_device
from emcid_torch.text.tokenizer import make_tiny_tokenizer


def _frozen(module: torch.nn.Module, dtype) -> torch.nn.Module:
    return module.to(dtype).eval().requires_grad_(False)


@torch.no_grad()
def _random_init_(module: torch.nn.Module, gen: torch.Generator) -> None:
    """Seeded weights: normal(0, fan_in^-1/2) matrices and kernels, zero
    biases, unit norm scales."""
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            p.zero_()
        elif p.dim() == 1:
            p.fill_(1.0)
        else:
            fan_in = int(np.prod(p.shape[1:]))
            p.copy_(torch.randn(p.shape, generator=gen, device=p.device)
                    * fan_in ** -0.5)


def build_random_pipeline(name: str = "sd-v1.4", dtype=torch.bfloat16,
                          tokenizer=None, seed: int = 0,
                          device=None) -> SDComponents:
    """Full-architecture pipeline with random weights drawn from ``seed``."""
    if name not in ("sd-v1.4", "sd-v1.5"):
        raise ValueError(f"unknown pipeline {name!r}")
    dev = resolve_device(device)
    if tokenizer is None:
        tokenizer = make_tiny_tokenizer(
            [f"w{i}" for i in range(64)]
            + ["photo", "of", "a", "an", "image", "painting", "by", "style",
               "artwork", "art"],
            model_max_length=77,
        )
    gen = torch.Generator(device=dev).manual_seed(seed)
    with torch.device(dev):
        text = CLIPTextEncoder(SD_V14_TEXT)
        unet = UNet2DCondition(sd_v14_unet())
        vae = AutoencoderKL(sd_vae())
    for m in (text, unet, vae):
        _random_init_(m, gen)
    return SDComponents(
        tokenizer=tokenizer, text_encoder=_frozen(text, dtype),
        unet=_frozen(unet, dtype), vae=_frozen(vae, dtype),
        schedule=sd_schedule(),
    )


def _load(module: torch.nn.Module, state: Dict[str, np.ndarray]) -> None:
    module.load_state_dict(
        {k: torch.from_numpy(np.array(v, dtype=np.float32))
         for k, v in state.items()}, strict=True)


def from_jax(*, tokenizer, text_config: CLIPTextConfig,
             unet_config: UNetConfig, vae_config: VAEConfig,
             text_params: Dict[str, Any], unet_params: Dict[str, Any],
             vae_params: Dict[str, Any], schedule: Optional[Schedule] = None,
             scaling_factor: float = 0.18215, vae_scale: int = 8,
             device=None, dtype=torch.float32) -> SDComponents:
    """Components holding the JAX package's weights (Flax trees given as
    nested dicts of numpy arrays), converted by ``models.convert``."""
    dev = resolve_device(device)
    text = CLIPTextEncoder(text_config)
    unet = UNet2DCondition(unet_config)
    vae = AutoencoderKL(vae_config)
    _load(text, convert.clip_text_to_torch(text_params))
    _load(unet, convert.unet_to_torch(unet_params))
    _load(vae, convert.vae_to_torch(vae_params))
    return SDComponents(
        tokenizer=tokenizer,
        text_encoder=_frozen(text.to(dev), dtype),
        unet=_frozen(unet.to(dev), dtype),
        vae=_frozen(vae.to(dev), dtype),
        schedule=schedule or sd_schedule(),
        scaling_factor=scaling_factor, vae_scale=vae_scale,
    )
