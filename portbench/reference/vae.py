"""AutoencoderKL (diffusers names), plain, NCHW: ``encode`` gives the
posterior (mean, logvar) before the scaling factor, ``decode`` maps such
latents to RGB in [-1, 1].  GroupNorms eps 1e-6; the encoder's
downsamplers pad the bottom and right edge and convolve with stride 2
(diffusers' ``padding=0`` downsampler); the mid-block attention is one
head as wide as the channels."""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.ops import Prec, attention, conv, group_norm, linear

EPS = 1e-6


def _resnet(p: Prec, name: str, x, groups: int):
    h = conv(p, name + ".conv1", F.silu(group_norm(p, name + ".norm1", x,
                                                   groups, EPS)))
    h = conv(p, name + ".conv2", F.silu(group_norm(p, name + ".norm2", h,
                                                   groups, EPS)))
    if p.has(name + ".conv_shortcut.weight"):
        x = conv(p, name + ".conv_shortcut", x)
    return x + h


def _mid(p: Prec, name: str, h, groups: int):
    h = _resnet(p, name + ".resnets.0", h, groups)
    a = name + ".attentions.0"
    B, C, H, W = h.shape
    x = group_norm(p, a + ".group_norm", h, groups, EPS).permute(
        0, 2, 3, 1).reshape(B, H * W, C)
    q, k, v = (linear(p, f"{a}.to_{n}", x)[:, :, None, :] for n in "qkv")
    o = linear(p, a + ".to_out.0", attention(p, q, k, v)[:, :, 0, :])
    h = h + o.reshape(B, H, W, C).permute(0, 3, 1, 2)
    return _resnet(p, name + ".resnets.1", h, groups)


def encode(p: Prec, cfg: Dict, x: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RGB (B, 3, H, W) in [-1, 1] -> (mean, logvar), each (B, c, h, w)."""
    g = cfg["norm_num_groups"]
    chs = cfg["block_out_channels"]
    h = conv(p, "encoder.conv_in", x.float())
    for lvl in range(len(chs)):
        for j in range(cfg["layers_per_block"]):
            h = _resnet(p, f"encoder.down_blocks.{lvl}.resnets.{j}", h, g)
        if lvl < len(chs) - 1:
            h = conv(p, f"encoder.down_blocks.{lvl}.downsamplers.0.conv",
                     F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
    h = _mid(p, "encoder.mid_block", h, g)
    h = conv(p, "encoder.conv_out",
             F.silu(group_norm(p, "encoder.conv_norm_out", h, g, EPS)))
    mean, logvar = conv(p, "quant_conv", h).chunk(2, dim=1)
    return mean, logvar


def decode(p: Prec, cfg: Dict, z: torch.Tensor) -> torch.Tensor:
    """Latents (B, c, h, w) before the scaling factor -> RGB (B, 3, H, W)."""
    g = cfg["norm_num_groups"]
    n = len(cfg["block_out_channels"])
    h = conv(p, "decoder.conv_in", conv(p, "post_quant_conv", z.float()))
    h = _mid(p, "decoder.mid_block", h, g)
    for lvl in range(n):
        for j in range(cfg["layers_per_block"] + 1):
            h = _resnet(p, f"decoder.up_blocks.{lvl}.resnets.{j}", h, g)
        if lvl < n - 1:
            h = conv(p, f"decoder.up_blocks.{lvl}.upsamplers.0.conv",
                     F.interpolate(h, scale_factor=2.0, mode="nearest"))
    return conv(p, "decoder.conv_out",
                F.silu(group_norm(p, "decoder.conv_norm_out", h, g, EPS)))


def to_uint8(img: torch.Tensor) -> torch.Tensor:
    """RGB (B, 3, H, W) in [-1, 1] -> uint8 (B, H, W, 3), rounded half to
    even as ``torch.round`` does."""
    x = torch.clamp(img.float() / 2 + 0.5, 0.0, 1.0)
    return torch.round(x * 255).to(torch.uint8).permute(0, 2, 3, 1)
