"""AutoencoderKL (SD VAE) with diffusers parameter names.

Counterpart of ``emcid_tpu/models/vae.py``; NCHW inside.  ``encode`` gives
the posterior (mean, logvar) before the scaling factor, ``decode`` maps
latents back to RGB in [-1, 1]; SD3's VAE has no 1x1 quant convs
(``use_quant_conv``/``use_post_quant_conv`` False).  The mid-block attention is one head of
width C (512 in SD) over H*W tokens, through ``ops.attention`` — the
flash-v2 forward kernel on the card at the 48x48 grid and above.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from emcid_torch.models.configs import VAEConfig
from emcid_torch.ops.attention import attention


class VaeResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=1e-6)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=1e-6)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class VaeAttention(nn.Module):
    """Single-head spatial self-attention."""

    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.group_norm = nn.GroupNorm(groups, ch, eps=1e-6)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch), nn.Identity()])

    def forward(self, x):
        B, C, H, W = x.shape
        h = self.group_norm(x).permute(0, 2, 3, 1).reshape(B, H * W, C)
        q = self.to_q(h)[:, :, None, :]
        k = self.to_k(h)[:, :, None, :]
        v = self.to_v(h)[:, :, None, :]
        out = attention(q, k, v, scale=C ** -0.5)[:, :, 0, :]
        out = self.to_out[0](out)
        return x + out.reshape(B, H, W, C).permute(0, 3, 1, 2)


class _Mid(nn.Module):
    def __init__(self, ch: int, groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VaeResnetBlock(ch, ch, groups),
                                      VaeResnetBlock(ch, ch, groups)])
        self.attentions = nn.ModuleList([VaeAttention(ch, groups)])

    def forward(self, h):
        h = self.resnets[0](h)
        h = self.attentions[0](h)
        return self.resnets[1](h)


class _Level(nn.Module):
    def __init__(self, resnets, resampler_name=None, conv=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if conv is not None:
            holder = nn.Module()
            holder.conv = conv
            setattr(self, resampler_name, nn.ModuleList([holder]))


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        chs = cfg.block_out_channels
        self.conv_in = nn.Conv2d(cfg.in_channels, chs[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        ch = chs[0]
        for lvl, out_ch in enumerate(chs):
            resnets = []
            for _ in range(cfg.layers_per_block):
                resnets.append(VaeResnetBlock(ch, out_ch, g))
                ch = out_ch
            conv = (nn.Conv2d(ch, ch, 3, stride=2) if lvl < len(chs) - 1
                    else None)
            self.down_blocks.append(_Level(resnets, "downsamplers", conv))
        self.mid_block = _Mid(ch, g)
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, 2 * cfg.latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0].conv(F.pad(h, (0, 1, 0, 1)))
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        g = cfg.norm_num_groups
        rev = list(reversed(cfg.block_out_channels))
        ch = rev[0]
        self.conv_in = nn.Conv2d(cfg.latent_channels, ch, 3, padding=1)
        self.mid_block = _Mid(ch, g)
        self.up_blocks = nn.ModuleList()
        for lvl, out_ch in enumerate(rev):
            resnets = []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(VaeResnetBlock(ch, out_ch, g))
                ch = out_ch
            conv = (nn.Conv2d(ch, ch, 3, padding=1) if lvl < len(rev) - 1
                    else None)
            self.up_blocks.append(_Level(resnets, "upsamplers", conv))
        self.conv_norm_out = nn.GroupNorm(g, ch, eps=1e-6)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            for res in blk.resnets:
                h = res(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0].conv(
                    F.interpolate(h, scale_factor=2.0, mode="nearest"))
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class LatentDist(NamedTuple):
    mean: torch.Tensor
    logvar: torch.Tensor


class AutoencoderKL(nn.Module):
    def __init__(self, config: VAEConfig):
        super().__init__()
        self.config = config
        self.encoder = Encoder(config)
        self.decoder = Decoder(config)
        if config.use_quant_conv:
            self.quant_conv = nn.Conv2d(2 * config.latent_channels,
                                        2 * config.latent_channels, 1)
        if config.use_post_quant_conv:
            self.post_quant_conv = nn.Conv2d(config.latent_channels,
                                             config.latent_channels, 1)

    def encode(self, x: torch.Tensor) -> LatentDist:
        """RGB NCHW in [-1, 1] -> posterior (pre-scaling-factor), NCHW."""
        h = self.encoder(x)
        if self.config.use_quant_conv:
            h = self.quant_conv(h)
        mean, logvar = h.chunk(2, dim=1)
        return LatentDist(mean, logvar)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Latents NCHW (pre-scaling-factor) -> RGB NCHW."""
        if self.config.use_post_quant_conv:
            z = self.post_quant_conv(z)
        return self.decoder(z)
