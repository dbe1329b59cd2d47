"""Conditional UNet (diffusers ``UNet2DConditionModel`` names), plain, NCHW.

``cfg`` is the configuration file's ``unet`` group, with diffusers'
keys.  ``attention_head_dim`` counts heads (diffusers' convention for
these models).  ResNet GroupNorms use ``norm_eps``, the Transformer2D
input GroupNorm 1e-6, the transformer LayerNorms 1e-5.  The downsampler
pads the bottom and right edge by one and runs its stride-2 convolution
without padding (see ``PERF.md``: the published ``downsample_padding`` of
1 pads every edge; this is the port's and the JAX package's convention,
kept so that the reference states the same function).  SDXL's
``text_time`` addition embeds the pooled text and the six size
conditions.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.ops import (
    Prec,
    attention,
    conv,
    group_norm,
    layer_norm,
    linear,
    timestep_features,
)


def per_level(cfg: Dict, key: str, default) -> list:
    v = cfg.get(key, default)
    n = len(cfg["block_out_channels"])
    return [v] * n if isinstance(v, int) else list(v)


def _resnet(p: Prec, name: str, x, temb, groups: int, eps: float):
    h = conv(p, name + ".conv1", F.silu(group_norm(p, name + ".norm1", x,
                                                   groups, eps)))
    h = h + linear(p, name + ".time_emb_proj", F.silu(temb))[:, :, None, None]
    h = conv(p, name + ".conv2", F.silu(group_norm(p, name + ".norm2", h,
                                                   groups, eps)))
    if p.has(name + ".conv_shortcut.weight"):
        x = conv(p, name + ".conv_shortcut", x)
    return x + h


def _attn(p: Prec, name: str, x, ctx, heads: int):
    B, N, C = x.shape
    ctx = x if ctx is None else ctx
    q = linear(p, name + ".to_q", x).reshape(B, N, heads, -1)
    k = linear(p, name + ".to_k", ctx).reshape(B, ctx.shape[1], heads, -1)
    v = linear(p, name + ".to_v", ctx).reshape(B, ctx.shape[1], heads, -1)
    return linear(p, name + ".to_out.0",
                  attention(p, q, k, v).reshape(B, N, C))


def _transformer(p: Prec, name: str, x, ctx, heads: int, depth: int,
                 groups: int, linear_proj: bool):
    B, C, H, W = x.shape
    h = group_norm(p, name + ".norm", x, groups, 1e-6)
    if linear_proj:
        h = linear(p, name + ".proj_in",
                   h.permute(0, 2, 3, 1).reshape(B, H * W, C))
    else:
        h = conv(p, name + ".proj_in", h).permute(0, 2, 3, 1).reshape(
            B, H * W, C)
    for d in range(depth):
        bn = f"{name}.transformer_blocks.{d}"
        h = h + _attn(p, bn + ".attn1", layer_norm(p, bn + ".norm1", h),
                      None, heads)
        h = h + _attn(p, bn + ".attn2", layer_norm(p, bn + ".norm2", h),
                      ctx, heads)
        a, gate = linear(p, bn + ".ff.net.0.proj",
                         layer_norm(p, bn + ".norm3", h)).chunk(2, dim=-1)
        h = h + linear(p, bn + ".ff.net.2", a * F.gelu(gate))
    if linear_proj:
        h = linear(p, name + ".proj_out", h).reshape(B, H, W, C).permute(
            0, 3, 1, 2)
    else:
        h = conv(p, name + ".proj_out",
                 h.reshape(B, H, W, C).permute(0, 3, 1, 2))
    return h + x


def unet(p: Prec, cfg: Dict, x: torch.Tensor, t: torch.Tensor,
         ctx: torch.Tensor, added: Optional[Dict[str, torch.Tensor]] = None
         ) -> torch.Tensor:
    """eps prediction (B, C, h, w) of latents ``x`` (B, C, h, w) at integer
    timesteps ``t`` (B,) under context ``ctx`` (B, S, D)."""
    chs = cfg["block_out_channels"]
    n = len(chs)
    L = cfg["layers_per_block"]
    groups = cfg["norm_num_groups"]
    eps = cfg.get("norm_eps", 1e-5)
    heads = per_level(cfg, "attention_head_dim", 8)
    depth = per_level(cfg, "transformer_layers_per_block", 1)
    lin = bool(cfg.get("use_linear_projection", False))
    flip, shift = cfg.get("flip_sin_to_cos", True), cfg.get("freq_shift", 0)
    t = t.expand(x.shape[0])
    temb = timestep_features(t, chs[0], flip, shift)
    temb = linear(p, "time_embedding.linear_2", F.silu(
        linear(p, "time_embedding.linear_1", temb)))
    if cfg.get("addition_embed_type") == "text_time":
        tid = timestep_features(added["time_ids"].reshape(-1),
                                cfg["addition_time_embed_dim"], flip, shift)
        a = torch.cat([added["text_embeds"].float(),
                       tid.reshape(x.shape[0], -1)], -1)
        temb = temb + linear(p, "add_embedding.linear_2", F.silu(
            linear(p, "add_embedding.linear_1", a)))

    h = conv(p, "conv_in", x.float())
    skips = [h]
    for lvl, kind in enumerate(cfg["down_block_types"]):
        for j in range(L):
            h = _resnet(p, f"down_blocks.{lvl}.resnets.{j}", h, temb, groups,
                        eps)
            if kind.startswith("CrossAttn"):
                h = _transformer(p, f"down_blocks.{lvl}.attentions.{j}", h,
                                 ctx, heads[lvl], depth[lvl], groups, lin)
            skips.append(h)
        if lvl < n - 1:
            h = conv(p, f"down_blocks.{lvl}.downsamplers.0.conv",
                     F.pad(h, (0, 1, 0, 1)), stride=2, padding=0)
            skips.append(h)
    h = _resnet(p, "mid_block.resnets.0", h, temb, groups, eps)
    h = _transformer(p, "mid_block.attentions.0", h, ctx, heads[-1],
                     depth[-1], groups, lin)
    h = _resnet(p, "mid_block.resnets.1", h, temb, groups, eps)
    for lvl, kind in enumerate(cfg["up_block_types"]):
        src = n - 1 - lvl
        for j in range(L + 1):
            h = _resnet(p, f"up_blocks.{lvl}.resnets.{j}",
                        torch.cat([h, skips.pop()], 1), temb, groups, eps)
            if kind.startswith("CrossAttn"):
                h = _transformer(p, f"up_blocks.{lvl}.attentions.{j}", h,
                                 ctx, heads[src], depth[src], groups, lin)
        if lvl < n - 1:
            h = conv(p, f"up_blocks.{lvl}.upsamplers.0.conv",
                     F.interpolate(h, scale_factor=2.0, mode="nearest"))
    h = F.silu(group_norm(p, "conv_norm_out", h, groups, eps))
    return conv(p, "conv_out", h)
