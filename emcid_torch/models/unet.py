"""SD-style conditional UNet (diffusers ``UNet2DConditionModel`` names).

Counterpart of ``emcid_tpu/models/unet.py``.  NCHW inside, as PyTorch and
cuDNN prefer; the JAX package's NHWC layout is kept at the pipeline/engine
boundary.  Attention goes through ``emcid_torch.ops.attention.attention``,
which routes the level-0 spatial self-attention to the flash-v2 kernels
and the level-0 cross-attention to the short-key kernel on the card.

Details kept from the JAX package: transformer-block LayerNorms use
eps=1e-5; resnet GroupNorms eps=1e-5 and the Transformer2D input GroupNorm
eps=1e-6; the downsampler pads (0, 1, 0, 1) then runs a VALID stride-2
conv; ``timestep_embedding`` uses ``flip_sin_to_cos``; and
``attention_head_dim`` is the number of heads (the HF quirk).
The JAX package's ``inject=`` seams and ``sow`` taps serve the UNet edit
modes (ROADMAP M11) and are not ported yet.

Two knobs, read at call time with the JAX package's names and values,
route the norms through the fused kernels: ``EMCID_TPU_FUSED_GN`` = ``1``
(every GroupNorm(+SiLU) site: the resnets' norm1/norm2, each
Transformer2D's input norm, conv_norm_out) or ``geo`` (only the sites on
``ops.groupnorm.geo_wins``); any other value means ``0``.
``EMCID_TPU_FUSED_LN=1`` routes the transformer blocks' norm1/2/3.  The
``nn.GroupNorm``/``nn.LayerNorm`` modules stay as the parameter holders
either way (the JAX ``_GNParams`` twin), so the state dict is the same;
with both knobs off the stock modules run.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from emcid_torch.models.configs import UNetConfig
from emcid_torch.ops.attention import attention
from emcid_torch.ops.groupnorm import group_norm_act
from emcid_torch.ops.layernorm import layer_norm_act


def timestep_embedding(timesteps: torch.Tensor, dim: int,
                       flip_sin_to_cos: bool = True,
                       freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep features (B,) -> (B, dim) f32."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / (half - freq_shift))
    args = timesteps.float()[:, None] * freqs[None, :]
    sin, cos = torch.sin(args), torch.cos(args)
    emb = torch.cat([cos, sin] if flip_sin_to_cos else [sin, cos], dim=-1)
    if dim % 2:
        emb = F.pad(emb, (0, 1))
    return emb


def _fused_gn() -> str:
    """``EMCID_TPU_FUSED_GN``: "0" (stock, the default), "1" (every site)
    or "geo" (the ``geo_wins`` sites); anything else means "0"."""
    v = os.environ.get("EMCID_TPU_FUSED_GN", "0")
    return v if v in ("0", "1", "geo") else "0"


def _fused_ln() -> bool:
    """``EMCID_TPU_FUSED_LN=1`` routes the transformer-block LayerNorms
    through the fused kernels."""
    return os.environ.get("EMCID_TPU_FUSED_LN", "0") == "1"


def _gn_act(norm: nn.GroupNorm, x, act: str = "none"):
    """GroupNorm followed by an optional SiLU: the stock module, or the
    fused kernels with the module's weight and bias."""
    mode = _fused_gn()
    if mode != "0":
        return group_norm_act(x, norm.weight, norm.bias,
                              num_groups=norm.num_groups, eps=norm.eps,
                              act=act, geo_only=mode == "geo")
    h = norm(x)
    return F.silu(h) if act == "silu" else h


def _ln(norm: nn.LayerNorm, x):
    """Transformer-block LayerNorm (eps 1e-5): the stock module, or the
    fused kernels with its weight and bias."""
    if _fused_ln():
        return layer_norm_act(x, norm.weight, norm.bias, eps=norm.eps)
    return norm(x)


class ResnetBlock2D(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, temb_dim: int, groups: int):
        super().__init__()
        self.norm1 = nn.GroupNorm(groups, in_ch, eps=1e-5)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.time_emb_proj = nn.Linear(temb_dim, out_ch)
        self.norm2 = nn.GroupNorm(groups, out_ch, eps=1e-5)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        if in_ch != out_ch:
            self.conv_shortcut = nn.Conv2d(in_ch, out_ch, 1)

    def forward(self, x, temb):
        h = self.conv1(_gn_act(self.norm1, x, "silu"))
        h = h + self.time_emb_proj(F.silu(temb))[:, :, None, None]
        h = self.conv2(_gn_act(self.norm2, h, "silu"))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class CrossAttention(nn.Module):
    """Multi-head attention over (B, N, C) tokens; cross when given a
    context."""

    def __init__(self, dim: int, ctx_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.to_q = nn.Linear(dim, dim, bias=False)
        self.to_k = nn.Linear(ctx_dim, dim, bias=False)
        self.to_v = nn.Linear(ctx_dim, dim, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(dim, dim), nn.Identity()])

    def forward(self, x, context=None):
        ctx = x if context is None else context
        B, N, C = x.shape
        M = ctx.shape[1]
        hd = C // self.num_heads
        q = self.to_q(x).reshape(B, N, self.num_heads, hd)
        k = self.to_k(ctx).reshape(B, M, self.num_heads, hd)
        v = self.to_v(ctx).reshape(B, M, self.num_heads, hd)
        out = attention(q, k, v, scale=hd ** -0.5).reshape(B, N, C)
        return self.to_out[0](out)


class GEGLU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner * 2)

    def forward(self, x):
        h, gate = self.proj(x).chunk(2, dim=-1)
        return h * F.gelu(gate)


class FeedForward(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([GEGLU(dim, dim * 4), nn.Identity(),
                                  nn.Linear(dim * 4, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, ctx_dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn1 = CrossAttention(dim, dim, num_heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.attn2 = CrossAttention(dim, ctx_dim, num_heads)
        self.norm3 = nn.LayerNorm(dim, eps=1e-5)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        x = x + self.attn1(_ln(self.norm1, x))
        x = x + self.attn2(_ln(self.norm2, x), context)
        return x + self.ff(_ln(self.norm3, x))


class Transformer2D(nn.Module):
    def __init__(self, ch: int, ctx_dim: int, num_heads: int, depth: int,
                 groups: int, use_linear_projection: bool):
        super().__init__()
        self.use_linear = use_linear_projection
        self.norm = nn.GroupNorm(groups, ch, eps=1e-6)
        proj = (lambda: nn.Linear(ch, ch)) if use_linear_projection else (
            lambda: nn.Conv2d(ch, ch, 1))
        self.proj_in = proj()
        self.transformer_blocks = nn.ModuleList(
            BasicTransformerBlock(ch, ctx_dim, num_heads) for _ in range(depth))
        self.proj_out = proj()

    def forward(self, x, context):
        B, C, H, W = x.shape
        h = _gn_act(self.norm, x)
        if self.use_linear:
            h = self.proj_in(h.permute(0, 2, 3, 1).reshape(B, H * W, C))
        else:
            h = self.proj_in(h).permute(0, 2, 3, 1).reshape(B, H * W, C)
        for blk in self.transformer_blocks:
            h = blk(h, context)
        if self.use_linear:
            h = self.proj_out(h).reshape(B, H, W, C).permute(0, 3, 1, 2)
        else:
            h = self.proj_out(h.reshape(B, H, W, C).permute(0, 3, 1, 2))
        return h + x


class Downsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample2D(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class _Block(nn.Module):
    """One UNet level: resnets (+ attentions) (+ a resampler)."""

    def __init__(self, resnets, attentions, resampler_name=None,
                 resampler=None):
        super().__init__()
        self.resnets = nn.ModuleList(resnets)
        if attentions:
            self.attentions = nn.ModuleList(attentions)
        if resampler is not None:
            setattr(self, resampler_name, nn.ModuleList([resampler]))


class _TimeEmbedding(nn.Module):
    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t):
        return self.linear_2(F.silu(self.linear_1(t)))


class UNetOutput(NamedTuple):
    sample: torch.Tensor


class UNet2DCondition(nn.Module):
    """``forward(latents NCHW, timesteps (B,), context (B, S, D))`` ->
    eps prediction NCHW."""

    def __init__(self, config: UNetConfig):
        super().__init__()
        if config.addition_embed_type is not None:
            raise NotImplementedError("SDXL UNet (ROADMAP M10)")
        self.config = cfg = config
        ch0 = cfg.block_out_channels[0]
        temb_dim = ch0 * 4
        groups = cfg.norm_num_groups
        ctx_dim = cfg.cross_attention_dim
        n = len(cfg.block_out_channels)
        self.conv_in = nn.Conv2d(cfg.in_channels, ch0, 3, padding=1)
        self.time_embedding = _TimeEmbedding(ch0, temb_dim)

        def tfm(lvl, ch):
            return Transformer2D(ch, ctx_dim, cfg.attention_head_dim[lvl],
                                 cfg.transformer_layers_per_block[lvl],
                                 groups, use_linear_projection=False)

        self.down_blocks = nn.ModuleList()
        skip_ch = [ch0]
        ch = ch0
        for lvl, bt in enumerate(cfg.down_block_types):
            out_ch = cfg.block_out_channels[lvl]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block):
                resnets.append(ResnetBlock2D(ch, out_ch, temb_dim, groups))
                ch = out_ch
                if bt == "CrossAttnDownBlock2D":
                    attns.append(tfm(lvl, ch))
                skip_ch.append(ch)
            down = None
            if lvl < n - 1:
                down = Downsample2D(ch)
                skip_ch.append(ch)
            self.down_blocks.append(_Block(resnets, attns, "downsamplers", down))

        mid = cfg.block_out_channels[-1]
        self.mid_block = _Block(
            [ResnetBlock2D(mid, mid, temb_dim, groups),
             ResnetBlock2D(mid, mid, temb_dim, groups)],
            [tfm(n - 1, mid)])

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(cfg.block_out_channels))
        for lvl, bt in enumerate(cfg.up_block_types):
            out_ch = rev[lvl]
            resnets, attns = [], []
            for _ in range(cfg.layers_per_block + 1):
                resnets.append(ResnetBlock2D(ch + skip_ch.pop(), out_ch,
                                             temb_dim, groups))
                ch = out_ch
                if bt == "CrossAttnUpBlock2D":
                    attns.append(tfm(n - 1 - lvl, ch))
            up = Upsample2D(ch) if lvl < n - 1 else None
            self.up_blocks.append(_Block(resnets, attns, "upsamplers", up))

        self.conv_norm_out = nn.GroupNorm(groups, ch, eps=1e-5)
        self.conv_out = nn.Conv2d(ch, cfg.out_channels, 3, padding=1)

    def forward(self, sample: torch.Tensor, timesteps: torch.Tensor,
                encoder_hidden_states: torch.Tensor) -> UNetOutput:
        cfg = self.config
        ctx = encoder_hidden_states
        if timesteps.dim() == 0:
            timesteps = timesteps[None]
        timesteps = timesteps.expand(sample.shape[0])
        t_feat = timestep_embedding(timesteps, cfg.block_out_channels[0],
                                    cfg.flip_sin_to_cos, cfg.freq_shift)
        temb = self.time_embedding(t_feat.to(sample.dtype))

        h = self.conv_in(sample)
        skips = [h]
        for blk in self.down_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                h = res(h, temb)
                if attns is not None:
                    h = attns[j](h, ctx)
                skips.append(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
                skips.append(h)

        h = self.mid_block.resnets[0](h, temb)
        h = self.mid_block.attentions[0](h, ctx)
        h = self.mid_block.resnets[1](h, temb)

        for blk in self.up_blocks:
            attns = getattr(blk, "attentions", None)
            for j, res in enumerate(blk.resnets):
                h = res(torch.cat([h, skips.pop()], dim=1), temb)
                if attns is not None:
                    h = attns[j](h, ctx)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)

        h = self.conv_out(_gn_act(self.conv_norm_out, h, "silu"))
        return UNetOutput(sample=h)
