"""SD3's denoiser, the MMDiT (diffusers' ``SD3Transformer2DModel`` names),
with SD3.5's MMDiT-X dual attention.

The latent is cut into 2 x 2 patches and embedded with a cropped 2-D
sin-cos table (``PatchEmbed``); the text context is projected to the
model width.  Every ``JointTransformerBlock`` keeps two token streams,
image and text, each with its own adaLN-Zero modulation from
e = timestep MLP + pooled-text MLP:

* modulation: (shift, scale, gate) of the attention and of the MLP from
  Linear(SiLU(e)), and in dual layers a third triple for the image-only
  attention; x^ = LN(x) (1 + scale) + shift (LN without affine, eps
  1e-6);
* q, k, v of each stream with bias, an RMSNorm over each head's values
  of q and k per stream, one softmax(Q K^T / sqrt(d)) V over both streams
  together (image tokens first), split again;
* image: x += gate * out(o_x); in dual layers also x += gate2 *
  out2(SelfAttn(x^2)); then x += gate_mlp * FF(LN(x)(1 + scale_mlp) +
  shift_mlp), FF = 4x with tanh-GELU;
* text: the same without the dual attention; the last block
  (``context_pre_only``) keeps only its (scale, shift) norm and its q, k
  and v, and returns no text stream.

Then an adaLN-continuous norm, a Linear to p * p * out_channels, and the
patches folded back.  Every attention goes through ``ops.attention``: on
the card at SD3's 4096 image + 333 text tokens, K1-K3's routes at head
dim 64.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from emcid_torch.models.configs import MMDiTConfig
from emcid_torch.models.t5_text import T5LayerNorm as RMSNorm
from emcid_torch.ops.attention import attention


def sincos_1d(dim: int, pos: np.ndarray) -> np.ndarray:
    """diffusers' ``get_1d_sincos_pos_embed_from_grid`` (float64)."""
    omega = np.arange(dim // 2, dtype=np.float64) / (dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def sincos_2d(dim: int, grid_size: int, base_size: int) -> np.ndarray:
    """diffusers' ``get_2d_sincos_pos_embed`` at interpolation scale 1:
    (grid_size^2, dim), the first half of the channels from the w
    coordinate and the second from the h coordinate, each scaled by
    base_size / grid_size in float32."""
    g = (np.arange(grid_size, dtype=np.float32)
         / np.float32(grid_size / base_size))
    gw, gh = np.meshgrid(g, g)
    return np.concatenate([sincos_1d(dim // 2, gw), sincos_1d(dim // 2, gh)],
                          axis=1)


def pos_table(cfg: MMDiTConfig) -> torch.Tensor:
    """The patch position table (1, max^2, D), float32."""
    return torch.from_numpy(sincos_2d(
        cfg.inner_dim, cfg.pos_embed_max_size,
        cfg.sample_size // cfg.patch_size)).float()[None]


class PatchEmbed(nn.Module):
    """Conv patchify + the centre crop of a ``pos_embed_max_size``^2 table
    (the persistent buffer ``pos_embed``, (1, max^2, D))."""

    def __init__(self, cfg: MMDiTConfig):
        super().__init__()
        D, p = cfg.inner_dim, cfg.patch_size
        self.patch_size = p
        self.max_size = cfg.pos_embed_max_size
        self.proj = nn.Conv2d(cfg.in_channels, D, p, stride=p)
        self.register_buffer("pos_embed", pos_table(cfg))

    def forward(self, x):
        h, w = x.shape[-2] // self.patch_size, x.shape[-1] // self.patch_size
        if max(h, w) > self.max_size:
            raise ValueError(f"{h} x {w} patches exceed the {self.max_size}"
                             " table")
        out = self.proj(x).flatten(2).transpose(1, 2)
        top, left = (self.max_size - h) // 2, (self.max_size - w) // 2
        pos = self.pos_embed.reshape(1, self.max_size, self.max_size, -1)
        pos = pos[:, top:top + h, left:left + w].reshape(1, h * w, -1)
        return (out + pos).to(out.dtype)


def timestep_proj(t: torch.Tensor, dim: int = 256) -> torch.Tensor:
    """diffusers' ``Timesteps(dim, flip_sin_to_cos=True,
    downscale_freq_shift=0)``: [cos, sin] of t * 10000^(-i / half)."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], -1)


class _MLP2(nn.Module):
    """linear_1, SiLU, linear_2 (``TimestepEmbedding`` and
    ``PixArtAlphaTextProjection`` alike)."""

    def __init__(self, n_in: int, n_out: int):
        super().__init__()
        self.linear_1 = nn.Linear(n_in, n_out)
        self.linear_2 = nn.Linear(n_out, n_out)

    def forward(self, x):
        return self.linear_2(F.silu(self.linear_1(x)))


class CombinedTimestepTextProjEmbeddings(nn.Module):
    def __init__(self, dim: int, pooled_dim: int):
        super().__init__()
        self.timestep_embedder = _MLP2(256, dim)
        self.text_embedder = _MLP2(pooled_dim, dim)

    def forward(self, t, pooled):
        te = self.timestep_embedder(timestep_proj(t).to(pooled.dtype))
        return te + self.text_embedder(pooled)


def _ln(x):
    return F.layer_norm(x, (x.shape[-1],), eps=1e-6)


class AdaLayerNormZero(nn.Module):
    """Linear(SiLU(e)) -> ``n`` vectors of width D, in diffusers' chunk
    order: (shift, scale, gate) of the attention, then of the MLP, then in
    MMDiT-X's ``SD35AdaLayerNormZeroX`` (n = 9) of the second attention."""

    def __init__(self, dim: int, n: int = 6):
        super().__init__()
        self.n = n
        self.linear = nn.Linear(dim, n * dim)

    def forward(self, x, emb):
        mods = self.linear(F.silu(emb)).chunk(self.n, dim=1)
        h = _ln(x)
        out = [h * (1 + mods[1][:, None]) + mods[0][:, None], *mods[2:6]]
        if self.n == 9:
            out += [h * (1 + mods[7][:, None]) + mods[6][:, None], mods[8]]
        return out


class AdaLayerNormContinuous(nn.Module):
    """LN(x) (1 + scale) + shift with (scale, shift) = Linear(SiLU(e))."""

    def __init__(self, dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, 2 * dim)

    def forward(self, x, emb):
        scale, shift = self.linear(F.silu(emb).to(x.dtype)).chunk(2, dim=1)
        return _ln(x) * (1 + scale[:, None]) + shift[:, None]


class _GELU(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, inner)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    """``net.0.proj`` (D -> 4D, tanh-GELU), ``net.2`` (4D -> D)."""

    def __init__(self, dim: int):
        super().__init__()
        self.net = nn.ModuleList([_GELU(dim, 4 * dim), nn.Identity(),
                                  nn.Linear(4 * dim, dim)])

    def forward(self, x):
        return self.net[2](self.net[0](x))


class Attention(nn.Module):
    """diffusers' ``Attention`` as SD3 builds it: q, k, v, out with bias,
    per-head RMSNorm of q and k; with ``joint`` the text stream's
    ``add_{q,k,v}_proj``, its norms and (unless ``context_pre_only``)
    ``to_add_out``."""

    def __init__(self, cfg: MMDiTConfig, joint: bool,
                 context_pre_only: bool = False):
        super().__init__()
        D, d = cfg.inner_dim, cfg.attention_head_dim
        self.heads, self.head_dim = cfg.num_attention_heads, d
        self.joint, self.context_pre_only = joint, context_pre_only
        qk = cfg.qk_norm
        if qk not in (None, "rms_norm"):
            raise NotImplementedError(f"qk_norm={qk!r}")
        for n in ("to_q", "to_k", "to_v"):
            setattr(self, n, nn.Linear(D, D))
        if qk:
            self.norm_q, self.norm_k = RMSNorm(d, 1e-6), RMSNorm(d, 1e-6)
        if joint:
            for n in ("add_q_proj", "add_k_proj", "add_v_proj"):
                setattr(self, n, nn.Linear(D, D))
            if qk:
                self.norm_added_q = RMSNorm(d, 1e-6)
                self.norm_added_k = RMSNorm(d, 1e-6)
        self.to_out = nn.ModuleList([nn.Linear(D, D), nn.Identity()])
        if joint and not context_pre_only:
            self.to_add_out = nn.Linear(D, D)

    def _qkv(self, x, names, norms):
        B, N, _ = x.shape
        q, k, v = (getattr(self, n)(x).view(B, N, self.heads, self.head_dim)
                   for n in names)
        if hasattr(self, norms[0]):
            q, k = getattr(self, norms[0])(q), getattr(self, norms[1])(k)
        return q, k, v

    def forward(self, x, ctx: Optional[torch.Tensor] = None):
        B, N, _ = x.shape
        q, k, v = self._qkv(x, ("to_q", "to_k", "to_v"), ("norm_q", "norm_k"))
        if ctx is not None:
            qc, kc, vc = self._qkv(ctx, ("add_q_proj", "add_k_proj",
                                         "add_v_proj"),
                                   ("norm_added_q", "norm_added_k"))
            q, k, v = (torch.cat(a, dim=1) for a in ((q, qc), (k, kc),
                                                     (v, vc)))
        o = attention(q, k, v, scale=self.head_dim ** -0.5)
        o = o.reshape(B, o.shape[1], -1).to(q.dtype)
        out = self.to_out[0](o[:, :N])
        if ctx is None:
            return out
        oc = o[:, N:]
        return out, (None if self.context_pre_only else self.to_add_out(oc))


class JointTransformerBlock(nn.Module):
    def __init__(self, cfg: MMDiTConfig, context_pre_only: bool, dual: bool):
        super().__init__()
        D = cfg.inner_dim
        self.context_pre_only, self.dual = context_pre_only, dual
        self.norm1 = AdaLayerNormZero(D, 9 if dual else 6)
        self.norm1_context = (AdaLayerNormContinuous(D) if context_pre_only
                              else AdaLayerNormZero(D))
        self.attn = Attention(cfg, joint=True,
                              context_pre_only=context_pre_only)
        if dual:
            self.attn2 = Attention(cfg, joint=False)
        self.ff = FeedForward(D)
        if not context_pre_only:
            self.ff_context = FeedForward(D)

    def forward(self, x, ctx, temb):
        nx, gate, shift_mlp, scale_mlp, gate_mlp, *dual = self.norm1(x, temb)
        if self.context_pre_only:
            nc = self.norm1_context(ctx, temb)
        else:
            nc, c_gate, c_shift, c_scale, c_gate_mlp = self.norm1_context(
                ctx, temb)
        a, ac = self.attn(nx, nc)
        x = x + gate[:, None] * a
        if self.dual:
            nx2, gate2 = dual
            x = x + gate2[:, None] * self.attn2(nx2)
        h = _ln(x) * (1 + scale_mlp[:, None]) + shift_mlp[:, None]
        x = x + gate_mlp[:, None] * self.ff(h)
        if self.context_pre_only:
            return None, x
        ctx = ctx + c_gate[:, None] * ac
        h = _ln(ctx) * (1 + c_scale[:, None]) + c_shift[:, None]
        return ctx + c_gate_mlp[:, None] * self.ff_context(h), x


class MMDiT(nn.Module):
    """``SD3Transformer2DModel``: (latents (B, c, H, W), timesteps (B,)
    float in [0, 1000], context (B, S, joint_attention_dim), pooled (B,
    pooled_projection_dim)) -> the velocity (B, c, H, W)."""

    def __init__(self, config: MMDiTConfig):
        super().__init__()
        self.config = config
        D, L = config.inner_dim, config.num_layers
        self.pos_embed = PatchEmbed(config)
        self.time_text_embed = CombinedTimestepTextProjEmbeddings(
            D, config.pooled_projection_dim)
        self.context_embedder = nn.Linear(config.joint_attention_dim,
                                          config.caption_projection_dim)
        self.transformer_blocks = nn.ModuleList([
            JointTransformerBlock(config, context_pre_only=i == L - 1,
                                  dual=i in config.dual_attention_layers)
            for i in range(L)])
        self.norm_out = AdaLayerNormContinuous(D)
        p = config.patch_size
        self.proj_out = nn.Linear(D, p * p * config.out_channels)

    def forward(self, x, t, ctx, pooled):
        H, W = x.shape[-2:]
        h = self.pos_embed(x)
        if t.dim() == 0:
            t = t.expand(x.shape[0])
        temb = self.time_text_embed(t, pooled)
        c = self.context_embedder(ctx)
        for blk in self.transformer_blocks:
            c, h = blk(h, c, temb)
        h = self.proj_out(self.norm_out(h, temb))
        p, oc = self.config.patch_size, self.config.out_channels
        h = h.reshape(x.shape[0], H // p, W // p, p, p, oc)
        return torch.einsum("nhwpqc->nchpwq", h).reshape(
            x.shape[0], oc, H, W)
