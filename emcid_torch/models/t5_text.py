"""T5 encoder (transformers' ``T5EncoderModel`` names): SD3's third text
encoder, T5-v1.1-XXL.

Pre-RMSNorm layers (a scale, no mean and no bias), attention without the
1/sqrt(d) scale and with a bucketed relative position bias that the first
layer computes and every layer adds, a gated ``gelu_new`` feed-forward, a
final RMSNorm.  SD3 feeds it 256 ids with no attention mask, so padding
attends like any token.  The 256-token attention is plain torch: the
encoder runs forward only, once per edit block.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from emcid_torch.models.configs import T5Config


class T5LayerNorm(nn.Module):
    """RMSNorm: x / rms(x) * weight, the mean square in float32."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        var = x.float().pow(2).mean(-1, keepdim=True)
        x = x * torch.rsqrt(var + self.eps)
        if self.weight.dtype in (torch.float16, torch.bfloat16):
            x = x.to(self.weight.dtype)
        return self.weight * x


def relative_position_bucket(rel: torch.Tensor, num_buckets: int,
                             max_distance: int) -> torch.Tensor:
    """transformers' bidirectional bucket of a relative position (key -
    query): half the buckets per sign, exact below a quarter of them,
    logarithmic up to ``max_distance``."""
    num_buckets //= 2
    out = (rel > 0).long() * num_buckets
    rel = rel.abs()
    exact = num_buckets // 2
    large = exact + (torch.log(rel.float() / exact)
                     / math.log(max_distance / exact)
                     * (num_buckets - exact)).long()
    large = torch.minimum(large, torch.full_like(large, num_buckets - 1))
    return out + torch.where(rel < exact, rel, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.cfg = cfg
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_bias:
            self.relative_attention_bias = nn.Embedding(
                cfg.relative_attention_num_buckets, cfg.num_heads)

    def position_bias(self, n: int, device) -> torch.Tensor:
        """(1, heads, n, n) from this layer's bias table."""
        pos = torch.arange(n, device=device)
        bucket = relative_position_bucket(
            pos[None, :] - pos[:, None],
            self.cfg.relative_attention_num_buckets,
            self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(bucket).permute(2, 0, 1)[None]

    def forward(self, x, bias):
        B, S, _ = x.shape
        h, d = self.cfg.num_heads, self.cfg.d_kv
        q, k, v = (f(x).view(B, S, h, d).transpose(1, 2)
                   for f in (self.q, self.k, self.v))
        scores = q @ k.transpose(-1, -2) + bias
        w = torch.softmax(scores.float(), dim=-1).type_as(scores)
        out = (w @ v).transpose(1, 2).reshape(B, S, h * d)
        return self.o(out)


class _SelfAttentionLayer(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class _DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        h = F.gelu(self.wi_0(x), approximate="tanh") * self.wi_1(x)
        return self.wo(h.to(self.wo.weight.dtype))


class _FFLayer(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([_SelfAttentionLayer(cfg, has_bias),
                                    _FFLayer(cfg)])

    def forward(self, x, bias):
        att, ff = self.layer
        x = x + att.SelfAttention(att.layer_norm(x), bias)
        return x + ff.DenseReluDense(ff.layer_norm(x))


class _Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, i == 0)
                                    for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model,
                                            cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """``T5EncoderModel``: ids (B, S) -> last hidden state (B, S, d_model).
    ``shared`` is the token embedding (the checkpoint's
    ``encoder.embed_tokens.weight`` is the same tensor)."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = _Stack(config)

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        x = self.shared(input_ids)
        blocks = self.encoder.block
        bias = blocks[0].layer[0].SelfAttention.position_bias(
            input_ids.shape[1], input_ids.device).to(x.dtype)
        for blk in blocks:
            x = blk(x, bias)
        return self.encoder.final_layer_norm(x)
