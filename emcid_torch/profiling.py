"""Step-time and MFU accounting: analytic FLOP counts of the UNet forward
and of one Stage-1 step, and ``StepReport``.

Counterpart of ``emcid_tpu/profiling.py``.  The counts are useful work:
attention scores unpadded, GroupNorm, SiLU and the time/added-condition
MLPs (<1%) ignored.  A run divides them by its measured seconds for
TFLOP/s, and ``StepReport.mfu`` by the card's peak, ``PEAK_TFLOPS``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

# dense bf16 tensor-core peak of one NVIDIA H100 SXM (data sheet)
PEAK_TFLOPS = 989.0


def _conv(cin: int, cout: int, hw: int, k: int = 3) -> float:
    return 2.0 * k * k * cin * cout * hw * hw


def _lin(n: int, cin: int, cout: int) -> float:
    return 2.0 * n * cin * cout


def _resnet(cin: int, cout: int, hw: int, temb_dim: int) -> float:
    f = _conv(cin, cout, hw) + _conv(cout, cout, hw) + 2.0 * temb_dim * cout
    if cin != cout:
        f += _conv(cin, cout, hw, k=1)  # conv_shortcut
    return f


def _transformer(c: int, hw: int, depth: int, ctx_len: int,
                 ctx_dim: int) -> float:
    """Transformer2D: proj in/out + depth x (self-attention,
    cross-attention, GEGLU feed-forward)."""
    N = hw * hw
    f = 2.0 * _lin(N, c, c)  # proj_in + proj_out
    per = (
        4.0 * _lin(N, c, c) + 2.0 * 2.0 * N * N * c              # self
        + 2.0 * _lin(N, c, c) + 2.0 * _lin(ctx_len, ctx_dim, c)  # cross qo/kv
        + 2.0 * 2.0 * N * ctx_len * c                            # cross scores
        + _lin(N, c, 8 * c) + _lin(N, 4 * c, c)                  # GEGLU FF
    )
    return f + depth * per


def unet_fwd_flops(config, batch: int, latent_hw: Optional[int] = None,
                   context_len: int = 77) -> float:
    """FLOPs of one UNet forward over ``batch`` latents of side
    ``latent_hw`` (default the config's ``sample_size``), walked from the
    config's levels as ``models/unet.py`` builds them."""
    s = latent_hw or config.sample_size
    ch = config.block_out_channels
    L = config.layers_per_block
    n_levels = len(ch)
    temb_dim = 4 * ch[0]
    ctx_dim = config.cross_attention_dim
    tdepth = config.transformer_layers_per_block

    f = _conv(config.in_channels, ch[0], s)  # conv_in
    skips = [ch[0]]
    hw = s
    cur = ch[0]
    for lvl, block_type in enumerate(config.down_block_types):
        out_ch = ch[lvl]
        has_attn = block_type == "CrossAttnDownBlock2D"
        for _ in range(L):
            f += _resnet(cur, out_ch, hw, temb_dim)
            cur = out_ch
            if has_attn:
                f += _transformer(out_ch, hw, tdepth[lvl], context_len,
                                  ctx_dim)
            skips.append(out_ch)
        if lvl < n_levels - 1:
            hw //= 2
            f += _conv(out_ch, out_ch, hw)  # strided downsample
            skips.append(out_ch)

    mid_ch = ch[-1]
    f += 2.0 * _resnet(mid_ch, mid_ch, hw, temb_dim)
    f += _transformer(mid_ch, hw, tdepth[-1], context_len, ctx_dim)

    rev_ch = list(reversed(ch))
    for lvl, block_type in enumerate(config.up_block_types):
        out_ch = rev_ch[lvl]
        has_attn = block_type == "CrossAttnUpBlock2D"
        for _ in range(L + 1):
            skip = skips.pop()
            f += _resnet(cur + skip, out_ch, hw, temb_dim)
            cur = out_ch
            if has_attn:
                f += _transformer(out_ch, hw, tdepth[n_levels - 1 - lvl],
                                  context_len, ctx_dim)
        if lvl < n_levels - 1:
            hw *= 2
            f += _conv(out_ch, out_ch, hw)  # post-upsample conv
    f += _conv(ch[0], config.out_channels, s)  # conv_out
    return f * batch


def stage1_step_flops(config, n_concepts: int, n_prompts: int,
                      latent_hw: Optional[int] = None,
                      eps_dest_pooled: bool = False) -> float:
    """FLOPs of one Stage-1 step for a block: three UNet forwards' worth
    (the edited forward, its backward into the input only, ~1 forward, and
    the eps_dest forward; two with ``eps_dest_pooled``, where the eps_dest
    forwards were made once over a pool).  Text-encoder work (<2%) is
    ignored."""
    fwd_equiv = 2.0 if eps_dest_pooled else 3.0
    return fwd_equiv * unet_fwd_flops(config, n_concepts * n_prompts,
                                      latent_hw)


@dataclass
class StepReport:
    """ms per step, TFLOP/s and MFU of ``steps`` steps of
    ``flops_per_step`` in ``seconds``."""

    seconds: float
    steps: int
    flops_per_step: float

    @property
    def ms_per_step(self) -> float:
        return self.seconds / max(self.steps, 1) * 1e3

    @property
    def tflops(self) -> float:
        return self.flops_per_step * self.steps / self.seconds / 1e12

    @property
    def mfu(self) -> float:
        return self.tflops / PEAK_TFLOPS

    def __str__(self) -> str:
        return (f"{self.ms_per_step:.0f} ms/step, "
                f"{self.tflops:.1f} TFLOP/s ({self.mfu * 100:.0f}% MFU)")
