"""The benchmark's fixed arithmetic: the card's published peaks, the UNet's
analytic FLOP count, and the least time of an attention kernel's launch.

``unet_fwd_flops`` is a frozen copy of ``emcid_torch.profiling``'s count
(walked from the configuration's ``unet`` group): useful work, attention
scores unpadded, GroupNorm, SiLU and the time-embedding MLPs ignored.  A
test pins the copy to the program's own values.
"""

from __future__ import annotations

from typing import Dict, Optional

from portbench.reference.unet import per_level

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores and HBM3
PEAK_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12


def _conv(cin, cout, hw, k=3):
    return 2.0 * k * k * cin * cout * hw * hw


def _lin(n, cin, cout):
    return 2.0 * n * cin * cout


def _resnet(cin, cout, hw, temb):
    f = _conv(cin, cout, hw) + _conv(cout, cout, hw) + 2.0 * temb * cout
    return f + (_conv(cin, cout, hw, k=1) if cin != cout else 0.0)


def _transformer(c, hw, depth, ctx_len, ctx_dim):
    N = hw * hw
    per = (4.0 * _lin(N, c, c) + 2.0 * 2.0 * N * N * c
           + 2.0 * _lin(N, c, c) + 2.0 * _lin(ctx_len, ctx_dim, c)
           + 2.0 * 2.0 * N * ctx_len * c
           + _lin(N, c, 8 * c) + _lin(N, 4 * c, c))
    return 2.0 * _lin(N, c, c) + depth * per


def unet_fwd_flops(cfg: Dict, batch: int, latent_hw: Optional[int] = None,
                   context_len: int = 77) -> float:
    """FLOPs of one UNet forward over ``batch`` latents of side
    ``latent_hw`` (default the configuration's ``sample_size``)."""
    s = latent_hw or cfg["sample_size"]
    ch = cfg["block_out_channels"]
    L = cfg["layers_per_block"]
    n = len(ch)
    temb = 4 * ch[0]
    ctx = cfg["cross_attention_dim"]
    depth = per_level(cfg, "transformer_layers_per_block", 1)
    f = _conv(cfg["in_channels"], ch[0], s)
    skips, hw, cur = [ch[0]], s, ch[0]
    for lvl, kind in enumerate(cfg["down_block_types"]):
        for _ in range(L):
            f += _resnet(cur, ch[lvl], hw, temb)
            cur = ch[lvl]
            if kind == "CrossAttnDownBlock2D":
                f += _transformer(cur, hw, depth[lvl], context_len, ctx)
            skips.append(cur)
        if lvl < n - 1:
            hw //= 2
            f += _conv(cur, cur, hw)
            skips.append(cur)
    f += 2.0 * _resnet(ch[-1], ch[-1], hw, temb)
    f += _transformer(ch[-1], hw, depth[-1], context_len, ctx)
    for lvl, kind in enumerate(cfg["up_block_types"]):
        out = ch[n - 1 - lvl]
        for _ in range(L + 1):
            f += _resnet(cur + skips.pop(), out, hw, temb)
            cur = out
            if kind == "CrossAttnUpBlock2D":
                f += _transformer(out, hw, depth[n - 1 - lvl], context_len,
                                  ctx)
        if lvl < n - 1:
            hw *= 2
            f += _conv(out, out, hw)
    f += _conv(ch[0], cfg["out_channels"], s)
    return f * batch


def sampler_evals(sampler: str, steps: int) -> int:
    """UNet evaluations of a sampler run: PNDM's skipped warm-up evaluates
    its second timestep twice."""
    return steps + 1 if sampler == "pndm" and steps > 1 else steps


def guided_flops(cfg: Dict, images: int, latent_hw: int, sampler: str,
                 steps: int, guided_steps: Optional[int] = None) -> float:
    """UNet FLOPs of a sampler run over ``images``: the guided evaluations
    at twice the batch, the rest (CFG interval) at the batch."""
    evals = sampler_evals(sampler, steps)
    guided = evals if guided_steps is None else min(
        evals, guided_steps + (evals - steps))
    fwd = unet_fwd_flops(cfg, images, latent_hw)
    return fwd * (2 * guided + (evals - guided))


# -- attention kernels ---------------------------------------------------------

# work per launch, in units of B*H*N*M*D products (two FLOPs each): K1 S and
# P.V; K2 S, dP and dQ; K3 S, dP, dV and dK; K4 S and P.V
PRODUCTS = {"K1": 2, "K2": 3, "K3": 4, "K4": 2}


def attn_bound_s(kernel: str, B: int, N: int, M: int, H: int, D: int,
                 itemsize: int) -> float:
    """Least seconds of one launch: the larger of its FLOPs over the bf16
    peak and its bytes over HBM's, each input read once and each output
    written once (the f32 log-sum-exp and row-delta vectors included)."""
    flops = 2.0 * PRODUCTS[kernel] * B * H * N * M * D
    q = B * N * H * D * itemsize
    kv = B * M * H * D * itemsize
    rows = B * H * N * 4
    nbytes = {"K1": q + 2 * kv + q + rows,
              "K2": q + 2 * kv + q + 2 * rows + q,
              "K3": q + 2 * kv + q + 2 * rows + 2 * kv,
              "K4": q + 2 * kv + q}[kernel]
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
