"""Fused GroupNorm(+SiLU) with a kernel backward (K5f, K5b).

Counterpart of ``emcid_tpu/ops/groupnorm.py``.  Two hand-written CUDA
kernels (``emcid_torch/csrc/groupnorm.cu``) replace the two Pallas
kernels:

* K5f ``gn_fwd`` — GroupNorm and the optional SiLU in one pass over each
  (batch, group) span; returns y and the per-group (mean, rstd) as
  (B, 2, G) float32;
* K5b ``gn_bwd`` — dx (the SiLU derivative and both group reductions) from
  the saved statistics, and dgamma/dbeta summed over the batch inside the
  same launch (the last block to finish sums the blocks' (B, 2 C) partial
  rows in order; CUDA blocks have no order to carry a sum across, as the
  TPU grid does).  Two routes, one C entry point each, picked by
  ``gn_bwd_route`` and counted in ``_build.ROUTES``: ``resident`` (the
  span's x and g brought into shared memory once by TMA bulk copies) and
  ``stream`` (spans larger than one block's shared memory).

The math is flax/torch GroupNorm: contiguous channel groups, float32
statistics, the fast variance max(E[x^2] - E[x]^2, 0), normalise and
activate in float32, one rounding to the output type.

Layout: channels first, (B, C, *spatial), as the port's NCHW UNet and
``F.group_norm`` take it (the JAX package's functions take (..., C)); the
statistics (B, 2, G) are the same in both.  The JAX package's VMEM
chunking (``fits``, ``_pick_chunk``, ``_slot``, ``_row_chunk``) and its
``_bwd_reference`` fallback exist for the TPU's memory and lane rules and
are not ported: the CUDA kernels take every shape with C % G == 0.

Each wrapper computes its plain PyTorch version below on a CPU tensor and
launches its kernel or raises on a CUDA tensor.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from emcid_torch.ops import _build

_ACTS = {"none": 0, "silu": 1}


def _dims(x: torch.Tensor, num_groups: int):
    if x.dim() < 2:
        raise ValueError(f"expected (B, C, ...) input, got {tuple(x.shape)}")
    B, C = x.shape[:2]
    if C % num_groups:
        raise ValueError(f"{C} channels do not split into {num_groups} groups")
    return B, C, math.prod(x.shape[2:])


def _act_code(act: str) -> int:
    if act not in _ACTS:
        raise ValueError(f"act must be one of {sorted(_ACTS)}, got {act!r}")
    return _ACTS[act]


# ---------------------------------------------------------------------------
# plain versions (the kernels' math)
# ---------------------------------------------------------------------------


def gn_fwd_plain(x, scale, bias, num_groups: int, eps: float,
                 act: str = "none") -> Tuple[torch.Tensor, torch.Tensor]:
    """K5f's math (``gn_act_reference`` of the JAX package):
    (y, stats (B, 2, G) f32)."""
    B, C, S = _dims(x, num_groups)
    _act_code(act)
    xg = x.reshape(B, num_groups, -1).float()
    mean = xg.mean(-1, keepdim=True)
    var = torch.clamp((xg * xg).mean(-1, keepdim=True) - mean * mean, min=0.0)
    r = torch.rsqrt(var + eps)
    xhat = ((xg - mean) * r).reshape(B, C, S)
    y = xhat * scale.float()[:, None] + bias.float()[:, None]
    if act == "silu":
        y = y * torch.sigmoid(y)
    stats = torch.stack([mean[..., 0], r[..., 0]], dim=1)
    return y.to(x.dtype).reshape(x.shape), stats


def gn_act_plain(x, scale, bias, *, num_groups: int, eps: float,
                 act: str = "none") -> torch.Tensor:
    """GroupNorm(+act) in plain torch, differentiable by autograd."""
    return gn_fwd_plain(x, scale, bias, num_groups, eps, act)[0]


def gn_bwd_plain(x, g, scale, bias, stats, num_groups: int,
                 act: str = "none"):
    """K5b's math (``_bwd_reference`` of the JAX package): (dx, dscale,
    dbias), the last two (C,) f32 summed over the batch."""
    B, C, S = _dims(x, num_groups)
    _act_code(act)
    cg = C // num_groups
    xf = x.reshape(B, C, S).float()
    gf = g.reshape(B, C, S).float()
    mean_c = stats[:, 0].repeat_interleave(cg, dim=-1)[:, :, None]
    r_c = stats[:, 1].repeat_interleave(cg, dim=-1)[:, :, None]
    sc = scale.float()[:, None]
    xhat = (xf - mean_c) * r_c
    if act == "silu":
        z = xhat * sc + bias.float()[:, None]
        sig = torch.sigmoid(z)
        dz = gf * sig * (1.0 + z * (1.0 - sig))
    else:
        dz = gf
    dxhat = dz * sc

    def gmean(t):
        m = t.reshape(B, num_groups, -1).mean(-1)
        return m.repeat_interleave(cg, dim=-1)[:, :, None]

    dx = r_c * (dxhat - gmean(dxhat) - xhat * gmean(dxhat * xhat))
    return (dx.to(x.dtype).reshape(x.shape), (dz * xhat).sum((0, 2)),
            dz.sum((0, 2)))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_params(name, x, C, *params):
    for p in params:
        _build.dtype_code(p)
        if p.device != x.device or not p.is_contiguous() or p.numel() != C:
            raise ValueError(f"{name}: scale/bias must be ({C},) contiguous "
                             f"on {x.device}")


def gn_fwd(x, scale, bias, num_groups: int, eps: float, act: str = "none"):
    """K5f: (y like x, stats (B, 2, G) f32)."""
    B, C, S = _dims(x, num_groups)
    a = _act_code(act)
    if x.device.type == "cpu":
        return gn_fwd_plain(x, scale, bias, num_groups, eps, act)
    _build.check_cuda_inputs("gn_fwd", x)
    _check_params("gn_fwd", x, C, scale, bias)
    y = torch.empty_like(x)
    stats = torch.empty((B, 2, num_groups), device=x.device,
                        dtype=torch.float32)
    _build.run("K5f groupnorm_fwd", "emcid_gn_fwd",
               x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
               stats.data_ptr(), B, C, S, num_groups, float(eps), a,
               _build.dtype_code(x), _build.dtype_code(scale),
               _build.stream_ptr(x))
    return y, stats


GN_BWD_ENTRY = {"resident": "emcid_gn_bwd_resident", "stream": "emcid_gn_bwd"}
_RES_CHUNK = 4096  # kGnResChunk: bytes of x (and of g) per barrier
_RES_RESERVE = 1024  # kGnResReserve: the block's static shared memory
_MAX_SMEM = 232448  # kMaxSmem: the most dynamic shared memory of a block


def resident_smem(Cg: int, S: int, esize: int) -> int:
    """Dynamic shared memory of the ``resident`` route for a span of Cg
    channels of S elements of ``esize`` bytes (``gn_res_smem`` in
    ``csrc/groupnorm.cu``): x and g, one 8-byte barrier per 4 KB of the
    span (rounded up to 16 bytes), one float2 per unit of a channel's 32
    accesses of V elements (the widest of at most 16 bytes dividing S)."""
    v = 16 // esize
    while S % v:
        v //= 2
    span = Cg * S * esize
    bars = -(-8 * -(-span // _RES_CHUNK) // 16) * 16
    return 2 * span + bars + 8 * Cg * -(-(S // v) // 32)


def gn_bwd_route(x, num_groups: int, *tensors) -> str:
    """K5b's route: ``"resident"`` for float32/bfloat16 spans of a multiple
    of 16 bytes, with every tensor 16-byte aligned and the span's x and g
    within one block's shared memory (bf16 at 384 px: 320 and 640 channels,
    not 960; at 512 px: 320), else ``"stream"``."""
    _, C, S = _dims(x, num_groups)
    Cg, es = C // num_groups, x.element_size()
    if (x.dtype in (torch.float32, torch.bfloat16) and Cg * S * es % 16 == 0
            and _build.aligned16(x, *tensors)
            and resident_smem(Cg, S, es) + _RES_RESERVE <= _MAX_SMEM):
        return "resident"
    return "stream"


def gn_bwd(x, g, scale, bias, stats, num_groups: int, act: str = "none"):
    """K5b: (dx like x, dscale (C,), dbias (C,)); the last two float32 on
    a CPU tensor (the plain version), in the parameters' type from the
    kernel, which sums them itself: one launch, nothing after it."""
    B, C, S = _dims(x, num_groups)
    a = _act_code(act)
    if x.device.type == "cpu":
        return gn_bwd_plain(x, g, scale, bias, stats, num_groups, act)
    _build.check_cuda_inputs("gn_bwd", x, g)
    _check_params("gn_bwd", x, C, scale, bias)
    if (stats.dtype != torch.float32 or not stats.is_contiguous()
            or tuple(stats.shape) != (B, 2, num_groups)):
        raise ValueError("gn_bwd: stats must be contiguous f32 (B, 2, G)")
    route = gn_bwd_route(x, num_groups, g)
    dx = torch.empty_like(x)
    dscale = torch.empty(C, device=x.device, dtype=scale.dtype)
    dbias = torch.empty(C, device=x.device, dtype=bias.dtype)
    part = torch.empty(B * 2 * C, device=x.device, dtype=torch.float32)
    _build.run("K5b groupnorm_bwd", GN_BWD_ENTRY[route],
               x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
               stats.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
               dbias.data_ptr(), part.data_ptr(),
               _build.fold_counters(x, 1).data_ptr(), B, C, S, num_groups, a,
               _build.dtype_code(x), _build.dtype_code(scale),
               _build.stream_ptr(x), route=route)
    return dx, dscale, dbias


class GroupNormAct(torch.autograd.Function):
    """K5f forward; K5b backward from the saved (B, 2, G) statistics
    (``gn_act_pallas``'s custom_vjp)."""

    @staticmethod
    def forward(ctx, x, scale, bias, num_groups, eps, act):
        y, stats = gn_fwd(x, scale, bias, num_groups, eps, act)
        ctx.save_for_backward(x, scale, bias, stats)
        ctx.num_groups, ctx.act = num_groups, act
        return y

    @staticmethod
    def backward(ctx, g):
        x, scale, bias, stats = ctx.saved_tensors
        dx, dscale, dbias = gn_bwd(x, g.contiguous(), scale, bias, stats,
                                   ctx.num_groups, ctx.act)
        if not x.is_cuda:  # the plain version's float32 sums
            dscale, dbias = dscale.to(scale.dtype), dbias.to(bias.dtype)
        return dx, dscale, dbias, None, None, None


def gn_act(x, scale, bias, num_groups: int, eps: float,
           act: str = "none") -> torch.Tensor:
    """Fused GroupNorm(+act) through K5f/K5b, differentiable."""
    return GroupNormAct.apply(x.contiguous(), scale.contiguous(),
                              bias.contiguous(), num_groups, float(eps), act)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def geo_wins(shape: Tuple[int, ...]) -> bool:
    """The JAX package's per-geometry gate (``EMCID_TPU_FUSED_GN=geo``),
    copied: a channel-last (B, ..., C) shape is on its measured-win
    frontier when S >= 2048 and C <= 640 (the level-0/1 sites at the
    512- and 384-px grids).  The frontier was measured on the TPU; it is
    kept so the knob means the same in both packages."""
    C = shape[-1]
    S = 1
    for d in shape[1:-1]:
        S *= d
    return S >= 2048 and C <= 640


def group_norm_act(x, scale, bias, *, num_groups: int, eps: float,
                   act: str = "none", geo_only: bool = False
                   ) -> torch.Tensor:
    """GroupNorm(+act) of a (B, C, ...) tensor.  On the card, through
    K5f/K5b when C % G == 0 (and, with ``geo_only``, the shape is on the
    ``geo_wins`` frontier), else the stock ``F.group_norm``; on the CPU,
    the plain version (as the JAX package runs its reference off the
    TPU), launching nothing."""
    if x.is_cuda:
        B, C = x.shape[:2]
        S = math.prod(x.shape[2:])
        if C % num_groups or (geo_only and not geo_wins((B, S, C))):
            h = F.group_norm(x, num_groups, scale, bias, eps)
            return F.silu(h) if act == "silu" else h
    return gn_act(x, scale, bias, num_groups, eps, act)
