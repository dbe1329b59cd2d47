"""Fused row LayerNorm(+act) with a kernel backward (K6f, K6b).

Counterpart of ``emcid_tpu/ops/layernorm.py``.  Two hand-written CUDA
kernels (``emcid_torch/csrc/layernorm.cu``) replace the two Pallas
kernels:

* K6f ``ln_fwd`` — LayerNorm over the last axis, affine and the optional
  activation in one pass; nothing is saved;
* K6b ``ln_bwd`` — the row statistics recomputed, dx from the two row
  means, and dgamma/dbeta summed over the rows inside the same launch (the
  JAX package sums its per-batch partials outside its kernel).  Two routes,
  one C entry point each, picked by ``ln_bwd_route`` and counted in
  ``_build.ROUTES``: ``rows`` (C = 32 * V * nv with nv <= 5, the UNet's
  320, 640 and 1280 channels: each row copied once into shared memory and
  computed from registers) and ``generic`` (any other C: three passes over
  each row).

The math is flax/torch LayerNorm: float32 statistics, the fast variance
max(E[x^2] - E[x]^2, 0), normalise and activate in float32, one rounding
to the output type.  Inputs are (..., C) with the rows contiguous, as in
the JAX package.  Its VMEM row chunking (``_pick_rows``, ``fits``) is not
ported: the CUDA kernels take every shape.

Each wrapper computes its plain PyTorch version below on a CPU tensor and
launches its kernel or raises on a CUDA tensor.
"""

from __future__ import annotations

import math

import torch

from emcid_torch.ops import _build
from emcid_torch.ops.groupnorm import _act_code, _check_params

# ---------------------------------------------------------------------------
# plain versions (the kernels' math)
# ---------------------------------------------------------------------------


def _xhat(x, eps):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
    r = torch.rsqrt(var + eps)
    return (xf - mean) * r, r


def ln_act_plain(x, scale, bias, *, eps: float,
                 act: str = "none") -> torch.Tensor:
    """K6f's math (``ln_act_reference`` of the JAX package), differentiable
    by autograd."""
    _act_code(act)
    xhat, _ = _xhat(x, eps)
    y = xhat * scale.float() + bias.float()
    if act == "silu":
        y = y * torch.sigmoid(y)
    return y.to(x.dtype)


def ln_bwd_plain(x, g, scale, bias, eps: float, act: str = "none"):
    """K6b's math: (dx, dscale, dbias), the last two (C,) f32."""
    _act_code(act)
    xhat, r = _xhat(x, eps)
    sc = scale.float()
    if act == "silu":
        z = xhat * sc + bias.float()
        sig = torch.sigmoid(z)
        dz = g.float() * sig * (1.0 + z * (1.0 - sig))
    else:
        dz = g.float()
    dxhat = dz * sc
    m1 = dxhat.mean(-1, keepdim=True)
    m2 = (dxhat * xhat).mean(-1, keepdim=True)
    dx = r * (dxhat - m1 - xhat * m2)
    C = x.shape[-1]
    return (dx.to(x.dtype), (dz * xhat).reshape(-1, C).sum(0),
            dz.reshape(-1, C).sum(0))


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def ln_fwd(x, scale, bias, eps: float, act: str = "none") -> torch.Tensor:
    """K6f: y like x."""
    a = _act_code(act)
    if x.device.type == "cpu":
        return ln_act_plain(x, scale, bias, eps=eps, act=act)
    _build.check_cuda_inputs("ln_fwd", x)
    C = x.shape[-1]
    _check_params("ln_fwd", x, C, scale, bias)
    y = torch.empty_like(x)
    _build.run("K6f layernorm_fwd", "emcid_ln_fwd",
               x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
               x.numel() // C, C, float(eps), a, _build.dtype_code(x),
               _build.dtype_code(scale), _build.stream_ptr(x))
    return y


LN_BWD_ENTRY = {"rows": "emcid_ln_bwd_rows", "generic": "emcid_ln_bwd"}
ROWS_MAX_NV = 5
_WARPS = 8  # kLnWarps: warps of a backward block
_MAX_SMEM = 232448  # kMaxSmem: the most dynamic shared memory of a block


def _rows_vec(C: int, esize: int):
    """(V, nv) of the ``rows`` route for rows of C elements of ``esize``
    bytes: C = 32 * V * nv with V the widest access of at most 16 bytes
    that divides C / 32; None where C % 32, nv > 5 or an access is under
    4 bytes (the smallest asynchronous copy)."""
    if C % 32:
        return None
    per = C // 32
    v = 16 // esize
    while per % v:
        v //= 2
    return (v, per // v) if per // v <= ROWS_MAX_NV and v * esize >= 4 \
        else None


def ln_bwd_route(x, *tensors) -> str:
    """K6b's route: ``"rows"`` for float32/bfloat16 rows where
    ``_rows_vec`` gives a shape (bf16 C = 320, 640, 1280; f32 C = 320,
    640) and every tensor starts on a 16-byte boundary, else
    ``"generic"``."""
    if (x.dtype in (torch.float32, torch.bfloat16)
            and _rows_vec(x.shape[-1], x.element_size()) is not None
            and _build.aligned16(x, *tensors)):
        return "rows"
    return "generic"


def _bwd_blocks(route: str, rows: int, C: int, esize: int, sms: int) -> int:
    """The backward's grid: one warp per row at most and no more blocks
    than fit the card at once (``rows_min_blocks`` and ``ln_bwd_warps`` in
    ``csrc/layernorm.cu``)."""
    if route == "rows":
        access = _rows_vec(C, esize)[0] * esize
        per_sm = 3 if access <= 4 else 2 if access <= 8 else 1
        return min(math.ceil(rows / _WARPS), sms * per_sm)
    nw = min(_WARPS, _MAX_SMEM // (8 * C))
    if nw < 1:
        raise ValueError(f"ln_bwd: {C} channels are too wide for the kernel")
    per_sm = max(1, min(2048 // (nw * 32), 233472 // (8 * C * nw + 1024)))
    return min(math.ceil(rows / nw), sms * per_sm)


def ln_bwd(x, g, scale, bias, eps: float, act: str = "none"):
    """K6b: (dx like x, dscale (C,), dbias (C,)); the last two float32 on
    a CPU tensor (the plain version), in the parameters' type from the
    kernel, which sums them itself: one launch, nothing after it."""
    a = _act_code(act)
    if x.device.type == "cpu":
        return ln_bwd_plain(x, g, scale, bias, eps, act)
    _build.check_cuda_inputs("ln_bwd", x, g)
    C = x.shape[-1]
    _check_params("ln_bwd", x, C, scale, bias)
    rows = x.numel() // C
    if rows == 0:
        raise ValueError(f"ln_bwd: no rows in {tuple(x.shape)}")
    route = ln_bwd_route(x, g)
    nblocks = _bwd_blocks(route, rows, C, x.element_size(), _build.sm_count(x))
    groups = _build.fold_groups(nblocks)
    dx = torch.empty_like(x)
    dscale = torch.empty(C, device=x.device, dtype=scale.dtype)
    dbias = torch.empty(C, device=x.device, dtype=bias.dtype)
    part = torch.empty((nblocks + groups) * 2 * C, device=x.device,
                       dtype=torch.float32)
    _build.run("K6b layernorm_bwd", LN_BWD_ENTRY[route],
               x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
               dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(),
               part.data_ptr(), _build.fold_counters(x, groups + 1).data_ptr(),
               rows, C, float(eps), a, nblocks, _build.dtype_code(x),
               _build.dtype_code(scale), _build.stream_ptr(x), route=route)
    return dx, dscale, dbias


class LayerNormAct(torch.autograd.Function):
    """K6f forward; K6b backward, which recomputes the row statistics, so
    only the inputs are saved (``ln_act_pallas``'s custom_vjp)."""

    @staticmethod
    def forward(ctx, x, scale, bias, eps, act):
        ctx.save_for_backward(x, scale, bias)
        ctx.eps, ctx.act = eps, act
        return ln_fwd(x, scale, bias, eps, act)

    @staticmethod
    def backward(ctx, g):
        x, scale, bias = ctx.saved_tensors
        dx, dscale, dbias = ln_bwd(x, g.contiguous(), scale, bias, ctx.eps,
                                   ctx.act)
        if not x.is_cuda:  # the plain version's float32 sums
            dscale, dbias = dscale.to(scale.dtype), dbias.to(bias.dtype)
        return dx, dscale, dbias, None, None


def layer_norm_act(x, scale, bias, *, eps: float,
                   act: str = "none") -> torch.Tensor:
    """LayerNorm(+act) over the last axis: through K6f/K6b on the card, the
    plain version on the CPU (launching nothing); differentiable."""
    return LayerNormAct.apply(x.contiguous(), scale.contiguous(),
                              bias.contiguous(), float(eps), act)
