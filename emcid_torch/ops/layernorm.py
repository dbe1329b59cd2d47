"""Fused row LayerNorm(+act) with a kernel backward (K6f, K6b).

Counterpart of ``emcid_tpu/ops/layernorm.py``.  Two hand-written CUDA
kernels (``emcid_torch/csrc/layernorm.cu``) replace the two Pallas
kernels:

* K6f ``ln_fwd`` — LayerNorm over the last axis, affine and the optional
  activation in one pass; nothing is saved;
* K6b ``ln_bwd`` — the row statistics recomputed, dx from the two row
  means; dgamma/dbeta from per-block partials the kernel writes, summed
  here (the JAX package sums its per-batch partials outside its kernel the
  same way).

The math is flax/torch LayerNorm: float32 statistics, the fast variance
max(E[x^2] - E[x]^2, 0), normalise and activate in float32, one rounding
to the output type.  Inputs are (..., C) with the rows contiguous, as in
the JAX package.  Its VMEM row chunking (``_pick_rows``, ``fits``) is not
ported: the CUDA kernels take every shape.

Each wrapper computes its plain PyTorch version below on a CPU tensor and
launches its kernel or raises on a CUDA tensor.
"""

from __future__ import annotations

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
    _check_params("ln_fwd", x, scale, bias)
    C = x.shape[-1]
    y = torch.empty_like(x)
    _build.run("K6f layernorm_fwd", "emcid_ln_fwd",
               x.data_ptr(), scale.data_ptr(), bias.data_ptr(), y.data_ptr(),
               x.numel() // C, C, float(eps), a, _build.dtype_code(x),
               _build.dtype_code(scale), _build.stream_ptr(x))
    return y


def ln_bwd(x, g, scale, bias, eps: float, act: str = "none"):
    """K6b: (dx like x, dscale (C,) f32, dbias (C,) f32)."""
    a = _act_code(act)
    if x.device.type == "cpu":
        return ln_bwd_plain(x, g, scale, bias, eps, act)
    _build.check_cuda_inputs("ln_bwd", x, g)
    _check_params("ln_bwd", x, scale, bias)
    C = x.shape[-1]
    rows = x.numel() // C
    nblocks = _build.lib().emcid_ln_bwd_blocks(rows, C)
    if nblocks <= 0:
        raise ValueError(f"ln_bwd: no launch for {rows} rows of {C} channels")
    dx = torch.empty_like(x)
    dscale = torch.empty((nblocks, C), device=x.device, dtype=torch.float32)
    dbias = torch.empty_like(dscale)
    _build.run("K6b layernorm_bwd", "emcid_ln_bwd",
               x.data_ptr(), g.data_ptr(), scale.data_ptr(), bias.data_ptr(),
               dx.data_ptr(), dscale.data_ptr(), dbias.data_ptr(), rows, C,
               float(eps), a, nblocks, _build.dtype_code(x),
               _build.dtype_code(scale), _build.stream_ptr(x))
    return dx, dscale.sum(0), dbias.sum(0)


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
        return dx, dscale.to(scale.dtype), dbias.to(bias.dtype), None, None


def layer_norm_act(x, scale, bias, *, eps: float,
                   act: str = "none") -> torch.Tensor:
    """LayerNorm(+act) over the last axis: through K6f/K6b on the card, the
    plain version on the CPU (launching nothing); differentiable."""
    return LayerNormAct.apply(x.contiguous(), scale.contiguous(),
                              bias.contiguous(), float(eps), act)
