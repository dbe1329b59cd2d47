"""Online-softmax flash attention with a kernel backward (K1, K2, K3).

Counterpart of ``emcid_tpu/ops/flash_v2.py``.  Three hand-written CUDA
kernels (``emcid_torch/csrc/flash_v2.cu``) replace the three Pallas kernels:

* K1 ``flash_fwd``  — forward, returns O and the per-row logsumexp;
* K2 ``flash_dq``   — dQ = scale * dS.K with P recomputed from the lse;
* K3 ``flash_dkv``  — dV = P^T.dO and dK = scale * dS^T.Q;

where dS = P * (dO.V^T - delta) and delta = rowsum(dO * O) (computed here
in torch, as the JAX package does outside its kernels).  K1 has three
routes, each its own C entry point, picked by ``fwd_route``: ``mma`` (bf16
at the UNet's head dims 40 and 80, tensor cores with the scores in
registers), ``d512`` (bf16 at the VAE's single 512-wide head, the head dim
split across warps) and ``fma`` (float32 and every other head dim, float
FMAs).  K2 and K3 have two routes each, picked together by ``bwd_route``:
``mma`` (bf16 at the UNet's head dims, tensor cores with S, P, dP and dS in
registers) and ``fma`` (the rest, float FMAs).  Every route is its own C
entry point, and ``_build.ROUTES`` counts the launches of each.

Each wrapper takes (B, L, H, D) tensors.  On a CPU tensor it computes its
kernel's plain PyTorch version below (the same math, materialized scores,
f32 accumulation); on a CUDA tensor it launches the kernel or raises.
lse and delta are (B, H, N) float32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from emcid_torch.ops import _build, graphs


# ---------------------------------------------------------------------------
# plain versions (the kernels' math)
# ---------------------------------------------------------------------------


def _scores(q, k, scale):
    """(B, N, H, D) x (B, M, H, D) -> f32 scores (B, H, N, M)."""
    return torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()).mul_(scale)


def flash_fwd_plain(q, k, v, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    s = _scores(q, k, scale)
    lse = torch.logsumexp(s, dim=-1)
    p = s.sub_(lse[..., None]).exp_()
    o = torch.einsum("bhnm,bmhd->bnhd", p, v.float())
    return o.to(q.dtype), lse


def _dscores(q, k, v, dout, lse, delta, scale):
    p = _scores(q, k, scale).sub_(lse[..., None]).exp_()
    dp = torch.einsum("bnhd,bmhd->bhnm", dout.float(), v.float())
    ds = dp.sub_(delta[..., None]).mul_(p)
    return p, ds


def flash_dq_plain(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    _, ds = _dscores(q, k, v, dout, lse, delta, scale)
    return (torch.einsum("bhnm,bmhd->bnhd", ds, k.float()) * scale).to(q.dtype)


def flash_dkv_plain(q, k, v, dout, lse, delta, scale: float
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    p, ds = _dscores(q, k, v, dout, lse, delta, scale)
    dv = torch.einsum("bhnm,bnhd->bmhd", p, dout.float())
    dk = torch.einsum("bhnm,bnhd->bmhd", ds, q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _dims(q, k, v):
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"expected (B, L, H, D) q/k/v, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    B, N, H, D = q.shape
    if k.shape[0] != B or k.shape[2] != H or k.shape[3] != D:
        raise ValueError("q and k/v differ in batch, heads or head dim")
    return B, N, H, k.shape[1], D


FWD_ENTRY = {"mma": "emcid_flash_fwd_mma", "d512": "emcid_flash_fwd_d512",
             "fma": "emcid_flash_fwd"}


def _mma_ok(q, *tensors) -> bool:
    """Whether the ``mma`` routes take these tensors: bf16 with 32 < D <= 80
    and D % 8 == 0, every tensor 16-byte aligned (they copy 16-byte
    pieces)."""
    D = q.shape[-1]
    return (q.dtype == torch.bfloat16 and 32 < D <= 80 and D % 8 == 0
            and _build.aligned16(q, *tensors))


def fwd_route(q, k, v, o) -> str:
    """K1's route for these tensors: ``"mma"`` where ``_mma_ok``,
    ``"d512"`` for bf16 with D = 512 (16-byte aligned too), else
    ``"fma"``."""
    if _mma_ok(q, k, v, o):
        return "mma"
    if (q.dtype == torch.bfloat16 and q.shape[-1] == 512
            and _build.aligned16(q, k, v, o)):
        return "d512"
    return "fma"


DQ_ENTRY = {"mma": "emcid_flash_dq_mma", "fma": "emcid_flash_dq"}
DKV_ENTRY = {"mma": "emcid_flash_dkv_mma", "fma": "emcid_flash_dkv"}


def bwd_route(q, k, v, dout, *outs) -> str:
    """K2's and K3's route for these inputs and outputs: ``"mma"`` under
    the rule of K1's (``_mma_ok``), else ``"fma"``."""
    return "mma" if _mma_ok(q, k, v, dout, *outs) else "fma"


def flash_fwd(q, k, v, scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1: (out (B, N, H, D), lse (B, H, N) f32)."""
    B, N, H, M, D = _dims(q, k, v)
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale)
    _build.check_cuda_inputs("flash_fwd", q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((B, H, N), device=q.device, dtype=torch.float32)
    route = fwd_route(q, k, v, o)
    _build.run("K1 flash_v2_fwd", FWD_ENTRY[route],
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               lse.data_ptr(), B, H, N, M, D, ctypes.c_float(scale),
               _build.dtype_code(q), _build.stream_ptr(q), route=route)
    return o, lse


def _check_rows(name, lse, delta, B, H, N):
    for t in (lse, delta):
        if t.dtype != torch.float32 or tuple(t.shape) != (B, H, N):
            raise ValueError(f"{name}: lse/delta must be f32 (B, H, N)")
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"{name}: lse/delta must be contiguous CUDA")


def flash_dq(q, k, v, dout, lse, delta, scale: float) -> torch.Tensor:
    """K2: dQ (B, N, H, D)."""
    B, N, H, M, D = _dims(q, k, v)
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, dout, lse, delta, scale)
    _build.check_cuda_inputs("flash_dq", q, k, v, dout)
    _check_rows("flash_dq", lse, delta, B, H, N)
    dq = torch.empty_like(q)
    route = bwd_route(q, k, v, dout, dq)
    _build.run("K2 flash_v2_dq", DQ_ENTRY[route],
               q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
               lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
               B, H, N, M, D, ctypes.c_float(scale), _build.dtype_code(q),
               _build.stream_ptr(q), route=route)
    return dq


def flash_dkv(q, k, v, dout, lse, delta, scale: float
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: (dK, dV), each (B, M, H, D)."""
    B, N, H, M, D = _dims(q, k, v)
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, scale)
    _build.check_cuda_inputs("flash_dkv", q, k, v, dout)
    _check_rows("flash_dkv", lse, delta, B, H, N)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    route = bwd_route(q, k, v, dout, dk, dv)
    _build.run("K3 flash_v2_dkv", DKV_ENTRY[route],
               q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
               lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
               B, H, N, M, D, ctypes.c_float(scale), _build.dtype_code(q),
               _build.stream_ptr(q), route=route)
    return dk, dv


def row_delta(out: torch.Tensor, dout: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) as (B, H, N) f32."""
    return (out.float() * dout.float()).sum(-1).transpose(1, 2).contiguous()


def _fwd(q, k, v, scale):
    return flash_fwd(q, k, v, scale)


def _bwd(q, k, v, out, lse, g, scale):
    g = g.contiguous()
    delta = row_delta(out, g)
    dq = flash_dq(q, k, v, g, lse, delta, scale)
    dk, dv = flash_dkv(q, k, v, g, lse, delta, scale)
    return dq, dk, dv


class FlashAttentionV2(torch.autograd.Function):
    """K1 forward; K2 + K3 backward (mirrors ``flash_attention_v2``'s
    custom_vjp: the forward saves the lse, no N^2 residuals).  Both bodies
    run through ``graphs.eager``: a CUDA-graph capture leaves them out."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = graphs.eager(_fwd, q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = graphs.eager(_bwd, q, k, v, out, lse, g, ctx.scale)
        return dq, dk, dv, None


def flash_attention_v2(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """(B, N, H, D) x (B, M, H, D) -> (B, N, H, D), differentiable."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    return FlashAttentionV2.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), float(s))
