"""Attention dispatch, the chunked plain path, and the short-key kernel K4.

Counterpart of ``emcid_tpu/ops/attention.py``.  All functions take
(B, N, H, D) queries and (B, M, H, D) keys/values and return (B, N, H, D).

* ``mha_chunked`` — softmax attention over query blocks in plain torch.  It
  serves ``attention()`` on the CPU (as the JAX package's chunked scan does
  off-TPU) and is K4's backward: the backward of the short-key forward is
  this chunked recompute, not a kernel, exactly as in the JAX package
  (``attention.py:147-151``), which has no Pallas backward for it either.
* ``short_kv_fwd`` — K4 (``emcid_torch/csrc/short_kv.cu``): single-pass
  forward for M < 256 keys, all beside one query tile; ``short_kv_route``
  picks its route (``mma``: bf16 at head dims 40 and 80 on the tensor
  cores; ``fma``: the rest on float FMAs).
* ``attention`` — below ``EMCID_TPU_FLASH_MIN_SEQ`` tokens (default 1024),
  or at every length under ``EMCID_TPU_NO_FLASH=1``, the fused
  einsum/softmax short path; on CUDA tensors M >= 256 goes to the
  flash-v2 kernels (K1-K3) and M < 256 to K4; on the CPU to
  ``mha_chunked``.  The routing is by M alone (the JAX package's
  ``EMCID_TPU_ATTN`` TPU tuning switch is not ported).
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import torch

from emcid_torch.ops import _build, graphs
from emcid_torch.ops.flash_v2 import _dims, flash_attention_v2

SHORT_KV_MAX = 256  # K4 takes fewer keys than this


def _block_attention(qi, k, v, scale):
    s = torch.einsum("bqhd,bkhd->bhqk", qi * scale, k)
    p = torch.softmax(s.float(), dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, v)


def mha_chunked(q, k, v, scale: Optional[float] = None,
                block_q: int = 512) -> torch.Tensor:
    """Softmax attention scanned over query blocks (peak memory: one
    block's scores)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    block_q = min(block_q, q.shape[1])
    return torch.cat([_block_attention(q[:, i:i + block_q], k, v, scale)
                      for i in range(0, q.shape[1], block_q)], dim=1)


def _mha_chunked_vjp(q, k, v, g, scale, block_q: int = 512):
    """(dq, dk, dv) of ``mha_chunked`` by per-block recompute."""
    dq = torch.empty_like(q)
    dk = torch.zeros_like(k, dtype=torch.float32)
    dv = torch.zeros_like(v, dtype=torch.float32)
    kd, vd = k.detach().requires_grad_(), v.detach().requires_grad_()
    for i in range(0, q.shape[1], block_q):
        with torch.enable_grad():
            qi = q[:, i:i + block_q].detach().requires_grad_()
            out = _block_attention(qi, kd, vd, scale)
            gq, gk, gv = torch.autograd.grad(out, (qi, kd, vd),
                                             g[:, i:i + block_q])
        dq[:, i:i + block_q] = gq
        dk += gk.float()
        dv += gv.float()
    return dq, dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# K4: single-pass forward for short key sets
# ---------------------------------------------------------------------------


def short_kv_fwd_plain(q, k, v, scale: float) -> torch.Tensor:
    """K4's math: scores, one softmax over all keys, p.V, in f32."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), k.float()) * scale
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.float()).to(q.dtype)


SHORT_KV_ENTRY = {"mma": "emcid_short_kv_fwd_mma", "fma": "emcid_short_kv_fwd"}


def short_kv_route(q, k, v, o) -> str:
    """K4's route: ``"mma"`` for bf16 with 32 < D <= 80, D % 8 == 0 and
    16-byte aligned tensors, else ``"fma"``."""
    D = q.shape[-1]
    if (q.dtype == torch.bfloat16 and 32 < D <= 80 and D % 8 == 0
            and _build.aligned16(q, k, v, o)):
        return "mma"
    return "fma"


def short_kv_fwd(q, k, v, scale: float) -> torch.Tensor:
    """K4 wrapper: the plain version on CPU tensors, the kernel on CUDA."""
    B, N, H, M, D = _dims(q, k, v)
    if q.device.type == "cpu":
        return short_kv_fwd_plain(q, k, v, scale)
    if M >= SHORT_KV_MAX:
        raise ValueError(f"short_kv_fwd takes M < {SHORT_KV_MAX} keys, "
                         f"got {M}")
    _build.check_cuda_inputs("short_kv_fwd", q, k, v)
    o = torch.empty_like(q)
    route = short_kv_route(q, k, v, o)
    _build.run("K4 short_kv_fwd", SHORT_KV_ENTRY[route],
               q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
               B, H, N, M, D, ctypes.c_float(scale), _build.dtype_code(q),
               _build.stream_ptr(q), route=route)
    return o


def _short_fwd(q, k, v, scale):
    return short_kv_fwd(q, k, v, scale)


class ShortKVAttention(torch.autograd.Function):
    """K4 forward; chunked-recompute backward (``_flash_bwd`` in JAX).  The
    forward runs through ``graphs.eager``: a CUDA-graph capture leaves K4
    out and takes the backward, which launches no kernel of the port."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return graphs.eager(_short_fwd, q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = _mha_chunked_vjp(q, k, v, g, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    """Short-key attention through K4, differentiable."""
    s = scale if scale is not None else q.shape[-1] ** -0.5
    return ShortKVAttention.apply(q.contiguous(), k.contiguous(),
                                  v.contiguous(), float(s))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def _flash_min_seq() -> int:
    """Sequences at least this long route to the memory-bounded paths."""
    return int(os.environ.get("EMCID_TPU_FLASH_MIN_SEQ", 1024))


def attention(q, k, v, scale: Optional[float] = None) -> torch.Tensor:
    N, M = q.shape[1], k.shape[1]
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if (max(N, M) < _flash_min_seq()
            or os.environ.get("EMCID_TPU_NO_FLASH") == "1"):
        return _block_attention(q, k, v, scale)
    if q.is_cuda:
        if M >= SHORT_KV_MAX:
            return flash_attention_v2(q, k, v, scale)
        return flash_attention(q, k, v, scale)
    return mha_chunked(q, k, v, scale)
