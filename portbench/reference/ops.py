"""Plain tensor operations of the reference models, under one precision.

The reference computes in float32 with TF32 off.  Its control computes the
same operations with every operand of a matrix product or convolution
rounded to float8 (e4m3, one scale per tensor), the step below bfloat16:
``Prec(fp8=True)``.  Norms, softmax and the samplers stay in float32 in
both.  Gradients pass a rounded operand unchanged (straight through), so
the control's backward multiplies by the rounded forward operands.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

E4M3_MAX = 448.0


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to e4m3 under a per-tensor scale that maps its largest
    magnitude to the format's largest, back in float32."""
    t = t.float()
    scale = t.detach().abs().amax().clamp_min(1e-30) / E4M3_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())


class Prec:
    """Where the reference's operands are rounded: nowhere (float32) or to
    float8 (the control).  Weights are read from ``params`` (any dtype)
    and converted once."""

    def __init__(self, params: Dict[str, torch.Tensor], fp8: bool = False):
        self.params = params
        self.fp8 = fp8
        self._w: Dict[str, torch.Tensor] = {}

    def op(self, t: torch.Tensor) -> torch.Tensor:
        """An activation operand of a product."""
        return fp8_round(t) if self.fp8 else t.float()

    def w(self, name: str) -> torch.Tensor:
        """A weight operand of a product."""
        if name not in self._w:
            t = self.params[name].float()
            self._w[name] = fp8_round(t).detach() if self.fp8 else t
        return self._w[name]

    def b(self, name: str) -> Optional[torch.Tensor]:
        """A bias, a norm's scale or shift, an embedding: float32 always."""
        t = self.params.get(name)
        return None if t is None else t.float()

    def has(self, name: str) -> bool:
        return name in self.params


def linear(p: Prec, name: str, x: torch.Tensor) -> torch.Tensor:
    y = p.op(x) @ p.w(name + ".weight").T
    b = p.b(name + ".bias")
    return y if b is None else y + b


def conv(p: Prec, name: str, x: torch.Tensor, stride: int = 1,
         padding: int = 1) -> torch.Tensor:
    w = p.w(name + ".weight")
    return F.conv2d(p.op(x), w, p.b(name + ".bias"), stride=stride,
                    padding=padding if w.shape[-1] > 1 else 0)


def group_norm(p: Prec, name: str, x: torch.Tensor, groups: int,
               eps: float) -> torch.Tensor:
    return F.group_norm(x.float(), groups, p.b(name + ".weight"),
                        p.b(name + ".bias"), eps)


def layer_norm(p: Prec, name: str, x: torch.Tensor, eps: float = 1e-5
               ) -> torch.Tensor:
    return F.layer_norm(x.float(), (x.shape[-1],), p.b(name + ".weight"),
                        p.b(name + ".bias"), eps)


def attention(p: Prec, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: Optional[torch.Tensor] = None,
              block: int = 1024) -> torch.Tensor:
    """Softmax attention of (B, N, H, D) queries over (B, M, H, D) keys,
    scale D^-1/2, over blocks of queries (one block's scores at a time)."""
    scale = q.shape[-1] ** -0.5
    k, v = p.op(k), p.op(v)
    outs = []
    for i in range(0, q.shape[1], block):
        s = torch.einsum("bnhd,bmhd->bhnm", p.op(q[:, i:i + block]) * scale,
                         k)
        if mask is not None:
            s = s + mask[..., i:i + block, :]
        outs.append(torch.einsum("bhnm,bmhd->bnhd",
                                 p.op(torch.softmax(s, dim=-1)), v))
    return torch.cat(outs, dim=1)


def timestep_features(t: torch.Tensor, dim: int, flip_sin_to_cos: bool,
                      freq_shift: float) -> torch.Tensor:
    """Sinusoidal features (B,) -> (B, dim), as diffusers'
    ``get_timestep_embedding`` with max period 10000."""
    half = dim // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=t.device) / (half - freq_shift))
    args = t.float()[:, None] * freqs[None]
    emb = (torch.cat([torch.cos(args), torch.sin(args)], -1) if flip_sin_to_cos
           else torch.cat([torch.sin(args), torch.cos(args)], -1))
    return F.pad(emb, (0, 1)) if dim % 2 else emb


@contextlib.contextmanager
def exact_f32():
    """TF32 off for matrix products and convolutions inside the scope."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
