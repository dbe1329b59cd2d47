"""Device resolution and the f32 precision pin.

Counterpart of ``emcid_tpu/runtime.py``.  The JAX package pins full-f32
matmuls at its closed-form sites because the TPU's default f32 matmul is a
bf16-rounded pass; the card's analogue is TF32, which PyTorch allows by
default for cuDNN convolutions (and may be allowed for matmuls).
``precise_matmuls`` turns both off inside its scope.
"""

from __future__ import annotations

import contextlib
from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another one.  Raises when CUDA is wanted and absent (no silent CPU
    fallback)."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device present; pass device='cpu' to run "
                           "on the CPU")
    return dev


@contextlib.contextmanager
def precise_matmuls():
    """Full-f32 matmuls and convolutions (TF32 off) inside the scope: the
    covariance accumulate, the Stage-2 solve and insert."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
