"""Closed-form MEMIT-style solve: ``adj_k = (lam*C + K K^T)^-1 K``.

Counterpart of ``emcid_tpu/ops/solve.py``.  ``A = lam*C + K K^T`` is SPD (C
is a second moment, lam > 0), so:

* ``method="f32_ir"`` — f32 Cholesky on the tensor's device plus a fixed
  number of iterative-refinement steps, under ``precise_matmuls`` (no
  TF32 in A, the solve or the residual);
* ``method="f64"`` — exact float64 on the host (scipy), the parity mode.

No kernel of its own: this is linear algebra (ROADMAP M3).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from emcid_torch.runtime import precise_matmuls


def _solve_f64_host(C, K, lam: float) -> np.ndarray:
    import scipy.linalg

    C = np.asarray(C, dtype=np.float64)
    K = np.asarray(K, dtype=np.float64)
    return scipy.linalg.solve(lam * C + K @ K.T, K, assume_a="pos")


def _solve_f32_ir(C: torch.Tensor, K: torch.Tensor, lam: float,
                  refine_steps: int = 2) -> torch.Tensor:
    with precise_matmuls():
        C, K = C.float(), K.float()
        A = lam * C + K @ K.T
        L = torch.linalg.cholesky(A)
        x = torch.cholesky_solve(K, L)
        for _ in range(refine_steps):
            x = x + torch.cholesky_solve(K - A @ x, L)
        return x


def solve_adj_k(C, K, lam: float, method: str = "f32_ir",
                refine_steps: int = 2):
    """Solve ``(lam*C + K K^T) adj_k = K``; C (in, in), K (in, n).
    Returns a float32 tensor on K's device ("f32_ir") or a float64 numpy
    array ("f64")."""
    if method == "f64":
        to_np = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else x
        return _solve_f64_host(to_np(C), to_np(K), float(lam))
    if method == "f32_ir":
        K = torch.as_tensor(K)
        return _solve_f32_ir(torch.as_tensor(C, device=K.device), K,
                             float(lam), refine_steps=refine_steps)
    raise ValueError(f"unknown solve method {method!r}")


def upd_matrix_match_shape(matrix, shape: Tuple[int, ...]):
    """Orient an update matrix to a weight's shape: as is, transposed, or a
    2-D -> 4-D reshape for conv kernels edited as matrices."""
    if tuple(matrix.shape) == tuple(shape):
        return matrix
    if tuple(matrix.T.shape) == tuple(shape):
        return matrix.T
    if matrix.ndim == 2 and len(shape) == 4:
        h, w = shape[2:]
        return matrix.reshape(shape[0], shape[1], h, w)
    raise ValueError(
        f"EMCID update matrix shape {tuple(matrix.shape)} does not match "
        f"weight shape {tuple(shape)}")
