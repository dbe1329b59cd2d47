"""Closed-form MEMIT-style solve: ``adj_k = (lam*C + K K^T)^-1 K``.

Counterpart of ``emcid_tpu/ops/solve.py``.  ``A = lam*C + K K^T`` is SPD (C
is a second moment, lam > 0), so:

* ``method="f32_ir"`` — f32 Cholesky on the tensor's device plus
  iterative refinement (``refined_cholesky_solve``), under
  ``precise_matmuls`` (no TF32).  A is formed, each step's residual taken
  and the solution kept in float64: refined on f32 residuals (as the JAX
  package does), the solve stalls near cond(A) x 2^-24 of float64, 2.5e-3
  at a covariance over the synthetic caption corpus (cond ~1e8); on
  float64 residuals it reaches the float64 solve while f32 can factor A.
  Each step shrinks the error by a factor that grows with cond(A), so the
  refinement runs until a step moves x by at most ``REFINE_TOL`` of its
  norm, and raises when the steps stop shrinking (or ``REFINE_STEPS``
  pass) before that: f32 cannot factor A well enough;
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


REFINE_STEPS = 50  # the most refinement steps of one solve
REFINE_TOL = 1e-6  # a step this small (relative to x) ends the refinement


def refined_cholesky_solve(A64: torch.Tensor, rhs64: torch.Tensor
                           ) -> torch.Tensor:
    """Solve ``A64 x = rhs64`` (float64, A SPD) with one f32 Cholesky of A
    and refinement on float64 residuals -> f32 x.  Stops once a step moves
    x by at most ``REFINE_TOL`` of its norm; raises ``FloatingPointError``
    (with the ratio reached) when a step is no smaller than the one before
    it, or ``REFINE_STEPS`` pass, first."""
    with precise_matmuls():
        L = torch.linalg.cholesky(A64.float())
        x = torch.cholesky_solve(rhs64.float(), L).double()
        prev = float("inf")
        for step in range(1, REFINE_STEPS + 1):
            dx = torch.cholesky_solve((rhs64 - A64 @ x).float(), L).double()
            x = x + dx
            dx_n, x_n = float(dx.norm()), float(x.norm())
            if dx_n <= REFINE_TOL * x_n:
                return x.float()
            if not dx_n < prev:
                break
            prev = dx_n
        raise FloatingPointError(
            f"f32 Cholesky refinement did not converge: after {step} steps "
            f"a step moved x by {dx_n / max(x_n, 1e-300):.3e} of its norm "
            f"(tolerance {REFINE_TOL:g}); A ({A64.shape[0]} wide) is too "
            "ill-conditioned for an f32 factor, use method='f64'")


def _solve_f32_ir(C: torch.Tensor, K: torch.Tensor, lam: float
                  ) -> torch.Tensor:
    with precise_matmuls():
        K64 = K.double()
        A64 = lam * C.double() + K64 @ K64.T
    return refined_cholesky_solve(A64, K64)


def solve_adj_k(C, K, lam: float, method: str = "f32_ir"):
    """Solve ``(lam*C + K K^T) adj_k = K``; C (in, in), K (in, n).
    Returns a float32 tensor on K's device ("f32_ir") or a float64 numpy
    array ("f64")."""
    if method == "f64":
        to_np = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else x
        return _solve_f64_host(to_np(C), to_np(K), float(lam))
    if method == "f32_ir":
        K = torch.as_tensor(K)
        return _solve_f32_ir(torch.as_tensor(C, device=K.device), K,
                             float(lam))
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
