"""The noise schedule and the samplers the cells run: DDIM (eta 0), PNDM
with the Runge-Kutta warm-up skipped (diffusers' ``step_plms``) and
DPM-Solver++(2M) with first-order first and last steps.

SD v1.x and SDXL: scaled-linear betas 0.00085 -> 0.012 over 1000 steps,
"leading" timesteps with offset 1, the last step to ``alphas_cumprod[0]``
(``set_alpha_to_one`` false).  Coefficients in float64 on the host.
"""

from __future__ import annotations

import math
from typing import Callable, List

import numpy as np
import torch

T_TRAIN = 1000


def alphas_cumprod() -> np.ndarray:
    betas = np.linspace(0.00085 ** 0.5, 0.012 ** 0.5, T_TRAIN,
                        dtype=np.float64) ** 2
    return np.cumprod(1.0 - betas)


def timesteps(n: int) -> List[int]:
    step = T_TRAIN // n
    return [int(t) for t in (np.arange(n) * step)[::-1] + 1]


def add_noise(x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor
              ) -> torch.Tensor:
    acp = torch.as_tensor(alphas_cumprod(), device=x0.device)[t.long()]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return (acp.sqrt().reshape(shape).float() * x0
            + (1 - acp).sqrt().reshape(shape).float() * noise)


def _ddim(acp, x, eps, t: int, t_prev: int):
    a_t = float(acp[t])
    a_p = float(acp[t_prev] if t_prev >= 0 else acp[0])
    x0 = (x - (1 - a_t) ** 0.5 * eps) / a_t ** 0.5
    return a_p ** 0.5 * x0 + (1 - a_p) ** 0.5 * eps


def sample(sampler: str, eps_fn: Callable, x: torch.Tensor, n_steps: int,
           eps_tail: Callable = None, n_guided: int = None) -> torch.Tensor:
    """Run ``sampler`` for ``n_steps`` from ``x``.  ``eps_fn(x, t)`` is the
    guided model; with ``eps_tail`` the steps from ``n_guided`` on (counted
    in sampler steps) call it instead."""
    acp = alphas_cumprod()
    ts = timesteps(n_steps)
    step = T_TRAIN // n_steps
    x = x.float()

    def model(i_step, x, t):
        fn = eps_fn if (eps_tail is None or n_guided is None
                        or i_step < n_guided) else eps_tail
        return fn(x, t)

    if sampler == "ddim":
        for i, t in enumerate(ts):
            x = _ddim(acp, x, model(i, x, t), t, t - step)
        return x
    if sampler == "pndm":
        evals = ts[:1] + ts[1:2] + ts[1:]
        ets, cur = [], None
        for c, t in enumerate(evals):
            # the second evaluation repeats the first transition
            eps = model(max(c - 1, 0), x, t)
            if c == 1:
                eps_avg = (eps + ets[-1]) / 2
                x = _ddim(acp, cur, eps_avg, t + step, t)
                continue
            ets = (ets + [eps])[-4:]
            if c == 0:
                cur, eps_avg = x, eps
            elif len(ets) == 2:
                eps_avg = (3 * ets[-1] - ets[-2]) / 2
            elif len(ets) == 3:
                eps_avg = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
            else:
                eps_avg = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3]
                           - 9 * ets[-4]) / 24
            x = _ddim(acp, x, eps_avg, t, t - step)
        return x
    if sampler == "dpm++":
        prev_x0, prev_lam = None, 0.0
        for i, t in enumerate(ts):
            t_prev = t - step
            a_t, s_t = float(acp[t]) ** 0.5, float(1 - acp[t]) ** 0.5
            acp_p = float(acp[t_prev]) if t_prev >= 0 else 1.0
            a_p, s_p = acp_p ** 0.5, max(1 - acp_p, 1e-20) ** 0.5
            x0 = (x - s_t * model(i, x, t)) / a_t
            lam_t, lam_p = math.log(a_t / s_t), math.log(a_p / s_p)
            h = lam_p - lam_t
            em1 = math.expm1(-h)
            if prev_x0 is not None and t_prev >= 0:
                r0 = (lam_t - prev_lam) / h
                d = x0 + 0.5 * (x0 - prev_x0) / r0
            else:
                d = x0
            x = (s_p / s_t) * x - a_p * em1 * d
            prev_x0, prev_lam = x0, lam_t
        return x
    raise ValueError(f"sampler {sampler!r}")
