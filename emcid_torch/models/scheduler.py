"""Diffusion noise schedule and samplers (DDPM, DDIM, PNDM,
DPM-Solver++(2M)).

Counterpart of ``emcid_tpu/models/scheduler.py``.  ``Schedule`` holds host
numpy tables; the steps are plain tensor functions of
``(state, latents, eps, t, t_prev)`` with integer timesteps, and
``run_sampler`` is the Python loop over them (the JAX package's
``scan_sampler``), including the CFG-interval split of the loop into a
guided head and a conditional-only tail.  DDIM and DPM++ read the model
output as eps or, with ``prediction_type="v_prediction"``, as v; PNDM's
transfer reads it as eps either way, as the JAX package's does.

SD v1.x / SDXL schedule: scaled_linear betas 0.00085 -> 0.012 over 1000
steps.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from emcid_torch.profiling import each


@dataclass(frozen=True)
class Schedule:
    """Precomputed diffusion schedule tables (host numpy)."""

    betas: np.ndarray
    alphas_cumprod: np.ndarray
    num_train_timesteps: int
    prediction_type: str = "epsilon"

    @classmethod
    def scaled_linear(cls, beta_start: float = 0.00085, beta_end: float = 0.012,
                      num_train_timesteps: int = 1000,
                      prediction_type: str = "epsilon") -> "Schedule":
        betas = (np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                             num_train_timesteps) ** 2).astype(np.float64)
        alphas_cumprod = np.cumprod(1.0 - betas)
        return cls(betas.astype(np.float32),
                   alphas_cumprod.astype(np.float32),
                   num_train_timesteps, prediction_type)

    @classmethod
    def linear(cls, beta_start: float = 0.0001, beta_end: float = 0.02,
               num_train_timesteps: int = 1000) -> "Schedule":
        betas = np.linspace(beta_start, beta_end, num_train_timesteps)
        alphas_cumprod = np.cumprod(1.0 - betas)
        return cls(betas.astype(np.float32),
                   alphas_cumprod.astype(np.float32), num_train_timesteps)

    def acp(self, device) -> torch.Tensor:
        """alphas_cumprod as a float32 tensor on ``device``."""
        return torch.as_tensor(self.alphas_cumprod, device=device)


def sd_schedule() -> Schedule:
    return Schedule.scaled_linear()


def add_noise(schedule: Schedule, x0: torch.Tensor, noise: torch.Tensor,
              timesteps: torch.Tensor) -> torch.Tensor:
    """q(x_t | x_0): sqrt(acp) * x0 + sqrt(1 - acp) * eps."""
    acp = schedule.acp(x0.device)[timesteps.long()]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return (torch.sqrt(acp).reshape(shape) * x0
            + torch.sqrt(1.0 - acp).reshape(shape) * noise)


def velocity_target(schedule: Schedule, x0: torch.Tensor, noise: torch.Tensor,
                    timesteps: torch.Tensor) -> torch.Tensor:
    """v-prediction target: sqrt(acp) * eps - sqrt(1 - acp) * x0."""
    acp = schedule.acp(x0.device)[timesteps.long()]
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return (torch.sqrt(acp).reshape(shape) * noise
            - torch.sqrt(1.0 - acp).reshape(shape) * x0)


def ddim_timesteps(schedule: Schedule, num_inference_steps: int,
                   leading: bool = True) -> np.ndarray:
    """Descending inference timesteps (diffusers 'leading' spacing)."""
    step = schedule.num_train_timesteps // num_inference_steps
    if leading:
        ts = (np.arange(num_inference_steps) * step).round()[::-1] + 1
        ts = np.clip(ts, 0, schedule.num_train_timesteps - 1)
    else:
        ts = np.linspace(0, schedule.num_train_timesteps - 1,
                         num_inference_steps).round()[::-1]
    return ts.astype(np.int32)


def _ddim_transfer(schedule: Schedule, sample, eps, t: int, t_prev: int,
                   v_prediction: bool = False):
    """x0 from (sample, model output) at t, re-noised to t_prev (f32
    coefficients; set_alpha_to_one=False: the final transition targets
    acp[0]).  The output is eps, or v with ``v_prediction``."""
    acp = schedule.alphas_cumprod
    one = np.float32(1.0)
    a_t = acp[t]
    a_prev = acp[t_prev] if t_prev >= 0 else acp[0]
    if v_prediction:
        sa, sb = float(np.sqrt(a_t)), float(np.sqrt(one - a_t))
        x0 = sa * sample - sb * eps
        eps = sa * eps + sb * sample
    else:
        x0 = (sample - float(np.sqrt(one - a_t)) * eps) / float(np.sqrt(a_t))
    return float(np.sqrt(a_prev)) * x0 + float(np.sqrt(one - a_prev)) * eps


def _v_prediction(schedule: Schedule) -> bool:
    if schedule.prediction_type not in ("epsilon", "v_prediction"):
        raise ValueError(schedule.prediction_type)
    return schedule.prediction_type == "v_prediction"


def ddim_step(schedule: Schedule, latents, eps, t: int, t_prev: int):
    """Deterministic DDIM update x_t -> x_{t_prev} (eta = 0)."""
    return _ddim_transfer(schedule, latents, eps, t, t_prev,
                          _v_prediction(schedule))


def ddpm_step(schedule: Schedule, latents, eps, t: int, noise):
    """One ancestral DDPM update (variance_type "fixed_small"), x0
    clipped to [-1, 1]; ``noise`` is added for t > 0."""
    betas, acp = schedule.betas, schedule.alphas_cumprod
    one = np.float32(1.0)
    beta_t = betas[t]
    a_t = one - beta_t
    acp_t = acp[t]
    acp_prev = acp[t - 1] if t > 0 else one
    x0 = (latents - float(np.sqrt(one - acp_t)) * eps) / float(np.sqrt(acp_t))
    x0 = torch.clamp(x0, -1.0, 1.0)
    coef_x0 = float(np.sqrt(acp_prev) * beta_t / (one - acp_t))
    coef_xt = float(np.sqrt(a_t) * (one - acp_prev) / (one - acp_t))
    mean = coef_x0 * x0 + coef_xt * latents
    if t == 0:
        return mean
    var = beta_t * (one - acp_prev) / (one - acp_t)
    return mean + float(np.sqrt(var)) * noise


class PNDMState(NamedTuple):
    ets: tuple  # last (up to 4) recorded eps, oldest first
    counter: int
    cur_sample: Optional[torch.Tensor]


def pndm_init() -> PNDMState:
    return PNDMState(ets=(), counter=0, cur_sample=None)


def pndm_step(schedule: Schedule, state: PNDMState, latents, eps,
              t: int, t_prev: int) -> Tuple[PNDMState, torch.Tensor]:
    """PNDM skip-prk step (diffusers ``step_plms``): step 0 is DDIM and
    saves the sample; step 1 re-runs the first transition from the saved
    sample with the two eps averaged (its eps is not recorded); steps 2+
    are 2nd/3rd/4th-order Adams-Bashforth on the eps history."""
    c = state.counter
    ets = state.ets if c == 1 else (state.ets + (eps,))[-4:]
    if c == 0:
        eps_avg = eps
    elif c == 1:
        eps_avg = (eps + state.ets[-1]) / 2
    elif len(ets) == 2:
        eps_avg = (3 * ets[-1] - ets[-2]) / 2
    elif len(ets) == 3:
        eps_avg = (23 * ets[-1] - 16 * ets[-2] + 5 * ets[-3]) / 12
    else:
        eps_avg = (55 * ets[-1] - 59 * ets[-2] + 37 * ets[-3]
                   - 9 * ets[-4]) / 24
    sample = state.cur_sample if c == 1 else latents
    cur_sample = latents if c == 0 else state.cur_sample
    prev = _ddim_transfer(schedule, sample, eps_avg, t, t_prev)
    return PNDMState(ets=ets, counter=c + 1, cur_sample=cur_sample), prev


class DPMState(NamedTuple):
    prev_x0: Optional[torch.Tensor]
    prev_lambda: float
    counter: int


def dpmpp_init() -> DPMState:
    return DPMState(prev_x0=None, prev_lambda=0.0, counter=0)


def dpmpp_step(schedule: Schedule, state: DPMState, latents, eps,
               t: int, t_prev: int) -> Tuple[DPMState, torch.Tensor]:
    """DPM-Solver++(2M) update x_t -> x_{t_prev}; first and final steps are
    first order (``lower_order_final``)."""
    acp = schedule.alphas_cumprod
    acp_t = np.float32(acp[t])
    acp_p = np.float32(acp[t_prev]) if t_prev >= 0 else np.float32(1.0)
    a_t, s_t = np.sqrt(acp_t), np.sqrt(np.float32(1.0) - acp_t)
    a_p = np.sqrt(acp_p)
    s_p = np.sqrt(np.maximum(np.float32(1.0) - acp_p, np.float32(1e-20)))
    if _v_prediction(schedule):
        x0 = float(a_t) * latents - float(s_t) * eps
    else:
        x0 = (latents - float(s_t) * eps) / float(a_t)
    lam_t = np.log(a_t) - np.log(s_t)
    lam_p = np.log(a_p) - np.log(s_p)
    h = lam_p - lam_t
    em1 = float(np.exp(-h) - np.float32(1.0))
    ratio = float(s_p / s_t)
    if state.counter > 0 and t_prev >= 0:
        h_prev = lam_t - np.float32(state.prev_lambda)
        r0 = h_prev / np.maximum(h, np.float32(1e-12))
        d1 = (x0 - state.prev_x0) / float(np.maximum(r0, np.float32(1e-12)))
        prev = ratio * latents - float(a_p) * em1 * (x0 + 0.5 * d1)
    else:
        prev = ratio * latents - float(a_p) * em1 * x0
    return DPMState(prev_x0=x0, prev_lambda=float(lam_t),
                    counter=state.counter + 1), prev


def run_sampler(sampler: str, schedule: Schedule,
                unet_eps: Callable, latents: torch.Tensor,
                ts: np.ndarray, ts_prev: np.ndarray,
                unet_eps_tail: Optional[Callable] = None,
                n_head: Optional[int] = None) -> torch.Tensor:
    """The inference loop.  ``unet_eps(lat, t)`` is the (CFG-merged) noise
    model; steps from ``n_head`` on use ``unet_eps_tail`` (the CFG-interval
    split), with the sampler state carried across the boundary.  Each
    evaluation and its transfer is one ``sampler.step`` span."""
    ts, ts_prev = list(map(int, ts)), list(map(int, ts_prev))
    ts_eval = ts
    if sampler == "pndm" and len(ts) > 1:
        # diffusers skip-prk: evaluations t0, t1, t1, t2, ...; transfers
        # (t0->t1), (t0->t1), (t1->t2), ...
        ts_eval = ts[:1] + ts[1:2] + ts[1:]
        ts = ts[:1] + ts[:1] + ts[1:]
        ts_prev = ts_prev[:1] + ts_prev[:1] + ts_prev[1:]
        if n_head is not None:
            n_head = int(n_head) + 1
    if unet_eps_tail is None or n_head is None or n_head >= len(ts):
        n_head = len(ts)
    else:
        n_head = max(int(n_head), 1)

    if sampler == "ddim":
        for i, (t, tp) in each("sampler.step", enumerate(zip(ts, ts_prev))):
            fn = unet_eps if i < n_head else unet_eps_tail
            latents = ddim_step(schedule, latents, fn(latents, t), t, tp)
        return latents
    if sampler == "pndm":
        state, step = pndm_init(), pndm_step
    elif sampler == "dpm++":
        state, step = dpmpp_init(), dpmpp_step
    else:
        raise ValueError(f"unknown sampler {sampler!r}")
    for i, (te, t, tp) in each("sampler.step",
                               enumerate(zip(ts_eval, ts, ts_prev))):
        fn = unet_eps if i < n_head else unet_eps_tail
        state, latents = step(schedule, state, latents, fn(latents, te), t, tp)
    return latents


# -- flow matching (SD3) -------------------------------------------------------


def flow_shift(sigmas, shift: float):
    """SD3's timestep shift: s' = shift * s / (1 + (shift - 1) * s)."""
    return shift * sigmas / (1 + (shift - 1) * sigmas)


def flow_train_sigmas(shift: float = 3.0, num_train_timesteps: int = 1000
                      ) -> np.ndarray:
    """diffusers ``FlowMatchEulerDiscreteScheduler``'s training table
    (float32, descending): sigma_i = shift((N - i) / N), i = 0 .. N - 1;
    the model's timestep at entry i is 1000 * sigma_i."""
    n = num_train_timesteps
    t = torch.from_numpy(np.linspace(1, n, n, dtype=np.float32)[::-1].copy())
    return flow_shift(t / n, shift).numpy()


def flow_sigmas(num_inference_steps: int, shift: float = 3.0,
                num_train_timesteps: int = 1000) -> np.ndarray:
    """Inference sigmas, (steps + 1,) float32, as diffusers' non-dynamic
    ``set_timesteps``: with the training table's ends s_max = sigma_0 and
    s_min = sigma_{N-1},

        sigmas = shift(linspace(s_max, s_min, steps))   (float64)

    cast to float32, then 0 appended.  The model's timestep at step i is
    float32(1000 * sigmas[i])."""
    table = flow_train_sigmas(shift, num_train_timesteps)
    n = num_train_timesteps
    ts = np.linspace(float(table[0]) * n, float(table[-1]) * n,
                     num_inference_steps)
    s = flow_shift(ts / n, shift).astype(np.float32)
    return np.concatenate([s, np.zeros(1, np.float32)])


def flow_timestep(sigma) -> float:
    """The model's timestep at ``sigma``: 1000 * sigma in float32."""
    return float(np.float32(sigma) * np.float32(1000.0))


def flow_add_noise(x0: torch.Tensor, noise: torch.Tensor,
                   sigmas: torch.Tensor) -> torch.Tensor:
    """x_t = (1 - sigma) * x0 + sigma * noise, sigma per leading row."""
    s = sigmas.reshape((-1,) + (1,) * (x0.dim() - 1))
    return (1.0 - s) * x0 + s * noise


def flow_velocity(x0: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """The flow-matching target v = noise - x0."""
    return noise - x0


def flow_euler_step(latents: torch.Tensor, v: torch.Tensor, sigma,
                    sigma_next) -> torch.Tensor:
    """x += (sigma_next - sigma) * v, the difference taken in float32."""
    dt = float(np.float32(sigma_next) - np.float32(sigma))
    return latents.float() + dt * v.float()


def run_flow_sampler(model_v: Callable, latents: torch.Tensor,
                     sigmas: np.ndarray, model_v_tail: Optional[Callable] = None,
                     n_head: Optional[int] = None) -> torch.Tensor:
    """Flow-matching Euler over ``sigmas`` (``flow_sigmas``).
    ``model_v(lat, t)`` is the (CFG-merged) velocity at the model timestep
    ``t``; steps from ``n_head`` on use ``model_v_tail`` (the CFG-interval
    split).  Each evaluation and its step is one ``sampler.step`` span."""
    steps = len(sigmas) - 1
    if model_v_tail is None or n_head is None or n_head >= steps:
        n_head = steps
    for i in each("sampler.step", range(steps)):
        fn = model_v if i < max(int(n_head), 1) else model_v_tail
        v = fn(latents, flow_timestep(sigmas[i]))
        latents = flow_euler_step(latents, v, sigmas[i], sigmas[i + 1])
    return latents
