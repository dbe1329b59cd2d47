"""SD3 (Stable Diffusion 3 / 3.5) editing: the two CLIP encoders edited as
in SDXL, with the MMDiT and flow matching in Stage 1.

The edit is SDXL's (``engine/sdxl``): one delta per CLIP encoder at
``layers[-1]`` and ``layers_2[-1]``, optimized jointly, then each
encoder's Stage-2 insert.  T5 is not edited.  Stage 1 is the same loop
(``sdxl.stage1_two_encoders``) with SD3's side (``SD3Denoiser``):

* conditioning: the edited encoders' penultimate states side by side,
  zero-padded to 4096 and joined with T5's states of the same prompts on
  the token axis; pooled = [pool_1 ‖ pool_2];
* noising: a uniform index into the 1000-entry shifted training table
  (``scheduler.flow_train_sigmas``), x_t = (1 - sigma) x0 + sigma eps, the
  model's timestep 1000 sigma;
* the MMDiT's velocity; ablate-dest aligns it with the dest prompts'
  velocity (MSE), the noise term with v = eps - x0.

The draws keep ``SDXLDraws``' order (the timestep draw is the table
index).  The CUDA graphs, ``stage1.step``, ``stage1.dest`` and
``stage1.capture`` work as for SDXL; K1-K3 stay eager between replays.

``apply_emcid_sd3`` is the edit of a block with ``apply_emcid_sdxl``'s
phases, plus ``edit.t5`` (``timings["t5"]``): T5 runs once per block on
the source, dest and empty prompts, and the training images and Stage 1
read its states.  A mesh is not supported.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.engine.sdxl import (
    SDXLDraws,
    TwoEncoderDenoiser,
    execute_emcid_sd_xl_text_encoders,
    keep_z_pairs,
    load_z_pairs,
    resolve_covariances_sdxl,
    stage1_two_encoders,
    training_posteriors,
)
from emcid_torch.hparams import EMCIDXLHyperParams
from emcid_torch.models.scheduler import (
    flow_add_noise,
    flow_train_sigmas,
    flow_velocity,
)
from emcid_torch.models.sd3 import (
    SD3Components,
    encode_posterior_sd3,
    generate_sd3,
    joint_context,
    t5_states,
    velocity,
)
from emcid_torch.profiling import phase

TRAIN_GUIDANCE = 4.5  # the training images' CFG scale


class SD3Denoiser(TwoEncoderDenoiser):
    """SD3's side of the two-encoder Stage-1 loop: flow-matching noising
    and the MMDiT's velocity.  ``t5_src``/``t5_dst`` (C, P, S3, 4096) are
    T5's states of the block's source and dest prompts."""

    label = "SD3 Stage 1"

    def __init__(self, text1, text2, transformer, sigmas: torch.Tensor,
                 layers, t5_src: torch.Tensor, t5_dst: torch.Tensor):
        super().__init__(text1, text2, transformer, layers)
        self.sigmas = sigmas
        self.t5_src, self.t5_dst = t5_src, t5_dst
        self.num_train_timesteps = len(sigmas)
        self.key = (t5_src.shape[2],)

    def inputs(self, lat, noise, t, device, dtype):
        s = self.sigmas[t]
        noisy = flow_add_noise(lat, noise, s).permute(0, 3, 1, 2)
        noisy = noisy.to(device, dtype, memory_format=torch.contiguous_format)
        return (noisy, (s * 1000.0).to(device),
                flow_velocity(lat, noise).permute(0, 3, 1, 2).to(device))

    def cond_args(self, c: int, side: str, ctx, pool1, pool2) -> Tuple:
        t5 = (self.t5_src if side == "src" else self.t5_dst)[c]
        return joint_context(ctx, t5), torch.cat([pool1, pool2], dim=-1)

    def predict(self, noisy, t, ctx, pooled) -> torch.Tensor:
        return velocity(self.net, noisy, t, ctx, pooled)


def compute_z_sd3_text_encoders(
    components: SD3Components,
    requests: Sequence[Dict],
    hparams: EMCIDXLHyperParams,
    latents_mean,
    latents_logvar,
    t5_src: torch.Tensor,
    t5_dst: torch.Tensor,
    gen: Optional[torch.Generator] = None,
    replay: Optional[SDXLDraws] = None,
    verbose: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Joint two-delta Stage 1 of an SD3 concept block, on one device ->
    (zs_1 (C, T, H1), zs_2 (C, T, H2)).  ``latents_mean``/
    ``latents_logvar``: the scaled training-image posterior (C, Simg, P,
    h, w, c); ``t5_src``/``t5_dst`` (C, P, S3, 4096): T5's states of the
    source and dest prompts."""
    dev = components.device
    den = SD3Denoiser(
        components.text_encoder, components.text_encoder_2,
        components.transformer,
        torch.as_tensor(flow_train_sigmas(components.shift), device=dev),
        (hparams.layers[-1], hparams.layers_2[-1]), t5_src, t5_dst)
    return stage1_two_encoders(den, components, requests, hparams,
                               latents_mean, latents_logvar, gen=gen,
                               replay=replay, verbose=verbose)


def block_t5(components: SD3Components, requests: Sequence[Dict]
             ) -> Dict[str, torch.Tensor]:
    """T5's states of a block, one forward: ``src`` and ``dst`` (C, P, S3,
    D) of the source and dest prompts, ``empty`` (1, S3, D) of the empty
    prompt."""
    C, P = len(requests), len(requests[0]["prompts"])
    texts = ([t.format(r["source"]) for r in requests for t in r["prompts"]]
             + [t.format(r["dest"]) for r in requests for t in r["prompts"]]
             + [""])
    h = t5_states(components, texts)
    return {"src": h[:C * P].reshape((C, P) + h.shape[1:]),
            "dst": h[C * P:2 * C * P].reshape((C, P) + h.shape[1:]),
            "empty": h[-1:]}


def sd3_training_latents(
    components: SD3Components,
    requests: Sequence[Dict],
    hparams,
    t5: Dict[str, torch.Tensor],
    height: int = 1024,
    width: int = 1024,
    num_inference_steps: int = 25,
    cfg_interval: Optional[float] = None,
    guidance_scale: float = TRAIN_GUIDANCE,
    verbose: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, Simg, P, h, w, c) scaled training-image posterior (mean,
    logvar): a request's ``images`` or ``training_img_paths``, else SD3
    images of its source prompts (flow-matching Euler, CFG at
    ``guidance_scale`` over the empty prompt on the first
    ``cfg_interval`` of the steps) from ``t5`` (``block_t5``) of the
    requests' rows."""
    from emcid_torch.engine.training_images import resolve_cfg_interval

    cfg_interval = resolve_cfg_interval(cfg_interval, num_inference_steps)

    def render(c, prompts, seeds):
        reps = len(prompts) // t5["src"].shape[1]
        cond = t5["src"][c].repeat((reps,) + (1,) * (t5["src"].ndim - 2))
        neg = t5["empty"].expand((len(prompts),) + t5["empty"].shape[1:])
        return generate_sd3(components, prompts, seeds,
                            num_inference_steps=num_inference_steps,
                            guidance_scale=guidance_scale, height=height,
                            width=width, cfg_interval=cfg_interval,
                            t5=(cond, neg))

    return training_posteriors(
        requests, hparams, height, render,
        lambda arr: encode_posterior_sd3(components, arr), verbose)


def apply_emcid_sd3(
    components: SD3Components,
    requests: Sequence[Dict],
    hparams: EMCIDXLHyperParams,
    mom2_weight=None,
    mom2_weight_2=None,
    edit_weight=None,
    cache_name: Optional[str] = None,
    stats_dir_1=None,
    stats_dir_2=None,
    captions: Optional[Sequence[str]] = None,
    height: int = 1024,
    width: int = 1024,
    num_inference_steps: int = 25,
    cfg_interval: Optional[float] = None,
    mesh=None,
    rng_seed: int = 0,
    timings: Optional[Dict[str, float]] = None,
    verbose: bool = True,
):
    """The SD3 edit of a block -> (deltas_1, deltas_2, edited components):
    both CLIP encoders' covariances (``resolve_covariances_sdxl``); for
    the concepts the two-file z cache lacks, T5's states (``block_t5``),
    SD3 training images (``sd3_training_latents``), then
    Stage 1 (``compute_z_sd3_text_encoders``, from ``rng_seed``; its z
    into the two-file cache) and SDXL's Stage 2
    (``sdxl.execute_emcid_sd_xl_text_encoders``).
    ``timings`` (when given) collects each phase's seconds: "covariances",
    "t5" and "generation" (only when a z is computed), "stage1",
    "stage2";
    each phase is the span ``edit.<phase>`` (``edit.train_images`` for
    "generation")."""
    if mesh is not None:
        raise NotImplementedError("the SD3 edit runs on one device: no mesh")
    timings = {} if timings is None else timings
    dev = components.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with phase("edit.covariances", timings, "covariances"):
        covs_1, covs_2 = resolve_covariances_sdxl(
            components, hparams, stats_dir_1, stats_dir_2,
            captions=captions, verbose=verbose)
        sync()
    zs_1, zs_2, missing = load_z_pairs(requests, cache_name, hparams)
    if missing:
        with phase("edit.t5", timings, "t5"):
            t5 = block_t5(components, [requests[i] for i in missing])
            sync()
        with phase("edit.train_images", timings, "generation"):
            mean, logvar = sd3_training_latents(
                components, [requests[i] for i in missing], hparams, t5,
                height=height, width=width,
                num_inference_steps=num_inference_steps,
                cfg_interval=cfg_interval, verbose=verbose)
            sync()
    with phase("edit.stage1", timings, "stage1"):
        if missing:
            z1, z2 = compute_z_sd3_text_encoders(
                components, [requests[i] for i in missing], hparams, mean,
                logvar, t5["src"], t5["dst"],
                gen=torch.Generator(device=dev).manual_seed(rng_seed),
                verbose=verbose)
            keep_z_pairs(requests, missing, z1, z2, zs_1, zs_2, cache_name,
                         hparams)
        sync()
    with phase("edit.stage2", timings, "stage2"):
        out = execute_emcid_sd_xl_text_encoders(
            components, requests, hparams, np.stack(zs_1), np.stack(zs_2),
            covs_1, covs_2, mom2_weight=mom2_weight,
            mom2_weight_2=mom2_weight_2, edit_weight=edit_weight,
            verbose=verbose)
        sync()
    return out
