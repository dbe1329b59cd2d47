"""SDXL dual text-encoder editing.

Counterpart of ``emcid_tpu/engine/sdxl.py``.

Stage 1 (``compute_z_sdxl_text_encoders``): one delta per encoder, added
at ``layers[-1]`` of CLIP-L and ``layers_2[-1]`` of bigG, optimized
jointly against the SDXL UNet's noise loss.  The conditioning threads both
deltas (context = concat of the edited encoders' penultimate states, added
``text_embeds`` = the edited bigG pooled output), so both gradients come
from one UNet backward.  Per concept:

    loss = samp * MSE(eps_edit, noise) + (1 - samp) * MSE(eps_edit, eps_dest)
         + v_weight_decay * (|d1| / |z0_1|^2 + |d2| / |z0_2|^2)
         + ta * text_repr_loss_scale * (MSE(pool1, dest pool1)
                                        + MSE(pool2, dest pool2))

(the noise terms dropped under ``no_noise_loss``, the last term only with
``cal_text_repr_loss``); ``samp`` is 1 for ``use_sampled_noise`` or a
request's ``use_real_noise``, ``ta`` 0 for a request with ``txt_align``
False.  Adam (optax's ``adam(v_lr)``) steps the joint (d1, d2), and each
delta is clamped to ``clamp_norm_factor * |z0|``.  The JAX package vmaps
the concept loss over the block; here the concepts run one after another
inside a step (each one UNet batch of its P prompts, which bounds the
activation memory by P images at 1024 px) and one Adam step follows: the
concept losses share no parameter, so the gradients are the same.

Reference quirks kept exactly: encoder 2's source-side ids pad every
position after the first EOS with 0 (the SDXL ``tokenizer_2`` pad, which
the components do not carry); the dest-side forward of both encoders
reads the encoder-1 ids; z0 is gathered over the first prompt.

Record/replay: ``replay=SDXLDraws(...)`` gives every step's and concept's
image index, posterior draw, noise and timesteps; the generator is then
not read.

Stage 2: two independent one-pass inserts, encoder 1 with ``layers`` /
``mom2_update_weight`` and encoder 2 with ``layers_2`` /
``mom2_update_weight_2``, each through ``engine.emcid``.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.engine.compute_z import (
    adam_step_,
    clamp_to_ball_,
    prepare_concept_batch,
)
from emcid_torch.engine.emcid import execute_emcid_text_encoder, z_cache_path
from emcid_torch.hparams import EMCIDHyperParams, EMCIDXLHyperParams
from emcid_torch.models.scheduler import add_noise
from emcid_torch.models.sdxl import (
    SDXLComponents,
    generate_sdxl,
    sdxl_condition,
    sdxl_time_ids,
)
from emcid_torch.parallel import gather, replicate
from emcid_torch.parallel.distributed import is_writer


class SDXLDraws(NamedTuple):
    """The Stage-1 draws of every step and concept (leading axes
    (steps, C, P)): the training-image index, the posterior's standard
    normal draw and the noise (channel-last latents), the timestep."""

    img_idx: Any  # (steps, C, P) int
    post_eps: Any  # (steps, C, P, h, w, c)
    noise: Any  # (steps, C, P, h, w, c)
    timesteps: Any  # (steps, C, P) int


def encoder_hparams_view(hparams: EMCIDXLHyperParams, which: int
                         ) -> EMCIDHyperParams:
    """The per-encoder ``EMCIDHyperParams`` view of the XL hparams."""
    d = hparams.to_dict()
    d.pop("layers_2")
    w2 = d.pop("mom2_update_weight_2")
    if which == 2:
        d["layers"] = list(hparams.layers_2)
        d["mom2_update_weight"] = w2
    return EMCIDHyperParams.from_dict(d)


def encoder2_ids(ids: np.ndarray, eos_id: int, pad_id: int = 0
                 ) -> np.ndarray:
    """Encoder-1 ids as the SDXL ``tokenizer_2`` gives them: the same
    tokens up to the first EOS, ``pad_id`` after it."""
    eos_pos = np.argmax(ids == eos_id, axis=-1)
    after = np.arange(ids.shape[-1]) > eos_pos[..., None]
    return np.where(after, pad_id, ids).astype(ids.dtype)


def compute_z_sdxl_text_encoders(
    components: SDXLComponents,
    requests: Sequence[Dict],
    hparams: EMCIDXLHyperParams,
    latents_mean,
    latents_logvar,
    gen: Optional[torch.Generator] = None,
    height: int = 1024,
    width: int = 1024,
    mesh=None,
    replay: Optional[SDXLDraws] = None,
    verbose: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Joint two-delta Stage 1 for a concept block -> (zs_1 (C, T, H1),
    zs_2 (C, T, H2)).  ``latents_mean``/``latents_logvar``: the scaled
    training-image posterior (C, Simg, P, h, w, c).

    With ``mesh`` the concept axis shards over the mesh entries: both
    encoders and the UNet are replicated, and concept c runs its forwards
    and backward on entry ``c * mesh.size // C``.  The port's SDXL Stage 1
    already steps one concept at a time, so the block needs no padding and
    the draws keep their unsharded order.  On a mesh across processes
    every process makes every draw and runs only the concepts of its own
    entries; each concept's gradient and loss are then gathered from the
    process that ran it, so every process steps the same deltas and
    returns the same z."""
    hp = hparams
    if getattr(hp, "replace_repr", False):
        raise NotImplementedError(
            "replace_repr=True (the reference replaces the hidden state "
            "instead of adding the delta) is not implemented, as in the JAX "
            "package; no shipped hparams JSON uses it")
    text1, text2 = components.text_encoder, components.text_encoder_2
    unet, schedule = components.unet, components.schedule
    dev, dtype = components.device, components.dtype
    z1_layer, z2_layer = hp.layers[-1], hp.layers_2[-1]

    arrays, _, _ = prepare_concept_batch(components.tokenizer, requests,
                                         encoder_hparams_view(hp, 1))
    C, P, S = arrays["source_ids"].shape
    eos_id = int(getattr(components.tokenizer, "eos_token_id", None)
                 or np.max(arrays["source_ids"]))
    long = lambda a: torch.as_tensor(np.asarray(a), device=dev).long()
    f32 = lambda a: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                                    else a).to(dev, torch.float32)
    src_ids = long(arrays["source_ids"])
    src_ids_2 = long(encoder2_ids(arrays["source_ids"], eos_id))
    dest_ids = long(arrays["dest_ids"])
    mask = f32(arrays["inject_mask"])  # (C, T, P, S), both encoders
    mean, logvar = f32(latents_mean), f32(latents_logvar)
    Simg = mean.shape[1]
    tids = sdxl_time_ids(P, height, width, device=dev)
    ta_w = [1.0 if r.get("txt_align", True) else 0.0 for r in requests]
    samp_w = [1.0 if (getattr(hp, "use_sampled_noise", False)
                      or r.get("use_real_noise", False)) else 0.0
              for r in requests]
    if replay is not None:
        replay = SDXLDraws(long(replay.img_idx), f32(replay.post_eps),
                           f32(replay.noise), long(replay.timesteps))
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)

    with torch.no_grad():
        # dest side: both encoders read the encoder-1 ids
        d_ctx, d_pool1, d_pool2 = sdxl_condition(
            text1, text2, dest_ids.reshape(C * P, S))
        d_ctx = d_ctx.reshape(C, P, S, -1)
        d_pool1 = d_pool1.float().reshape(C, P, -1)
        d_pool2_in = d_pool2.reshape(C, P, -1)
        d_pool2 = d_pool2_in.float()

        def z0_for(text, layer, ids):
            out = text(ids[:, 0], capture=("layer_out",), stop_at_layer=layer)
            return torch.einsum("cts,csh->cth", mask[:, :, 0, :],
                                out.taps["layer_out"][layer].float())

        z0_1 = z0_for(text1, z1_layer, src_ids)
        z0_2 = z0_for(text2, z2_layer, src_ids_2)
    z0n_1 = z0_1.reshape(C, -1).norm(dim=-1)
    z0n_2 = z0_2.reshape(C, -1).norm(dim=-1)

    # per concept: (text1, text2, unet, device) of its mesh entry, None
    # where that entry belongs to another process
    if mesh is None:
        where = [(text1, text2, unet, dev)] * C
    else:
        reps = list(zip(replicate(text1, mesh), replicate(text2, mesh),
                        replicate(unet, mesh), mesh.devices))
        entry = [c * mesh.size // C - mesh.first for c in range(C)]
        where = [reps[e] if 0 <= e < len(reps) else None for e in entry]
    apart = mesh is not None and mesh.spans_processes

    d1, d2 = torch.zeros_like(z0_1), torch.zeros_like(z0_2)
    moments = [torch.zeros_like(d) for d in (d1, d1, d2, d2)]
    ar = torch.arange(P, device=dev)
    wd = float(hp.v_weight_decay)
    total = int(hp.v_num_grad_steps)
    step_losses = []
    for step in range(total):
        g1, g2 = torch.zeros_like(d1), torch.zeros_like(d2)
        concept_loss = torch.zeros(C, device=dev)
        for c in range(C):
            if replay is not None:
                img, eps = replay.img_idx[step, c], replay.post_eps[step, c]
                noise, t = replay.noise[step, c], replay.timesteps[step, c]
            else:
                img = torch.randint(0, Simg, (P,), generator=gen, device=dev)
                eps = torch.randn(mean.shape[2:], generator=gen, device=dev)
                noise = torch.randn(mean.shape[2:], generator=gen, device=dev)
                t = torch.randint(0, schedule.num_train_timesteps, (P,),
                                  generator=gen, device=dev)
            if where[c] is None:  # drawn, run by its own process
                continue
            lat = mean[c, img, ar] + torch.exp(0.5 * logvar[c, img, ar]) * eps
            noisy = add_noise(schedule, lat, noise, t).permute(0, 3, 1, 2)
            tx1, tx2, un, d = where[c]
            noisy, t, noise = noisy.to(d, dtype), t.to(d), noise.to(d)
            dc1 = d1[c].clone().requires_grad_()
            dc2 = d2[c].clone().requires_grad_()
            inj1 = torch.einsum("tps,th->psh", mask[c].to(d), dc1.to(d))
            inj2 = torch.einsum("tps,th->psh", mask[c].to(d), dc2.to(d))
            ctx, pool1, pool2 = sdxl_condition(
                tx1, tx2, src_ids[c].to(d), src_ids_2[c].to(d),
                inject_1=(z1_layer, inj1), inject_2=(z2_layer, inj2))
            # safe norms: their gradient at delta = 0 is 0, not NaN
            loss = wd * (torch.sqrt(dc1.pow(2).sum() + 1e-12) / z0n_1[c] ** 2
                         + torch.sqrt(dc2.pow(2).sum() + 1e-12)
                         / z0n_2[c] ** 2)
            tids_d = tids.to(d)
            if not hp.no_noise_loss:
                eps_e = un(noisy, t, ctx, {"text_embeds": pool2,
                                           "time_ids": tids_d}).sample.float()
                with torch.no_grad():
                    eps_d = un(noisy, t, d_ctx[c].to(d),
                               {"text_embeds": d_pool2_in[c].to(d),
                                "time_ids": tids_d}).sample.float()
                mse_ablate = (eps_e - eps_d).pow(2).mean()
                mse_noise = (eps_e - noise.permute(0, 3, 1, 2)).pow(2).mean()
                loss = (samp_w[c] * mse_noise + (1.0 - samp_w[c]) * mse_ablate
                        ).to(dev) + loss
            if hp.cal_text_repr_loss:
                loss = loss + ta_w[c] * hp.text_repr_loss_scale_factor * (
                    (pool1.float().to(dev) - d_pool1[c]).pow(2).mean()
                    + (pool2.float().to(dev) - d_pool2[c]).pow(2).mean())
            g1[c], g2[c] = torch.autograd.grad(loss, (dc1, dc2))
            concept_loss[c] = loss.detach()
        if apart:
            # each concept's rows from the process that ran it
            owner = torch.tensor([(c * mesh.size // C) // len(mesh.devices)
                                  for c in range(C)], device=dev)
            pick = (owner, torch.arange(C, device=dev))
            g1 = gather([g1[None]], dev, mesh)[pick]
            g2 = gather([g2[None]], dev, mesh)[pick]
            concept_loss = gather([concept_loss[None]], dev, mesh)[pick]
        step_loss = (concept_loss / C).sum()
        with torch.no_grad():
            for d, m, v, g, z0n in ((d1, *moments[:2], g1, z0n_1),
                                    (d2, *moments[2:], g2, z0n_2)):
                adam_step_(d, m, v, g, float(hp.v_lr), step + 1)
                clamp_to_ball_(d, hp.clamp_norm_factor * z0n)
        step_losses.append(step_loss)
    # read on the host once, at the end: the host queues the steps ahead
    if verbose and total:
        print(f"SDXL stage1: final loss {float(step_losses[-1]):.6f}")
    return (z0_1 + d1).cpu().numpy(), (z0_2 + d2).cpu().numpy()


def execute_emcid_sd_xl_text_encoders(
    components: SDXLComponents,
    requests: Sequence[Dict],
    hparams: EMCIDXLHyperParams,
    zs_1,
    zs_2,
    covs_1,
    covs_2,
    mom2_weight=None,
    mom2_weight_2=None,
    edit_weight=None,
    verbose: bool = True,
) -> Tuple[Dict, Dict, SDXLComponents]:
    """Two independent inserts -> (deltas_1, deltas_2, edited
    components)."""
    out = []
    for which, zs, covs, w in ((1, zs_1, covs_1, mom2_weight),
                               (2, zs_2, covs_2, mom2_weight_2)):
        out.append(execute_emcid_text_encoder(
            components.encoder(which), components.tokenizer, requests,
            encoder_hparams_view(hparams, which), zs=zs, covs=covs,
            mom2_weight=w, edit_weight=edit_weight, verbose=verbose))
    (deltas_1, text1), (deltas_2, text2) = out
    return deltas_1, deltas_2, components.replace_text_encoders(text1, text2)


def resolve_covariances_sdxl(
    components: SDXLComponents,
    hparams: EMCIDXLHyperParams,
    stats_dir_1=None,
    stats_dir_2=None,
    captions=None,
    verbose: bool = True,
):
    """Per-encoder covariances (``XL_STATS_DIR1``/``XL_STATS_DIR2`` by
    default), each with the SD path's cache -> captions -> synthetic
    fallback."""
    from emcid_torch.engine.editor import resolve_covariances_for
    from emcid_torch.globals_cfg import XL_STATS_DIR1, XL_STATS_DIR2

    return tuple(
        resolve_covariances_for(
            components.encoder(which), components.tokenizer,
            encoder_hparams_view(hparams, which), stats_dir=stats_dir,
            captions=captions, verbose=verbose)
        for which, stats_dir in ((1, stats_dir_1 or XL_STATS_DIR1),
                                 (2, stats_dir_2 or XL_STATS_DIR2)))


def sdxl_training_latents(
    components: SDXLComponents,
    requests: Sequence[Dict],
    hparams,
    height: int = 1024,
    width: int = 1024,
    num_inference_steps: int = 50,
    cfg_interval: Optional[float] = None,
    verbose: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, Simg, P, h, w, c) scaled training-image posterior (mean,
    logvar) on the device: a request's ``images`` or
    ``training_img_paths``, else SDXL images of its source prompts at
    guidance 7.5 (the reference's training-image protocol), with the SD
    path's ``resolve_cfg_interval`` default."""
    import os

    from emcid_torch.engine.training_images import (
        encode_posterior,
        preprocess_images,
        resolve_cfg_interval,
    )

    cfg_interval = resolve_cfg_interval(cfg_interval, num_inference_steps)
    Simg = getattr(hparams, "samples_per_prompt", 1)
    P = len(requests[0]["prompts"])
    imgs_all = []
    for request in requests:
        imgs = None
        if "training_img_paths" in request:
            from PIL import Image

            paths = request["training_img_paths"]
            if all(os.path.exists(pp) for pp in paths):
                imgs = [Image.open(pp) for pp in paths]
            else:
                print(f"[emcid_torch] training_img_paths missing on disk "
                      f"({paths[0]}...): falling back to generation")
        elif "images" in request:
            imgs = request["images"]
        if imgs is not None:
            arr = preprocess_images(imgs, resolution=height)
            need = Simg * P
            reps = int(np.ceil(need / len(arr)))
            arr = np.tile(arr, (reps, 1, 1, 1))[:need]
        else:
            seed0 = int(request.get("seed_train") or 0)
            prompts, seeds = [], []
            for s in range(Simg):
                for p_i, p in enumerate(request["prompts"]):
                    prompts.append(p.format(request["source"]))
                    seeds.append(seed0 * 10007 + s * 101 + p_i)
            if verbose:
                print(f"generating {len(prompts)} SDXL training images")
            imgs = generate_sdxl(components, prompts, seeds,
                                 num_inference_steps=num_inference_steps,
                                 height=height, width=width,
                                 guidance_scale=7.5,
                                 cfg_interval=cfg_interval)
            arr = imgs.astype(np.float32) / 255.0 * 2.0 - 1.0
        imgs_all.append(arr)
    mean, logvar = encode_posterior(components.sd_view(),
                                    np.concatenate(imgs_all))
    shape = (len(requests), Simg, P) + tuple(mean.shape[1:])
    return mean.reshape(shape), logvar.reshape(shape)


def z_cache_paths(cache_name: str, request: Dict, hparams
                  ) -> Tuple[Path, Path]:
    """The reference's two-file z cache: encoder 1 at
    ``source_X_dest_Y.npz``, encoder 2 at ``source_X_dest_Y_2.npz``, both
    keyed "v_star"."""
    p1 = z_cache_path(cache_name, request, hparams)
    return p1, p1.with_name(p1.stem + "_2" + p1.suffix)


def load_z_pairs(requests: Sequence[Dict], cache_name: Optional[str],
                 hparams) -> Tuple[List, List, List[int]]:
    """Cached (z_1, z_2) per request (None where either file is absent or
    unreadable) and the indices still to compute."""
    zs_1: List[Optional[np.ndarray]] = [None] * len(requests)
    zs_2: List[Optional[np.ndarray]] = [None] * len(requests)
    missing = []
    for i, request in enumerate(requests):
        if cache_name is not None:
            p1, p2 = z_cache_paths(cache_name, request, hparams)
            if p1.exists() and p2.exists():
                try:
                    zs_1[i] = np.load(p1)["v_star"]
                    zs_2[i] = np.load(p2)["v_star"]
                    continue
                except (OSError, ValueError, KeyError) as e:
                    print(f"Error reading cache file due to {e}. "
                          "Recomputing...")
        missing.append(i)
    return zs_1, zs_2, missing


def apply_emcid_to_sdxl_text_encoders(
    components: SDXLComponents,
    requests: Sequence[Dict],
    hparams: EMCIDXLHyperParams,
    latents_mean,
    latents_logvar,
    covs_1,
    covs_2,
    mom2_weight=None,
    mom2_weight_2=None,
    edit_weight=None,
    cache_name: Optional[str] = None,
    height: int = 1024,
    width: int = 1024,
    mesh=None,
    rng_seed: int = 0,
    timings: Optional[Dict[str, float]] = None,
    verbose: bool = True,
):
    """Stage 1 for the concepts the two-file z cache lacks (the cache
    written as the reference and the JAX package write it), then Stage 2
    -> (deltas_1, deltas_2, edited components).  The training-image
    posterior may be None when every z is cached.  ``timings`` (when
    given) collects "stage1" and "stage2" seconds; ``mesh`` shards Stage
    1's concept axis."""
    timings = {} if timings is None else timings
    dev = components.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    zs_1, zs_2, missing = load_z_pairs(requests, cache_name, hparams)
    t0 = time.time()
    if missing:
        if latents_mean is None or latents_logvar is None:
            raise ValueError("z vectors to compute but no training-image "
                             "posterior given")
        idx = torch.as_tensor(missing, device=torch.as_tensor(
            latents_mean).device)
        z1, z2 = compute_z_sdxl_text_encoders(
            components, [requests[i] for i in missing], hparams,
            torch.as_tensor(latents_mean)[idx],
            torch.as_tensor(latents_logvar)[idx],
            gen=torch.Generator(device=dev).manual_seed(rng_seed),
            height=height, width=width, mesh=mesh, verbose=verbose)
        for k, i in enumerate(missing):
            zs_1[i], zs_2[i] = z1[k], z2[k]
            if cache_name is not None and is_writer():
                p1, p2 = z_cache_paths(cache_name, requests[i], hparams)
                p1.parent.mkdir(exist_ok=True, parents=True)
                np.savez(p1, v_star=z1[k])
                np.savez(p2, v_star=z2[k])
    sync()
    timings["stage1"] = time.time() - t0
    t0 = time.time()
    out = execute_emcid_sd_xl_text_encoders(
        components, requests, hparams, np.stack(zs_1), np.stack(zs_2),
        covs_1, covs_2, mom2_weight=mom2_weight,
        mom2_weight_2=mom2_weight_2, edit_weight=edit_weight,
        verbose=verbose)
    sync()
    timings["stage2"] = time.time() - t0
    return out
