"""Edit orchestration: ``apply_emcid(components, requests, hparams)``.

Counterpart of ``emcid_tpu/engine/editor.py``.  In order:

1. covariances per edited layer: stats npz cache, else the given caption
   corpus, else a synthetic corpus (the product's offline fallback);
2. per-concept z vectors: z cache, else Stage 1 in concept blocks on
   generated training images;
3. the one-pass Stage-2 insert.

Returns (edited components, deltas); the given components are unchanged.
The product defaults of the JAX package hold, with the same restore
knobs: DPM++ training images at <= 25 steps (``train_sampler="pndm"``
restores), the K=25 eps_dest pool (``eps_dest_pool=0``; the default K is
read from ``EMCID_TPU_EPS_POOL`` as in the JAX package), the cosine z
schedule (``z_sched="const"`` / ``EMCID_TPU_Z_SCHED=const``), CFG interval
0.6 (``cfg_interval=1.0`` / ``EMCID_TPU_CFG_INTERVAL=1.0``) and 384-px
training at the native-512 shape (``train_res=512`` /
``EMCID_TPU_TRAIN_RES=0``).
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.engine.compute_z import (
    ZOptimizer,
    check_supported,
    concept_batch_to_device,
    prepare_concept_batch,
)
from emcid_torch.engine.emcid import (
    execute_emcid_text_encoder,
    load_z_list,
    save_z_cache,
)
from emcid_torch.engine.layer_stats import get_cov_text_encoder
from emcid_torch.engine.training_images import training_latents_for_requests
from emcid_torch.globals_cfg import STATS_DIR
from emcid_torch.models.pipeline import SDComponents

EPS_DEST_POOL = 25  # product default pool size


def resolve_covariances_for(
    text_encoder,
    tokenizer,
    hparams,
    stats_dir=None,
    captions: Optional[Sequence[str]] = None,
    allow_synthetic: bool = True,
    model_name: str = "text_encoder",
    verbose: bool = True,
) -> List[torch.Tensor]:
    """Per-layer second moments: cache -> given captions -> synthetic."""
    covs = []
    for layer in hparams.layers:
        layer_name = hparams.rewrite_module_tmp.format(layer)
        try:
            C = get_cov_text_encoder(
                text_encoder, tokenizer, layer_name,
                mom2_dataset=hparams.mom2_dataset,
                mom2_n_samples=hparams.mom2_n_samples,
                mom2_dtype=hparams.mom2_dtype,
                stat_dir=stats_dir or STATS_DIR, captions=captions,
                model_name=model_name, verbose=verbose)
        except FileNotFoundError:
            if not allow_synthetic:
                raise
            if verbose:
                print(f"[emcid_torch] no stats cache for {layer_name} and no "
                      "caption corpus: computing the covariance over a "
                      "synthetic corpus (offline fallback)")
            from emcid_torch.dsets.stat_dataset import make_synthetic_captions

            n = min(hparams.mom2_n_samples, 2000)
            C = get_cov_text_encoder(
                text_encoder, tokenizer, layer_name,
                mom2_dataset="synthetic", mom2_n_samples=n,
                mom2_dtype=hparams.mom2_dtype,
                stat_dir=stats_dir or STATS_DIR,
                captions=make_synthetic_captions(n),
                model_name=model_name, verbose=verbose)
        covs.append(C)
    return covs


def resolve_train_res(components: SDComponents,
                      train_res: Optional[int] = None) -> int:
    """Training-image resolution: explicit ``train_res`` >
    ``EMCID_TPU_TRAIN_RES`` (0 = native) > 384 at the native-512 shape,
    native otherwise.  Must survive the UNet's stride-2 chain."""
    native = components.unet.config.sample_size * components.vae_scale
    if train_res is None:
        env = os.environ.get("EMCID_TPU_TRAIN_RES")
        if env is not None:
            train_res = int(env or 0)
        else:
            train_res = 384 if native == 512 else 0
    if not train_res:
        return int(native)
    factor = components.vae_scale * (
        2 ** (len(components.unet.config.block_out_channels) - 1))
    if train_res % factor:
        raise ValueError(
            f"train_res={train_res} must be divisible by "
            f"vae_scale * 2^n_downsamples = {factor}")
    return int(train_res)


def compute_zs_for_requests(
    components: SDComponents,
    requests: Sequence[Dict],
    hparams,
    cache_name: Optional[str] = None,
    block_size: int = 8,
    rng_seed: int = 0,
    num_inference_steps: int = 50,
    train_sampler: str = "dpm++",
    train_steps: Optional[int] = None,
    eps_dest_pool: Optional[int] = None,
    z_sched: Optional[str] = None,
    cfg_interval: Optional[float] = None,
    train_res: Optional[int] = None,
    timings: Optional[Dict[str, float]] = None,
    verbose: bool = True,
) -> np.ndarray:
    """All concepts' z vectors (R, T, H): z-cache hits plus Stage-1 runs in
    blocks of ``block_size`` concepts.  ``timings`` (when given) collects
    the seconds spent generating training images ("generation") and
    optimizing ("stage1")."""
    check_supported(hparams)
    z_list, missing = load_z_list(requests, cache_name, hparams)
    if missing:
        if eps_dest_pool is None:
            # the pool pays only when it amortizes over more steps than K
            K = int(os.environ.get("EMCID_TPU_EPS_POOL", EPS_DEST_POOL))
            eps_dest_pool = K if hparams.v_num_grad_steps > K else 0
        if z_sched is None:
            z_sched = os.environ.get("EMCID_TPU_Z_SCHED", "cosine")
        optz = ZOptimizer(components.text_encoder, components.unet,
                          components.schedule, hparams,
                          layer=hparams.layers[-1],
                          eps_pool=int(eps_dest_pool), lr_sched=z_sched)
        res = resolve_train_res(components, train_res)
        if train_steps is None:
            train_steps = (min(num_inference_steps, 25)
                           if train_sampler == "dpm++"
                           else num_inference_steps)
        dev = components.device
        for start in range(0, len(missing), block_size):
            idxs = missing[start:start + block_size]
            block = [requests[i] for i in idxs]
            # multi-block runs pad every block to block_size
            target = block_size if len(missing) > block_size else len(block)
            pad = target - len(block)
            block = block + [block[-1]] * pad
            sync = torch.cuda.synchronize if dev.type == "cuda" else (
                lambda: None)
            t0 = time.time()
            mean, logvar = training_latents_for_requests(
                components, block, hparams, height=res, width=res,
                num_inference_steps=train_steps, sampler=train_sampler,
                cfg_interval=cfg_interval, verbose=verbose)
            sync()
            t1 = time.time()
            arrays, _, _ = prepare_concept_batch(components.tokenizer, block,
                                                 hparams)
            arrays["latents_mean"] = mean
            arrays["latents_logvar"] = logvar
            batch = concept_batch_to_device(arrays, dev)
            gen = torch.Generator(device=dev).manual_seed(rng_seed + start)
            zs, _, _, losses = optz.run(batch, gen)
            zs = zs.cpu().numpy()[: len(idxs)]
            t2 = time.time()
            if timings is not None:
                timings["generation"] = timings.get("generation", 0.0) + t1 - t0
                timings["stage1"] = timings.get("stage1", 0.0) + t2 - t1
            for k, i in enumerate(idxs):
                z_list[i] = zs[k]
                if cache_name is not None:
                    save_z_cache(cache_name, requests[i], zs[k], hparams,
                                 idx=i)
            if verbose:
                final = (f"{float(losses[-1]):.5f}" if len(losses)
                         else "n/a (0 steps)")
                print(f"stage1 block {start // block_size}: {len(idxs)} "
                      f"concepts in {t2 - t0:.1f}s (incl. image gen), "
                      f"final loss {final}")
    stacked = np.stack([np.asarray(z) for z in z_list])
    if stacked.ndim == 2:
        stacked = stacked[:, None, :]
    return stacked


def apply_emcid(
    components: SDComponents,
    requests: Sequence[Dict],
    hparams,
    mom2_weight: Optional[float] = None,
    edit_weight: Optional[float] = None,
    cache_name: Optional[str] = None,
    stats_dir=None,
    stats_captions: Optional[Sequence[str]] = None,
    block_size: int = 8,
    solve_method: str = "f32_ir",
    num_inference_steps: int = 50,
    mesh=None,
    clip_align=None,
    train_sampler: str = "dpm++",
    train_steps: Optional[int] = None,
    eps_dest_pool: Optional[int] = None,
    z_sched: Optional[str] = None,
    cfg_interval: Optional[float] = None,
    train_res: Optional[int] = None,
    rng_seed: int = 0,
    timings: Optional[Dict[str, float]] = None,
    verbose: bool = True,
) -> Tuple[SDComponents, Dict]:
    """Full two-stage edit of a pipeline's text encoder -> (edited
    components, deltas).  ``timings`` (when given) collects the seconds of
    each phase: "covariances", "generation", "stage1", "stage2"."""
    if mesh is not None:
        raise NotImplementedError("mesh= sharding (ROADMAP M14)")
    if clip_align is not None:
        raise NotImplementedError("txt-img-align (ROADMAP M9)")
    check_supported(hparams)
    timings = {} if timings is None else timings
    dev = components.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.time()
    covs = resolve_covariances_for(
        components.text_encoder, components.tokenizer, hparams,
        stats_dir=stats_dir, captions=stats_captions, verbose=verbose)
    sync()
    timings["covariances"] = time.time() - t0
    zs = compute_zs_for_requests(
        components, requests, hparams, cache_name=cache_name,
        block_size=block_size, num_inference_steps=num_inference_steps,
        train_sampler=train_sampler, train_steps=train_steps,
        eps_dest_pool=eps_dest_pool, z_sched=z_sched,
        cfg_interval=cfg_interval, train_res=train_res, rng_seed=rng_seed,
        timings=timings, verbose=verbose)
    t1 = time.time()
    deltas, new_text = execute_emcid_text_encoder(
        components.text_encoder, components.tokenizer, requests, hparams,
        zs=zs, covs=covs, mom2_weight=mom2_weight, edit_weight=edit_weight,
        solve_method=solve_method, verbose=verbose)
    sync()
    timings["stage2"] = time.time() - t1
    if verbose:
        print(f"Edited {len(requests)} concept(s) across layers "
              f"{list(hparams.layers)} in {time.time() - t0:.1f}s")
    return components.replace_text_encoder(new_text), deltas
