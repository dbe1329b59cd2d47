"""Edit orchestration: ``apply_emcid(components, requests, hparams)``.

Counterpart of ``emcid_tpu/engine/editor.py``.  In order:

1. covariances per edited layer: stats npz cache, else the given caption
   corpus, else a synthetic corpus (the product's offline fallback);
2. per-concept z vectors: z cache, else Stage 1 in concept blocks on
   generated training images;
3. the one-pass Stage-2 insert.

Returns (edited components, deltas); the given components are unchanged.
The hparams variants dispatch as in the JAX package: ``sld_supervision``
requests take the SLD-supervised per-request path
(``compute_z_variants``); a nonzero ``txt_img_align_scale_factor`` with
requests flagged ``txt_img_align`` adds the image-side alignment term
(``clip_align=(vision_model, text_projection)``); ``use_ewc`` resolves the
Fisher diagonal (``engine/fim``); ``add_uce_edit`` follows Stage 2 with the
UCE cross-attention edit (``engine/uce``).
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

import dataclasses
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
from emcid_torch.engine.fim import resolve_fim
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
    mesh=None,
    verbose: bool = True,
) -> List[torch.Tensor]:
    """Per-layer second moments: cache -> given captions -> synthetic;
    ``mesh`` shards the caption axis of a sweep."""
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
                model_name=model_name, mesh=mesh, verbose=verbose)
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
                model_name=model_name, mesh=mesh, verbose=verbose)
        covs.append(C)
    return covs


def resolve_covariances(
    components: SDComponents,
    hparams,
    stats_dir=None,
    captions: Optional[Sequence[str]] = None,
    allow_synthetic: bool = True,
    mesh=None,
    verbose: bool = True,
) -> List[torch.Tensor]:
    """Per-layer second moments for a pipeline's text encoder."""
    return resolve_covariances_for(
        components.text_encoder, components.tokenizer, hparams,
        stats_dir=stats_dir, captions=captions,
        allow_synthetic=allow_synthetic, mesh=mesh, verbose=verbose)


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


def make_optimizer(components: SDComponents, hparams, fim=None,
                   text_projection=None, eps_pool: int = 0,
                   lr_sched: str = "const") -> ZOptimizer:
    """The Stage-1 optimizer of a pipeline's last edited layer (the JAX
    package's ``_get_optimizer``, without its compile memo)."""
    return ZOptimizer(components.text_encoder, components.unet,
                      components.schedule, hparams, layer=hparams.layers[-1],
                      eps_pool=int(eps_pool), lr_sched=lr_sched, fim=fim,
                      text_projection=text_projection)


def _image_embeddings(clip_align, imgs, C: int, P: int) -> np.ndarray:
    """CLIP embeddings (C, P, E) of the first sample of each prompt's
    training images ``imgs`` ([-1, 1], (C*Simg*P, H, W, 3))."""
    from emcid_torch.models.vision import (
        CLIP_IMAGE_MEAN,
        CLIP_IMAGE_STD,
        preprocess_for_model,
    )

    vision = clip_align[0]
    px = preprocess_for_model((imgs + 1.0) / 2.0, vision.config.image_size,
                              CLIP_IMAGE_MEAN, CLIP_IMAGE_STD)
    with torch.no_grad():
        emb = vision(px).float()
    return emb.reshape(C, -1, P, emb.shape[-1])[:, 0].cpu().numpy()


def compute_zs_for_requests(
    components: SDComponents,
    requests: Sequence[Dict],
    hparams,
    cache_name: Optional[str] = None,
    block_size: int = 8,
    rng_seed: int = 0,
    num_inference_steps: int = 50,
    fim: Optional[np.ndarray] = None,
    mesh=None,
    clip_align=None,
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
    optimizing ("stage1"), or both for SLD-supervised requests ("sld").

    ``sld_supervision`` requests each take the SLD-supervised path, seeded
    ``rng_seed + i``.  Txt-img-align is active when
    ``txt_img_align_scale_factor`` is nonzero and a request carries the
    ``txt_img_align`` flag; it needs ``clip_align=(vision_model,
    text_projection (hidden, embed))``: flagged concepts train on images of
    their dest prompts, unflagged ones in the same block keep their source
    images.  ``use_ewc`` without ``fim`` resolves the Fisher diagonal from
    the last edited layer's covariance.

    With ``mesh`` the concept axis of each Stage-1 block shards over the
    mesh entries (``ZOptimizer.run(mesh=)``, which pads the block to a
    multiple of the mesh itself, so the blocks and their draws do not
    depend on the mesh), and the training images are generated sharded."""
    check_supported(hparams, mesh)
    dev = components.device
    z_list, missing = load_z_list(requests, cache_name, hparams)
    if missing and getattr(hparams, "sld_supervision", False):
        from emcid_torch.engine.compute_z_variants import (
            compute_z_text_encoder_global,
        )

        t0 = time.time()
        for i in missing:
            z = compute_z_text_encoder_global(
                components, requests[i], hparams, hparams.layers[-1],
                gen=torch.Generator(device=dev).manual_seed(rng_seed + i),
                verbose=verbose)
            z_list[i] = z
            if cache_name is not None:
                save_z_cache(cache_name, requests[i], z, hparams, idx=i)
        if timings is not None:
            timings["sld"] = time.time() - t0
        missing = []
    tia_scale = getattr(hparams, "txt_img_align_scale_factor", 0.0)
    tia_active = bool(tia_scale) and any(bool(r.get("txt_img_align"))
                                         for r in requests)
    if tia_active and clip_align is None:
        raise ValueError(
            "txt_img_align requested (hparams.txt_img_align_scale_factor="
            f"{tia_scale}, flagged requests present) but no clip_align="
            "(vision_model, text_projection) was given")
    if missing and getattr(hparams, "use_ewc", False) and fim is None:
        last_only = dataclasses.replace(hparams, layers=[hparams.layers[-1]])
        cov = resolve_covariances_for(components.text_encoder,
                                      components.tokenizer, last_only,
                                      mesh=mesh, verbose=verbose)[-1]
        fim = resolve_fim(components, hparams, cov=cov, mesh=mesh,
                          verbose=verbose)
    if missing:
        if eps_dest_pool is None:
            # the pool pays only when it amortizes over more steps than K
            K = int(os.environ.get("EMCID_TPU_EPS_POOL", EPS_DEST_POOL))
            eps_dest_pool = K if hparams.v_num_grad_steps > K else 0
        if z_sched is None:
            z_sched = os.environ.get("EMCID_TPU_Z_SCHED", "cosine")
        optz = make_optimizer(
            components, hparams, fim=fim,
            text_projection=clip_align[1] if tia_active else None,
            eps_pool=int(eps_dest_pool), lr_sched=z_sched)
        res = resolve_train_res(components, train_res)
        if train_steps is None:
            train_steps = (min(num_inference_steps, 25)
                           if train_sampler == "dpm++"
                           else num_inference_steps)
        gen_kw = dict(height=res, width=res, num_inference_steps=train_steps,
                      sampler=train_sampler, cfg_interval=cfg_interval,
                      mesh=mesh, verbose=verbose)
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
            dest_img_emb = tia_w = None
            if tia_active:
                flags = [bool(r.get("txt_img_align")) for r in block]
                mean, logvar, imgs = training_latents_for_requests(
                    components, block, hparams, use_dest_prompts=flags,
                    return_images=True, **gen_kw)
                dest_img_emb = _image_embeddings(clip_align, imgs,
                                                 len(block),
                                                 len(block[0]["prompts"]))
                tia_w = np.asarray(flags[:len(idxs)] + [False] * pad,
                                   np.float32)
            else:
                mean, logvar = training_latents_for_requests(
                    components, block, hparams, **gen_kw)
            sync()
            t1 = time.time()
            arrays, _, _ = prepare_concept_batch(components.tokenizer, block,
                                                 hparams)
            arrays["latents_mean"] = mean
            arrays["latents_logvar"] = logvar
            batch = concept_batch_to_device(arrays, dev)
            gen = torch.Generator(device=dev).manual_seed(rng_seed + start)
            zs, _, _, losses = optz.run(batch, gen, dest_img_emb=dest_img_emb,
                                        tia_weight=tia_w, mesh=mesh)
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
                from emcid_torch.profiling import StepReport, stage1_step_flops

                rep = StepReport(
                    seconds=t2 - t0,
                    steps=max(hparams.v_num_grad_steps, 1),
                    flops_per_step=stage1_step_flops(
                        components.unet.config, len(block),
                        len(block[0]["prompts"]),
                        # train_res shrinks the latent grid: report the
                        # grid Stage 1 ran on, not the native size
                        latent_hw=res // components.vae_scale,
                        eps_dest_pooled=bool(optz.eps_pool)))
                final = (f"{float(losses[-1]):.5f}" if len(losses)
                         else "n/a (0 steps)")
                print(f"stage1 block {start // block_size}: {len(idxs)} "
                      f"concepts in {rep.seconds:.1f}s ({rep}; incl. image "
                      f"gen), final loss {final}")
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
    fim_dir="data/fim_stats",
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
    each phase: "covariances", "generation", "stage1", "stage2", and "fim",
    "sld" and "uce" when those run.  ``use_ewc`` resolves the Fisher diagonal
    from the last edited layer's covariance (npz cache under ``fim_dir``,
    else computed and cached); ``add_uce_edit`` follows Stage 2 with the
    UCE edit of the UNet's cross-attention for the same concepts (dest
    " " where a request has none).  ``mesh`` shards the covariance sweep's
    caption axis, the training images and Stage 1's concept axis."""
    check_supported(hparams, mesh)
    timings = {} if timings is None else timings
    dev = components.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t0 = time.time()
    covs = resolve_covariances_for(
        components.text_encoder, components.tokenizer, hparams,
        stats_dir=stats_dir, captions=stats_captions, mesh=mesh,
        verbose=verbose)
    sync()
    timings["covariances"] = time.time() - t0
    fim = None
    if getattr(hparams, "use_ewc", False):
        t = time.time()
        fim = resolve_fim(components, hparams, cov=covs[-1], fim_dir=fim_dir,
                          mesh=mesh, verbose=verbose)
        sync()
        timings["fim"] = time.time() - t
    zs = compute_zs_for_requests(
        components, requests, hparams, cache_name=cache_name,
        block_size=block_size, num_inference_steps=num_inference_steps,
        fim=fim, mesh=mesh, clip_align=clip_align,
        train_sampler=train_sampler,
        train_steps=train_steps, eps_dest_pool=eps_dest_pool,
        z_sched=z_sched, cfg_interval=cfg_interval, train_res=train_res,
        rng_seed=rng_seed, timings=timings, verbose=verbose)
    t1 = time.time()
    deltas, new_text = execute_emcid_text_encoder(
        components.text_encoder, components.tokenizer, requests, hparams,
        zs=zs, covs=covs, mom2_weight=mom2_weight, edit_weight=edit_weight,
        solve_method=solve_method, verbose=verbose)
    sync()
    timings["stage2"] = time.time() - t1
    edited = components.replace_text_encoder(new_text)
    if getattr(hparams, "add_uce_edit", False):
        from emcid_torch.engine.uce import edit_model_uce

        t = time.time()
        edited = edit_model_uce(edited, [r["source"] for r in requests],
                                [r.get("dest") or " " for r in requests])
        sync()
        timings["uce"] = time.time() - t
        if verbose:
            print("applied UCE cross-attn hybrid edit")
    if verbose:
        print(f"Edited {len(requests)} concept(s) across layers "
              f"{list(hparams.layers)} in {time.time() - t0:.1f}s")
    return edited, deltas
