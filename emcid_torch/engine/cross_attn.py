"""Cross-attention K/V editing mode.

Counterpart of ``emcid_tpu/engine/cross_attn.py``.  Every ``attn2.to_k`` /
``attn2.to_v`` projection of the UNet reads the same input, the text
encoder's final hidden states, so:

* the Stage-2 keys are the prompt-averaged final text states at the fact
  tokens (``get_cross_attn_keys``): no UNet forward;
* the covariance is one statistic E[h h^T] over caption text states
  (``layer_stats_cross_attn_kv``), cached per projection name with
  ``model_name="unet"`` in the text pre-cache's path codec;
* each projection's current output at the keys is ``K W^T``.

Stage 1 (``compute_z_unet_x_kv``) optimizes one delta per projection (32 on
SD), added to that projection's output at the fact-token rows through
``models.unet.unet_inject``, jointly under the diffusion noise loss against
an esd or SLD target built from forwards of the unedited UNet.  Stage 2
(``execute_emcid_cross_attn``) solves each projection on its own, with no
residual spreading.

JAX quirks kept: the weight-decay term is divided by the number of
projections (``reg / len(kv_names)``); the covariance count is the number
of real tokens while the padded rows add zeros to the moment.

Record/replay: ``compute_z_unet_x_kv(replay=XKVDraws(...))`` gives every
step's training-image index, posterior draw, noise and timesteps; the
generator is then not read.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.engine.compute_z import _f32, adam_step_, clamp_to_ball_
from emcid_torch.engine.extract import (
    RequestBatch,
    gather_at_tokens,
    per_request_mean,
    prepare_request_batch,
)
from emcid_torch.engine.layer_stats import stats_filename
from emcid_torch.engine.uce import _with_new_weights, cross_attn_kv_layer_names
from emcid_torch.models.pipeline import SDComponents, encode_prompts
from emcid_torch.models.scheduler import add_noise
from emcid_torch.models.unet import unet_inject
from emcid_torch.ops.solve import solve_adj_k, upd_matrix_match_shape
from emcid_torch.runtime import precise_matmuls
from emcid_torch.stats import CombinedStat, SecondMoment, tally

# SLD supervision: (guidance scale, threshold) per sld_type
SLD_TYPES = {"max": (5000.0, 1.0), "strong": (2000.0, 0.025)}


class XKVDraws(NamedTuple):
    """The Stage-1 draws of every step (leading axes (steps, P)): the
    training-image index, the posterior's standard normal draw and the
    noise (channel-last latents), the timestep."""

    img_idx: Any  # (steps, P) int
    post_eps: Any  # (steps, P, h, w, c)
    noise: Any  # (steps, P, h, w, c)
    timesteps: Any  # (steps, P) int


@torch.no_grad()
def get_cross_attn_keys(components: SDComponents, requests: Sequence[Dict],
                        num_fact_tokens: int = 1
                        ) -> Tuple[torch.Tensor, RequestBatch]:
    """Prompt-averaged final text states at the fact tokens: (R, T, H)
    f32 on the device, and the request batch."""
    batch = prepare_request_batch(components.tokenizer, requests,
                                  num_fact_tokens=num_fact_tokens)
    dev = components.device
    hidden = components.text_encoder(
        torch.as_tensor(batch.input_ids, device=dev).long()).last_hidden_state
    keys = per_request_mean(
        gather_at_tokens(hidden.float(), torch.as_tensor(
            batch.lookup_indices, device=dev).long()),
        torch.as_tensor(batch.seg_matrix, device=dev))
    return keys, batch


def layer_stats_cross_attn_kv(
    components: SDComponents,
    layer_name: str,
    captions: Optional[Sequence[str]] = None,
    stats_dir="data/stats",
    ds_name: str = "ccs_filtered",
    sample_size: Optional[int] = None,
    precision: str = "float32",
    batch_size: int = 64,
    force_recompute: bool = False,
) -> CombinedStat:
    """Second moment of caption text states (the K/V projections' shared
    input), cached under ``layer_name`` (``model_name="unet"``)."""
    filename = stats_filename(stats_dir, "unet", ds_name, layer_name,
                              precision, ("mom2",), 3 * 1024, sample_size)
    stat = CombinedStat(mom2=SecondMoment())
    if captions is None and not filename.exists():
        raise FileNotFoundError(f"stats cache {filename} missing")
    loader = tally(stat, list(captions or []),
                   cache=(str(filename) if not force_recompute else None),
                   sample_size=sample_size, batch_size=batch_size,
                   random_sample=1, quiet=True)
    tok, dev = components.tokenizer, components.device
    for texts in loader:
        enc = tok(texts, padding="max_length", truncation=True,
                  max_length=tok.model_max_length)
        ids = torch.as_tensor(np.asarray(enc["input_ids"]), device=dev).long()
        mask = np.asarray(enc["attention_mask"])
        mask_t = torch.as_tensor(mask, device=dev).long()
        with torch.no_grad():
            h = components.text_encoder(ids, mask_t).last_hidden_state.float()
        feats = h * mask_t.float()[..., None]
        # every row is added, the padded ones as zeros; the count is the
        # real tokens'
        stat.mom2.add(feats.reshape(-1, feats.shape[-1]),
                      n_valid=int(mask.sum()))
    return stat


def compute_z_unet_x_kv(
    components: SDComponents,
    request: Dict,
    hparams,
    latents_mean,
    latents_logvar,
    gen: Optional[torch.Generator] = None,
    mesh=None,
    replay: Optional[XKVDraws] = None,
    verbose: bool = True,
) -> Dict[str, np.ndarray]:
    """Jointly optimize one delta per K/V projection for one concept.
    ``latents_mean``/``latents_logvar``: the scaled training-image
    posterior (Simg, P, h, w, c).  Returns {projection name: v* (T, out)},
    the post-edit target output of each projection at the fact tokens.

    Per step: a training image per prompt, a posterior draw, noise and a
    timestep; the target is ``eps_unc - mu (eps_src - eps_unc)`` (esd) or
    SLD's ``eps_src - (eps_safe - eps_unc) * safety_scale``, from forwards
    of the unedited UNet; the loss is the MSE of the edited forward against
    it plus ``sum_l wd |d_l| / |z0_l|^2`` over the projections, divided by
    their number.  Adam, then each delta clamped to
    ``clamp_norm_factor * |z0_l|``."""
    hp = hparams
    if mesh is not None:
        raise NotImplementedError("mesh= sharding (ROADMAP M14)")
    unet, schedule = components.unet, components.schedule
    dev, dtype = components.device, components.dtype
    kv_names = cross_attn_kv_layer_names(unet)
    keys, batch = get_cross_attn_keys(components, [request],
                                      hp.num_edit_tokens)
    P, S = batch.input_ids.shape
    tok_mask = torch.zeros((P, S), device=dev)
    rows = torch.arange(P, device=dev)[:, None]
    lookup = torch.as_tensor(batch.lookup_indices, device=dev).long()
    tok_mask[rows, lookup] = 1.0

    sld = bool(getattr(hp, "sld_supervision", False))
    if sld:
        sld_type = getattr(hp, "sld_type", "max") or "max"
        if sld_type not in SLD_TYPES:
            raise ValueError(f"sld_type {sld_type} not supported")
        sld_gs, sld_thr = SLD_TYPES[sld_type]
    else:
        esd_mu = getattr(hp, "esd_mu", None)
        if hp.objective != "esd" or esd_mu in (None, "None"):
            raise ValueError(
                "compute_z_unet_x_kv supports only the two supervision "
                "modes: hparams.sld_supervision, or objective='esd' with "
                "esd_mu")
        mu = float(esd_mu)
    with torch.no_grad():
        ctx_src = components.text_encoder(torch.as_tensor(
            batch.input_ids, device=dev).long()).last_hidden_state
        ctx_unc = encode_prompts(components, [""] * P)
        if sld:
            ctx_safe = encode_prompts(components, [request["safe_words"]] * P)
        with precise_matmuls():
            z0 = {n: keys[0] @ unet.get_submodule(n).weight.float().T
                  for n in kv_names}  # (T, out)
    z0n = {n: z0[n][0].norm() for n in kv_names}

    mean = _f32(latents_mean, dev)
    logvar = _f32(latents_logvar, dev)
    Simg = mean.shape[0]
    if replay is not None:
        replay = XKVDraws(*(_f32(a, dev) for a in replay))
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    pr = torch.arange(P, device=dev)
    deltas = {n: torch.zeros(z0[n].shape[-1], device=dev) for n in kv_names}
    moments = {n: (torch.zeros_like(d), torch.zeros_like(d))
               for n, d in deltas.items()}
    wd = float(hp.v_weight_decay)
    losses = []
    for step in range(int(hp.v_num_grad_steps)):
        if replay is not None:
            img, eps = replay.img_idx[step].long(), replay.post_eps[step]
            noise, t = replay.noise[step], replay.timesteps[step].long()
        else:
            img = torch.randint(0, Simg, (P,), generator=gen, device=dev)
            eps = torch.randn(mean.shape[1:], generator=gen, device=dev)
            noise = torch.randn(mean.shape[1:], generator=gen, device=dev)
            t = torch.randint(0, schedule.num_train_timesteps, (P,),
                              generator=gen, device=dev)
        lat = mean[img, pr] + torch.exp(0.5 * logvar[img, pr]) * eps
        noisy = add_noise(schedule, lat, noise, t).permute(0, 3, 1, 2)
        noisy = noisy.to(dtype)
        with torch.no_grad():
            pred_src = unet(noisy, t, ctx_src).sample.float()
            pred_unc = unet(noisy, t, ctx_unc).sample.float()
            if sld:
                pred_safe = unet(noisy, t, ctx_safe).sample.float()
                diff = pred_src - pred_safe
                scale = torch.clamp(diff.abs() * sld_gs, max=1.0)
                safety = torch.where(diff >= sld_thr,
                                     torch.zeros_like(scale), scale)
                target = pred_src - (pred_safe - pred_unc) * safety
            else:
                target = pred_unc - mu * (pred_src - pred_unc)
        leaves = {n: d.clone().requires_grad_() for n, d in deltas.items()}
        inject = {n: tok_mask[..., None] * d[None, None, :]
                  for n, d in leaves.items()}
        with unet_inject(unet, inject):
            eps_edit = unet(noisy, t, ctx_src).sample.float()
        mse = (eps_edit - target).pow(2).mean()
        # safe norm: its gradient at delta = 0 is 0, not NaN
        reg = sum(wd * torch.sqrt(d.pow(2).sum() + 1e-12) / z0n[n] ** 2
                  for n, d in leaves.items())
        loss = mse + reg / len(kv_names)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        with torch.no_grad():
            for (n, d), g in zip(deltas.items(), grads):
                adam_step_(d, *moments[n], g, float(hp.v_lr), step + 1)
                clamp_to_ball_(d[None], hp.clamp_norm_factor * z0n[n][None])
        losses.append(loss.detach())
    # read on the host once, at the end: the host queues the steps ahead
    if verbose and losses:
        print(f"x-kv z opt: loss {float(losses[0]):.5f} -> "
              f"{float(losses[-1]):.5f}")
    return {n: (z0[n] + deltas[n][None, :]).cpu().numpy() for n in kv_names}


def execute_emcid_cross_attn(
    components: SDComponents,
    requests: Sequence[Dict],
    hparams,
    zs_dict: Dict[str, np.ndarray],
    cov,
    mom2_weight=None,
    edit_weight=None,
    verbose: bool = True,
) -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]], SDComponents]:
    """Per-projection closed-form insert.  ``zs_dict``: {projection name:
    (R, T, out)} targets; ``cov``: the shared text-state second moment, or
    a {projection name: C} dict.  With ``alpha = edit_weight``, K is scaled
    by ``(alpha / 0.5)^0.5`` and C by ``(1 - alpha) / 0.5``; one ``adj_k``
    (f32 Cholesky refined to the float64 solve) per distinct covariance.
    Returns ({name.weight: (adj_k, sources)}, components with a new UNet
    whose other parameters are shared)."""
    hp = hparams
    lam = float(mom2_weight if mom2_weight is not None
                else hp.mom2_update_weight)
    alpha = float(edit_weight if edit_weight is not None else hp.edit_weight)
    unet, dev = components.unet, components.device
    kv_names = cross_attn_kv_layer_names(unet)
    keys, _ = get_cross_attn_keys(components, requests, hp.num_edit_tokens)
    keys = keys.reshape(-1, keys.shape[-1])  # (N, H)
    k_scale = (alpha / 0.5) ** 0.5
    cov_scale = (1.0 - alpha) / 0.5
    K_s = keys.T * k_scale

    deltas: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    new: Dict[str, torch.Tensor] = {}
    adj_cache: Dict[int, torch.Tensor] = {}
    for name in kv_names:
        C = cov[name] if isinstance(cov, dict) else cov
        ck = id(C) if isinstance(cov, dict) else 0
        if ck not in adj_cache:
            adj_cache[ck] = solve_adj_k(_f32(C, dev) * cov_scale, K_s, lam,
                                        method="f32_ir")
        adj_k = adj_cache[ck]
        w = unet.get_submodule(name).weight.float()
        with precise_matmuls():
            cur_z = (keys @ w.T).T  # (out, N)
            zs = _f32(zs_dict[name], dev).reshape(-1, w.shape[0]).T
            sources = (zs - cur_z) * k_scale
            upd = sources @ adj_k.T
        new[name] = w + upd_matrix_match_shape(upd, w.shape)
        deltas[f"{name}.weight"] = (adj_k.cpu().numpy(),
                                    sources.cpu().numpy())
        if verbose:
            print(f"{name}: z error "
                  f"{float((sources / k_scale).norm(dim=0).mean()):.4f}, "
                  f"upd norm {float(upd.norm()):.4f}")
    return deltas, components.replace_unet(_with_new_weights(unet, new))


def apply_emcid_to_cross_attn(
    components: SDComponents,
    requests: Sequence[Dict],
    hparams,
    latents_mean=None,
    latents_logvar=None,
    cov=None,
    captions: Optional[Sequence[str]] = None,
    cache_name: Optional[str] = None,
    mom2_weight=None,
    edit_weight=None,
    mesh=None,
    stats_dir="data/stats",
    verbose: bool = True,
):
    """Stage 1 per concept, with the z cache ``{cache_name}source_{s}.npz``
    (one array per projection name, the JAX package's file), then Stage 2.
    ``latents_mean``/``latents_logvar``: (C, Simg, P, h, w, c), needed only
    for concepts missing from the cache.  Without ``cov`` the covariance
    is ``layer_stats_cross_attn_kv`` over ``captions`` in ``stats_dir``."""
    kv_names = cross_attn_kv_layer_names(components.unet)
    if cov is None:
        stat = layer_stats_cross_attn_kv(
            components, kv_names[0], captions=captions, stats_dir=stats_dir,
            sample_size=len(captions or []) or None)
        cov = stat.mom2.moment().float()

    zs_dict: Dict[str, List[np.ndarray]] = {n: [] for n in kv_names}
    for idx, request in enumerate(requests):
        cached = None
        cache_full = (Path(f"{cache_name}source_{request['source']}.npz")
                      if cache_name else None)
        if cache_full is not None and cache_full.exists():
            try:
                data = np.load(cache_full)
                cached = {n: data[n] for n in kv_names}
            except Exception as e:
                print(f"Error reading cache file due to {e}. Recomputing...")
        if cached is None:
            if latents_mean is None:
                raise ValueError("latents required to compute x-kv z targets")
            cached = compute_z_unet_x_kv(
                components, request, hparams, latents_mean[idx],
                latents_logvar[idx], mesh=mesh, verbose=verbose)
            if cache_full is not None:
                cache_full.parent.mkdir(exist_ok=True, parents=True)
                np.savez(cache_full, **cached)
        for n in kv_names:
            zs_dict[n].append(np.asarray(cached[n]))
    return execute_emcid_cross_attn(
        components, requests, hparams,
        {n: np.stack(v) for n, v in zs_dict.items()}, cov,
        mom2_weight=mom2_weight, edit_weight=edit_weight, verbose=verbose)
