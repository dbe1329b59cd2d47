"""Fisher information for the EWC regulariser of Stage 1.

Counterpart of ``emcid_tpu/engine/fim.py``.  Per (image, caption) pair: a
random non-special token of the caption gives the fc2 input k1 of the edit
layer, and ``right_vec = adj_k = solve(lam*C + k1 k1^T, k1)`` with the
layer's cached covariance C; then for each of ``t_steps_per_pair``
(noise, timestep) draws the diffusion MSE is differentiated with respect to
the fc2 weight and

    grad_z = (dL/dW) @ right_vec        (out,)
    FIM   += grad_z ** 2                (a ``Mean`` statistic)

``dL/dW @ right_vec`` is computed as ``sum_s g_s (x_s . right_vec)``, with
``g_s`` the gradient at the layer's output (which is the gradient at the
fc2 output) and ``x_s`` the fc2 input of token s: the same sum as the
weight gradient contracted with ``right_vec``, for all draws of a pair in
one batched backward.  ``fim_draws`` is one pair's draws as a function of
explicit inputs (token index, posterior sample, noise, timesteps);
``fim_stats`` feeds it from a ``torch.Generator``.  The adj_k solve is
``ops.solve.solve_adj_k`` in its f32 mode, under ``precise_matmuls``.

The npz codec ``{module}_{precision}_mean_step{T}_{N}.npz`` and the
``CombinedStat(mean=Mean())`` state are the JAX package's, so a FIM written
by either package loads in the other.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.engine.layer_stats import _layer_index_from_name
from emcid_torch.models.scheduler import add_noise
from emcid_torch.ops.solve import solve_adj_k
from emcid_torch.stats import CombinedStat, Mean, tally, unbox_numpy_null


def fim_filename(stats_dir, model_name, ds_name, module_name,
                 precision="float32", t_steps=10, sample_size=None) -> Path:
    size_suffix = "" if sample_size is None else f"_{sample_size}"
    return Path(stats_dir) / (
        f"{model_name}/{ds_name}_stats/"
        f"{module_name}_{precision}_mean_step{t_steps}{size_suffix}.npz")


def fim_draws(components, module_name: str, input_ids, token_idx: int, cov,
              latents, noise, timesteps, mom2_weight: float = 4000
              ) -> torch.Tensor:
    """One pair's squared ``grad_z`` for each of its T draws, (T, out) f32.

    ``input_ids`` (S,) or (1, S): the caption; ``token_idx``: the token
    whose fc2 input keys the edit; ``cov`` (in, in): the layer's
    covariance; ``latents`` (h, w, c): the pair's scaled posterior sample;
    ``noise`` (T, h, w, c) and ``timesteps`` (T,): the draws."""
    text, unet = components.text_encoder, components.unet
    dev, dtype = components.device, components.dtype
    layer = _layer_index_from_name(module_name)
    ids = torch.as_tensor(np.asarray(input_ids), device=dev).long().reshape(
        1, -1)
    noise = torch.as_tensor(noise, device=dev).float()
    timesteps = torch.as_tensor(timesteps, device=dev).long()
    latents = torch.as_tensor(latents, device=dev).float()
    T, S = noise.shape[0], ids.shape[1]
    delta = torch.zeros((T, S, text.config.hidden_size), device=dev,
                        requires_grad=True)
    with torch.enable_grad():
        out = text(ids.expand(T, S), inject_layer=layer, inject_delta=delta,
                   capture=("fc2_in",))
        noisy = add_noise(components.schedule, latents.expand_as(noise),
                          noise, timesteps).permute(0, 3, 1, 2)
        pred = unet(noisy.to(dtype), timesteps,
                    out.last_hidden_state).sample.float()
        mse = (pred - noise.permute(0, 3, 1, 2)).pow(2).reshape(T, -1).mean(1)
        g, = torch.autograd.grad(mse.sum(), delta)  # (T, S, out)
    x = out.taps["fc2_in"][layer][0].detach().float()  # (S, in)
    right_vec = solve_adj_k(cov, x[token_idx][:, None], mom2_weight,
                            method="f32_ir")[:, 0]
    grad_z = torch.einsum("tso,s->to", g.float(), x @ right_vec)
    return grad_z ** 2


def fim_stats(
    components,
    module_name: str,
    pairs: Sequence[Tuple[np.ndarray, str]],
    cov,
    mom2_weight: float = 4000,
    t_steps_per_pair: int = 10,
    stats_dir="data/fim_stats",
    ds_name: str = "ccs_filtered",
    model_name: str = "text_encoder",
    precision: str = "float32",
    sample_size: Optional[int] = None,
    rng_seed: int = 0,
    force_recompute: bool = False,
    verbose: bool = False,
) -> CombinedStat:
    """Compute (or load from the npz cache) the FIM ``Mean`` statistic over
    (image [-1, 1] NHWC, caption) pairs; ``cov`` is the fc2 covariance."""
    filename = fim_filename(stats_dir, model_name, ds_name, module_name,
                            precision, t_steps_per_pair, sample_size)
    stat = CombinedStat(mean=Mean())
    loader = tally(
        stat, list(pairs),
        cache=(str(filename) if not force_recompute else None),
        sample_size=sample_size, batch_size=1, random_sample=1,
        quiet=not verbose, collate_fn=lambda items: items[0])
    tok, vae = components.tokenizer, components.vae
    dev = components.device
    cov = torch.as_tensor(np.asarray(cov) if not torch.is_tensor(cov)
                          else cov, device=dev).float()
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    n_train_ts = components.schedule.num_train_timesteps
    for img, caption in loader:
        enc = tok([caption], padding="max_length", truncation=True,
                  max_length=tok.model_max_length)
        n_real = int(np.asarray(enc["attention_mask"][0]).sum())
        token_idx = int(torch.randint(1, max(n_real - 1, 2), (1,),
                                      generator=gen, device=dev))
        with torch.no_grad():
            x = torch.as_tensor(np.asarray(img, np.float32), device=dev)
            dist = vae.encode(x[None].permute(0, 3, 1, 2).to(
                components.dtype))
            std = torch.exp(0.5 * torch.clamp(dist.logvar.float(), -30.0,
                                              20.0))
            post = dist.mean.float() + std * torch.randn(
                std.shape, generator=gen, device=dev)
            latents = (post * components.scaling_factor)[0].permute(1, 2, 0)
        noise = torch.randn((t_steps_per_pair,) + tuple(latents.shape),
                            generator=gen, device=dev)
        ts = torch.randint(0, n_train_ts, (t_steps_per_pair,), generator=gen,
                           device=dev)
        sq = fim_draws(components, module_name, enc["input_ids"][0],
                       token_idx, cov, latents, noise, ts, mom2_weight)
        stat.add(sq.cpu().numpy().astype(precision))
    return stat


def make_fim_pairs(components, captions: Sequence[str], seed: int = 0,
                   num_inference_steps: int = 25, sampler: str = "dpm++",
                   height: int = 512, width: int = 512,
                   batch_size: Optional[int] = None, mesh=None):
    """(image [-1, 1] NHWC, caption) pairs, each caption generated with the
    frozen pipeline (the offline stand-in for a downloaded image set);
    ``mesh`` shards the generation."""
    from emcid_torch.models.pipeline import generate

    captions = list(captions)
    imgs = generate(components, captions,
                    [seed + i for i in range(len(captions))],
                    batch_size=batch_size, mesh=mesh,
                    num_inference_steps=num_inference_steps, sampler=sampler,
                    height=height, width=width)
    arr = imgs.astype(np.float32) / 255.0 * 2.0 - 1.0
    return list(zip(arr, captions))


def fim_candidates(hparams, fim_dir="data/fim_stats") -> list:
    """The cache files ``resolve_fim`` reads, in order: the edit layer's
    file at (step10, 3000), then unsized, then at ``EMCID_TPU_FIM_PAIRS``
    pairs, then the layer-10 file of a stats bundle from the reference."""
    module_name = hparams.rewrite_module_tmp.format(hparams.layers[-1])
    ds = getattr(hparams, "mom2_dataset", "ccs_filtered")
    n_pairs = int(os.environ.get("EMCID_TPU_FIM_PAIRS", 64))
    return [
        fim_filename(fim_dir, "text_encoder", ds, module_name,
                     "float32", 10, 3000),
        fim_filename(fim_dir, "text_encoder", ds, module_name,
                     "float32", 10, None),
        fim_filename(fim_dir, "text_encoder", ds, module_name,
                     "float32", 10, n_pairs),
        fim_filename(fim_dir, "text_encoder", "ccs_filtered",
                     hparams.rewrite_module_tmp.format(10),
                     "float32", 10, 3000),
    ]


def resolve_fim(components, hparams, cov, fim_dir="data/fim_stats",
                captions: Optional[Sequence[str]] = None, mesh=None,
                verbose: bool = True) -> np.ndarray:
    """FIM diagonal (hidden,) for ``hparams.use_ewc``: the first cache file
    of ``fim_candidates`` that exists, else computed over
    ``EMCID_TPU_FIM_PAIRS`` (default 64) generated pairs and cached (the
    pairs generated over ``mesh``)."""
    candidates = fim_candidates(hparams, fim_dir)
    for path in candidates:
        if Path(path).exists():
            if verbose:
                print(f"[emcid_torch] EWC: loading FIM from {path}")
            return load_fim(path)
    n_pairs = int(os.environ.get("EMCID_TPU_FIM_PAIRS", 64))
    if verbose:
        print(f"[emcid_torch] EWC: no FIM cache at {candidates[0]}: "
              f"computing over {n_pairs} generated (image, caption) pairs")
    if captions is None:
        from emcid_torch.dsets.stat_dataset import make_synthetic_captions

        captions = make_synthetic_captions(n_pairs)
    captions = list(captions)[:n_pairs]
    res = components.unet.config.sample_size * components.vae_scale
    steps = 4 if res < 256 else 25  # tiny pipelines sample in 4 steps
    pairs = make_fim_pairs(components, captions, height=res, width=res,
                           num_inference_steps=steps, mesh=mesh)
    stat = fim_stats(
        components, hparams.rewrite_module_tmp.format(hparams.layers[-1]),
        pairs, cov, mom2_weight=getattr(hparams, "mom2_update_weight", 4000),
        stats_dir=fim_dir, ds_name=getattr(hparams, "mom2_dataset",
                                           "ccs_filtered"),
        sample_size=len(pairs), verbose=verbose)
    return np.asarray(stat.mean.mean())


def load_fim(path) -> np.ndarray:
    """The FIM diagonal of a ``CombinedStat(mean=Mean())`` npz."""
    stat = CombinedStat(mean=Mean())
    stat.load_state_dict(unbox_numpy_null(dict(np.load(path,
                                                       allow_pickle=False))))
    return np.asarray(stat.mean.mean())
