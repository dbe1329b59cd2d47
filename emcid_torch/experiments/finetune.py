"""Finetuning baseline (reference experiments/finetune_text_encoder.py):
instead of a closed-form edit, finetune the text encoder's edited layers
directly with the diffusion noise loss on (source prompt -> dest images),
optionally with the simple pooled-alignment loss
(finetune_text_encoder_simple_align, reference :166-213).

Counterpart of ``emcid_tpu/experiments/finetune.py``: Adam (optax's
update, ``engine/compute_z.adam_step_``) over the fc2 weights of
``hparams.layers`` only.  The gradient reaches them through the UNet's
attention backward (K2/K3) and, with ``EMCID_TPU_FUSED_GN`` /
``EMCID_TPU_FUSED_LN`` at 1, the norm backwards (K5b/K6b).  The weights
train as f32 copies (the Adam moments too) that the encoder reads in its
own dtype.

Record/replay: ``replay=FinetuneDraws(...)`` gives every step's posterior
draw, noise and timesteps, which makes the run comparable with the JAX
package's (its key schedule: ``jax.random.split(rng, steps)``, each key
split in three).
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call

from emcid_torch.engine.compute_z import adam_step_
from emcid_torch.models.pipeline import SDComponents, encode_prompts
from emcid_torch.models.scheduler import add_noise


class FinetuneDraws(NamedTuple):
    """One entry per step: ``post_eps`` the standard-normal posterior draw
    (N, h, w, c), ``noise`` (N, h, w, c), ``timesteps`` (B,)."""

    post_eps: Sequence
    noise: Sequence
    timesteps: Sequence


def finetune_text_encoder(
    components: SDComponents,
    requests: Sequence[Dict],
    hparams,
    latents_mean,
    latents_logvar,
    steps: Optional[int] = None,
    lr: Optional[float] = None,
    align_pooler: bool = True,
    seed: int = 0,
    replay: Optional[FinetuneDraws] = None,
    verbose: bool = True,
) -> Tuple[SDComponents, list]:
    """Finetune the fc2 weights of ``hparams.layers`` on all requests at
    once.  latents_mean/logvar: (C, Simg, P, h, w, c) as in Stage 1.
    Returns (edited components, loss curve); the given components are left
    as they were."""
    steps = steps or hparams.v_num_grad_steps
    lr = lr or hparams.v_lr / 100  # weight-space lr, not delta-space
    tok = components.tokenizer
    text = components.text_encoder
    dev = components.device

    src_prompts, dst_prompts = [], []
    for r in requests:
        src_prompts += [p.format(r["source"]) for p in r["prompts"]]
        dst_prompts += [p.format(r["dest"]) for p in r["prompts"]]
    as_ids = lambda prompts: torch.as_tensor(
        tok(prompts, padding="max_length", truncation=True,
            max_length=tok.model_max_length)["input_ids"],
        dtype=torch.long, device=dev)
    src_ids = as_ids(src_prompts)
    dest_hidden = encode_prompts(components, dst_prompts)
    with torch.no_grad():
        dest_pooled = text(as_ids(dst_prompts)).pooled_output.float()

    names = [f"{hparams.rewrite_module_tmp.format(l)}.weight"
             for l in hparams.layers]
    base = dict(text.named_parameters())
    train = {n: base[n].detach().float().clone().requires_grad_(True)
             for n in names}
    m1 = {n: torch.zeros_like(w) for n, w in train.items()}
    m2 = {n: torch.zeros_like(w) for n, w in train.items()}
    lat_mean = torch.as_tensor(latents_mean, device=dev).float()
    lat_mean = lat_mean.reshape((-1,) + tuple(lat_mean.shape[3:]))
    lat_logvar = torch.as_tensor(latents_logvar, device=dev).float()
    lat_logvar = lat_logvar.reshape((-1,) + tuple(lat_logvar.shape[3:]))
    B = src_ids.shape[0]
    schedule = components.schedule
    unet, dtype = components.unet, components.dtype
    gen = torch.Generator(device=dev).manual_seed(seed)

    def eps(noisy, timesteps, ctx):
        return unet(noisy.permute(0, 3, 1, 2).to(dtype), timesteps,
                    ctx.to(dtype)).sample.float()

    losses = []
    for step in range(steps):
        if replay is not None:
            post = torch.as_tensor(np.asarray(replay.post_eps[step]),
                                   device=dev).float()
            noise = torch.as_tensor(np.asarray(replay.noise[step]),
                                    device=dev).float()
            timesteps = torch.as_tensor(np.asarray(replay.timesteps[step]),
                                        dtype=torch.long, device=dev)
        else:
            post = torch.randn(lat_mean.shape, generator=gen, device=dev)
            noise = torch.randn(lat_mean.shape, generator=gen, device=dev)
            timesteps = torch.randint(0, schedule.num_train_timesteps, (B,),
                                      generator=gen, device=dev)
        latents = lat_mean + torch.exp(0.5 * lat_logvar) * post
        noisy = add_noise(schedule, latents, noise, timesteps)
        with torch.no_grad():
            eps_dest = eps(noisy, timesteps, dest_hidden)
        out = functional_call(text, {n: w.to(base[n].dtype)
                                     for n, w in train.items()}, (src_ids,))
        loss = torch.mean((eps(noisy, timesteps, out.last_hidden_state)
                           - eps_dest) ** 2)
        if align_pooler:
            loss = loss + 0.01 * torch.mean(
                (out.pooled_output.float() - dest_pooled) ** 2)
        grads = torch.autograd.grad(loss, [train[n] for n in names])
        with torch.no_grad():
            for n, g in zip(names, grads):
                adam_step_(train[n], m1[n], m2[n], g, lr, step + 1)
        losses.append(float(loss.detach()))
    if verbose and losses:
        print(f"finetune: loss {losses[0]:.5f} -> {losses[-1]:.5f}")
    edited = copy.deepcopy(text)
    with torch.no_grad():
        params = dict(edited.named_parameters())
        for n in names:
            params[n].copy_(train[n].to(params[n].dtype))
    return components.replace_text_encoder(edited), losses
