"""Stage 1: optimize the target representation z of a block of concepts.

Counterpart of ``emcid_tpu/engine/compute_z.py``.  For each concept, a
delta added to the edit-token hidden state at the last edited layer is
optimized to minimize

    MSE(UNet(noisy, t, edited source text), UNet(noisy, t, dest text))
  + v_weight_decay * |delta| / |z0|^2
  + text_repr_loss_scale * MSE(edited pooler, dest pooler)

with Adam and an L2-ball projection |delta| <= clamp_norm_factor * |z0|
after every step.

The JAX package vmaps one concept's loss over the block.  Here the block's
C x P prompts form one UNet batch; the C per-concept losses are summed and
differentiated once.  The concepts share no parameters (the text and UNet
weights are frozen, only ``delta`` has a gradient), so each concept's
gradient in ``delta (C, T, H)`` is exactly its own loss's.  Adam is written
out to match ``optax.scale_by_adam`` (b1 0.9, b2 0.999, eps 1e-8,
eps_root 0, bias-corrected) with the learning rate of each step taken from
the same ``lr_values`` array as the JAX package.

Record/replay: ``run(noise_override=, ts_override=)`` takes the noise
(steps, C, P, h, w, c) and timesteps (steps, C, P) of every step, which
makes the optimization comparable with the JAX package's given the same
training images.  With an override the eps_dest pool and the cosine
schedule do not engage (as in JAX).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.models.scheduler import Schedule, add_noise
from emcid_torch.text.token_range import find_token_range

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
# the cosine z schedule: Adam over Z_FRAC of the steps, the learning rate
# decaying from Z_PEAK * v_lr (the JAX package's defaults)
Z_FRAC, Z_PEAK = 0.6, 2.0


class ConceptBatch(NamedTuple):
    """Tensors for a block of C concepts, P prompts each, T edit tokens."""

    source_ids: torch.Tensor  # (C, P, S) long
    dest_ids: torch.Tensor  # (C, P, S) long
    inject_mask: torch.Tensor  # (C, T, P, S) f32
    source_lookup: torch.Tensor  # (C, P) long
    dest_lookup: torch.Tensor  # (C, P) long
    latents_mean: torch.Tensor  # (C, Simg, P, h, w, c) scaled posterior mean
    latents_logvar: torch.Tensor  # (C, Simg, P, h, w, c)


def prepare_concept_batch(
    tokenizer,
    requests: Sequence[Dict],
    hparams,
    max_length: Optional[int] = None,
) -> Tuple[Dict[str, np.ndarray], List[List[str]], List[List[str]]]:
    """Host-side tokenization and edit-token localization for a block."""
    max_length = max_length or tokenizer.model_max_length
    C = len(requests)
    P = len(requests[0]["prompts"])
    T = getattr(hparams, "num_edit_tokens", 1)
    S = max_length

    source_ids = np.zeros((C, P, S), np.int32)
    dest_ids = np.zeros((C, P, S), np.int32)
    inject_mask = np.zeros((C, T, P, S), np.float32)
    source_lookup = np.zeros((C, P), np.int32)
    dest_lookup = np.zeros((C, P), np.int32)
    src_prompts_all, dst_prompts_all = [], []

    for c, request in enumerate(requests):
        if len(request["prompts"]) != P:
            raise ValueError("uniform prompt count per block")
        src_prompts = [p.format(request["source"]) for p in request["prompts"]]
        if hparams.objective == "esd":
            dst_prompts = ["" for _ in request["prompts"]]
        else:
            dst_prompts = [p.format(request["dest"]) for p in request["prompts"]]
        src_prompts_all.append(src_prompts)
        dst_prompts_all.append(dst_prompts)
        s_enc = tokenizer(src_prompts, padding="max_length", truncation=True,
                          max_length=S)
        d_enc = tokenizer(dst_prompts, padding="max_length", truncation=True,
                          max_length=S)
        source_ids[c] = s_enc["input_ids"]
        dest_ids[c] = d_enc["input_ids"]
        for p in range(P):
            n_real = int(s_enc["attention_mask"][p].sum())
            _, end = find_token_range(
                tokenizer, s_enc["input_ids"][p, :n_real], request["source"])
            source_lookup[c, p] = end - 1
            inject_mask[c, 0, p, end - 1] = 1.0
            if T > 1:
                eos = n_real - 1
                for t in range(1, T):
                    inject_mask[c, t, p, min(eos + t - 1, S - 1)] = 1.0
            dn = int(d_enc["attention_mask"][p].sum())
            if hparams.objective == "esd":
                dest_lookup[c, p] = dn - 1
            else:
                _, dend = find_token_range(
                    tokenizer, d_enc["input_ids"][p, :dn], request["dest"])
                dest_lookup[c, p] = dend - 1

    return (
        dict(source_ids=source_ids, dest_ids=dest_ids,
             inject_mask=inject_mask, source_lookup=source_lookup,
             dest_lookup=dest_lookup),
        src_prompts_all,
        dst_prompts_all,
    )


def concept_batch_to_device(arrays: Dict[str, Any], device) -> ConceptBatch:
    """Numpy arrays (``prepare_concept_batch`` output plus latents) ->
    ConceptBatch on ``device``."""
    out = {}
    for k in ConceptBatch._fields:
        t = torch.as_tensor(np.asarray(arrays[k]) if not torch.is_tensor(
            arrays[k]) else arrays[k], device=device)
        out[k] = t.long() if t.dtype in (torch.int32, torch.int64) else t.float()
    return ConceptBatch(**out)


def check_supported(hparams) -> None:
    """Stage-1 variants the port does not run yet raise here."""
    unsupported = {
        "use_ewc": "EWC/FIM (ROADMAP M9: engine/fim.py)",
        "use_sampled_noise": "use_sampled_noise (ROADMAP M9)",
        "no_noise_loss": "no_noise_loss (ROADMAP M9)",
        "align_object_token": "align_object_token (ROADMAP M9)",
        "sld_supervision": "SLD supervision (ROADMAP M9: "
                           "engine/compute_z_variants.py)",
        "add_uce_edit": "UCE hybrid (ROADMAP M9: engine/uce.py)",
    }
    for name, what in unsupported.items():
        if getattr(hparams, name, False):
            raise NotImplementedError(what)
    if hparams.objective not in ("ablate-dest", "ablate-source"):
        raise NotImplementedError(
            f"objective {hparams.objective!r} (ROADMAP M9)")
    if getattr(hparams, "txt_img_align_scale_factor", 0.0):
        raise NotImplementedError("txt-img-align (ROADMAP M9)")


@dataclass
class ZOptimizer:
    """Stage-1 optimizer of one edit layer for concept blocks."""

    text_model: Any  # CLIPTextEncoder
    unet: Any  # UNet2DCondition
    schedule: Schedule
    hparams: Any
    layer: int
    # eps_dest pool of K (noisy, t, eps_dest) draws made once with
    # no-grad forwards and re-drawn from every step (0 = a fresh eps_dest
    # forward every step, the reference protocol)
    eps_pool: int = 0
    # "const": Adam at v_lr for v_num_grad_steps (reference protocol);
    # "cosine": cosine decay from Z_PEAK * v_lr over Z_FRAC of the steps,
    # only for runs of >= 50 steps
    lr_sched: str = "const"

    def __post_init__(self):
        check_supported(self.hparams)
        self.text_model.requires_grad_(False)
        self.unet.requires_grad_(False)

    def lr_values(self, replay: bool) -> np.ndarray:
        total = self.hparams.v_num_grad_steps
        v_lr = self.hparams.v_lr
        if self.lr_sched == "cosine" and total >= 50 and not replay:
            peak = v_lr * Z_PEAK
            total = max(1, int(round(Z_FRAC * total)))
            return (0.5 * peak * (1.0 + np.cos(
                np.pi * np.arange(total) / total))).astype(np.float32)
        return np.full(max(total, 1), v_lr, np.float32)

    # -- pieces ------------------------------------------------------------
    def _draw(self, batch: ConceptBatch, gen: torch.Generator):
        """One (noisy, t) draw per (concept, prompt): image index, posterior
        sample, noise, timestep.  Returns NCHW noisy (C*P, c, h, w) and
        t (C*P,)."""
        mean, logvar = batch.latents_mean, batch.latents_logvar
        C, Simg, P = mean.shape[:3]
        dev = mean.device
        ci = torch.arange(C, device=dev)[:, None]
        pi = torch.arange(P, device=dev)[None, :]
        img = torch.randint(0, Simg, (C, P), generator=gen, device=dev)
        m, lv = mean[ci, img, pi], logvar[ci, img, pi]  # (C, P, h, w, c)
        lat = m + torch.exp(0.5 * lv) * torch.randn(
            m.shape, generator=gen, device=dev)
        noise = torch.randn(lat.shape, generator=gen, device=dev)
        t = torch.randint(0, self.schedule.num_train_timesteps, (C, P),
                          generator=gen, device=dev)
        return lat, noise, t

    def _noisy(self, lat, noise, t):
        C, P = t.shape
        x = add_noise(self.schedule, lat.flatten(0, 1), noise.flatten(0, 1),
                      t.flatten())
        return x.permute(0, 3, 1, 2), t.flatten()

    def _unet(self, noisy, t, ctx):
        dtype = next(self.unet.parameters()).dtype
        return self.unet(noisy.to(dtype), t, ctx).sample.float()

    @torch.no_grad()
    def _build_pool(self, batch: ConceptBatch, dest_hidden, K: int,
                    gen: torch.Generator) -> Dict[str, torch.Tensor]:
        noisy, ts, eps = [], [], []
        for _ in range(K):
            x, t = self._noisy(*self._draw(batch, gen))
            noisy.append(x)
            ts.append(t)
            eps.append(self._unet(x, t, dest_hidden))
        return dict(noisy=torch.stack(noisy), t=torch.stack(ts),
                    eps_dest=torch.stack(eps))  # (K, C*P, ...)

    # -- main --------------------------------------------------------------
    def run(self, batch: ConceptBatch, gen: Optional[torch.Generator] = None,
            noise_override=None, ts_override=None):
        """Optimize a block -> (zs (C, T, H), delta, z0, losses (steps,)),
        f32 tensors on the batch's device."""
        hp = self.hparams
        dev = batch.source_ids.device
        if gen is None:
            gen = torch.Generator(device=dev).manual_seed(0)
        C, P, S = batch.source_ids.shape
        T = batch.inject_mask.shape[1]
        H = self.text_model.config.hidden_size
        replay = noise_override is not None
        lrs = self.lr_values(replay)
        total = len(lrs) if hp.v_num_grad_steps else 0
        src_ids = batch.source_ids.reshape(C * P, S)

        with torch.no_grad():
            dest = self.text_model(batch.dest_ids.reshape(C * P, S))
            dest_hidden = dest.last_hidden_state
            dest_pooled = dest.pooled_output.float().reshape(C, P, H)
            out0 = self.text_model(batch.source_ids[:, 0],
                                   capture=("layer_out",),
                                   stop_at_layer=self.layer)
            layer_out0 = out0.taps["layer_out"][self.layer].float()
            mask0 = batch.inject_mask[:, :, 0, :]
            z0 = torch.einsum("cts,csh->cth", mask0, layer_out0)
            z0_norm = z0.reshape(C, -1).norm(dim=-1)

        pool = None
        if self.eps_pool and total and not replay:
            pool = self._build_pool(batch, dest_hidden, int(self.eps_pool), gen)
        if replay:
            noise_override = torch.as_tensor(noise_override, device=dev).float()
            ts_override = torch.as_tensor(ts_override, device=dev).long()

        delta = torch.zeros((C, T, H), device=dev, requires_grad=True)
        mu = torch.zeros_like(delta)
        nu = torch.zeros_like(delta)
        max_norm = hp.clamp_norm_factor * z0_norm
        losses = []
        for step in range(total):
            if pool is not None:
                K = pool["noisy"].shape[0]
                idx = (torch.randint(0, K, (C * P,), generator=gen, device=dev),
                       torch.arange(C * P, device=dev))
                noisy, t = pool["noisy"][idx], pool["t"][idx]
                eps_dest = pool["eps_dest"][idx]
            else:
                lat, noise, t = self._draw(batch, gen)
                if replay:
                    noise, t = noise_override[step], ts_override[step]
                noisy, t = self._noisy(lat, noise, t)
                with torch.no_grad():
                    eps_dest = self._unet(noisy, t, dest_hidden)

            inj = torch.einsum("ctps,cth->cpsh", batch.inject_mask, delta)
            edited = self.text_model(src_ids, inject_layer=self.layer,
                                     inject_delta=inj.reshape(C * P, S, H))
            eps_edit = self._unet(noisy, t, edited.last_hidden_state)
            mse = (eps_edit - eps_dest).pow(2).reshape(C, -1).mean(dim=1)
            # safe norm: its gradient at delta = 0 is 0, not NaN
            d_norm = torch.sqrt(delta.pow(2).reshape(C, -1).sum(dim=1) + 1e-12)
            loss = mse + hp.v_weight_decay * d_norm / z0_norm ** 2
            if hp.cal_text_repr_loss:
                talign = (edited.pooled_output.float().reshape(C, P, H)
                          - dest_pooled).pow(2).reshape(C, -1).mean(dim=1)
                loss = loss + hp.text_repr_loss_scale_factor * talign
            grad, = torch.autograd.grad(loss.sum(), delta)
            with torch.no_grad():
                mu.mul_(ADAM_B1).add_(grad, alpha=1 - ADAM_B1)
                nu.mul_(ADAM_B2).addcmul_(grad, grad, value=1 - ADAM_B2)
                n = step + 1
                upd = (mu / (1 - ADAM_B1 ** n)) / (
                    torch.sqrt(nu / (1 - ADAM_B2 ** n)) + ADAM_EPS)
                delta -= float(lrs[step]) * upd
                # L2-ball projection per concept
                dn = delta.reshape(C, -1).norm(dim=-1)
                delta *= torch.clamp(max_norm / dn.clamp_min(1e-12),
                                     max=1.0)[:, None, None]
            losses.append(loss.detach().mean())
        delta = delta.detach()
        losses = torch.stack(losses) if losses else torch.zeros(0, device=dev)
        return z0 + delta, delta, z0, losses
