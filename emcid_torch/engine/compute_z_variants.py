"""Stage-1 variants beyond the standard noise-loss objective.

Counterpart of ``emcid_tpu/engine/compute_z_variants.py``:

* ``sld_sample_latents`` + ``compute_z_text_encoder_global``: the
  SLD-supervised z of a global (NSFW) concept.  Training images are
  generated under Safe Latent Diffusion guidance (the sampler steered away
  from the unsafe concept), then the standard ablate-style optimization
  pulls the source representation toward reproducing those safe images.
* ``compute_z_refact``: the ReFACT-style contrastive z on the pooled text
  embedding (no UNet), with the same Adam as ``ZOptimizer``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch

from emcid_torch.engine.compute_z import (
    ADAM_B1,
    ADAM_B2,
    ADAM_EPS,
    ZOptimizer,
    concept_batch_to_device,
    prepare_concept_batch,
)
from emcid_torch.engine.training_images import encode_posterior
from emcid_torch.models.pipeline import (
    SDComponents,
    decode_latents,
    encode_prompts,
    initial_latents,
)
from emcid_torch.models.scheduler import ddim_step, ddim_timesteps
from emcid_torch.text.token_range import find_token_range

# SLD hyperparameter presets (Schramowski et al.; the reference's max and
# strong configurations)
SLD_CONFIGS = {
    "max": dict(guidance_scale=7.5, sld_guidance_scale=5000,
                sld_warmup_steps=0, sld_threshold=1.0, sld_momentum=0.5),
    "strong": dict(guidance_scale=7.5, sld_guidance_scale=2000,
                   sld_warmup_steps=7, sld_threshold=0.025, sld_momentum=0.5),
}


@torch.no_grad()
def sld_sample_latents(
    components: SDComponents,
    prompts: Sequence[str],
    seeds: Sequence[int],
    safety_concepts: str,
    sld_type: str = "max",
    num_inference_steps: int = 50,
    height: int = 512,
    width: int = 512,
    latents: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Safe Latent Diffusion DDIM sampling -> final latents (B, h, w, c):
    CFG plus a safety term that pushes the trajectory away from the
    safety concept's direction.  ``latents`` (channel-last) replaces the
    seeded initial latents."""
    cfg = SLD_CONFIGS[sld_type]
    B = len(prompts)
    dev, dtype = components.device, components.dtype
    ctx3 = torch.cat([encode_prompts(components, [""] * B),
                      encode_prompts(components, list(prompts)),
                      encode_prompts(components, [safety_concepts] * B)])
    if latents is None:
        latents = initial_latents(seeds, height, width,
                                  components.latent_channels,
                                  components.vae_scale, device=dev)
    lat = torch.as_tensor(latents, device=dev).float().permute(0, 3, 1, 2)
    ts = ddim_timesteps(components.schedule, num_inference_steps)
    ts_prev = np.concatenate([ts[1:], [-1]]).astype(np.int32)
    g, s_g = cfg["guidance_scale"], cfg["sld_guidance_scale"]
    thresh, mom = cfg["sld_threshold"], cfg["sld_momentum"]
    momentum = torch.zeros_like(lat)
    for i, (t, t_prev) in enumerate(zip(map(int, ts), map(int, ts_prev))):
        eps3 = components.unet(torch.cat([lat, lat, lat]).to(dtype),
                               torch.tensor([t], device=dev),
                               ctx3).sample.float()
        eps_u, eps_c, eps_s = eps3.chunk(3)
        guidance = eps_c - eps_u
        # the SLD safety term (Schramowski et al., eq. 6-10)
        scale = torch.clamp(guidance.abs() * s_g, 0.0, 1.0)
        safety = torch.where(eps_c - eps_s >= thresh,
                             torch.zeros_like(scale), scale) * (eps_s - eps_u)
        safety = safety + mom * momentum
        momentum = safety
        if i < cfg["sld_warmup_steps"]:
            safety = torch.zeros_like(safety)
        eps = eps_u + g * (guidance - safety)
        lat = ddim_step(components.schedule, lat, eps, t, t_prev)
    return lat.permute(0, 2, 3, 1).contiguous()


def compute_z_text_encoder_global(
    components: SDComponents,
    request: Dict,
    hparams,
    layer: int,
    num_inference_steps: int = 20,
    height: int = 512,
    width: int = 512,
    gen: Optional[torch.Generator] = None,
    verbose: bool = True,
) -> np.ndarray:
    """SLD-supervised z (T, H) for a global concept request
    ``{source_prompts, seeds, safe_words, source, dest}``: SLD-safe images
    of the unsafe prompts become the training images of the standard
    ablate-style optimization, with the prompts taken verbatim and the
    edit token at the source keyword (else the last real token)."""
    prompts = list(request["source_prompts"])
    seeds = request.get("seeds") or list(range(len(prompts)))
    safe_words = (request.get("safe_words") or [""])[0]
    latents = sld_sample_latents(
        components, prompts, seeds, safe_words,
        sld_type=getattr(hparams, "sld_type", "max"),
        num_inference_steps=num_inference_steps, height=height, width=width)
    imgs = decode_latents(components, latents)
    mean, logvar = encode_posterior(
        components, imgs.astype(np.float32) / 255.0 * 2.0 - 1.0)

    # verbatim prompts as brace-escaped templates
    tok = components.tokenizer
    dest = request.get("dest") or " "
    arrays, _, _ = prepare_concept_batch(tok, [{
        "prompts": [p.replace("{", "{{").replace("}", "}}") for p in prompts],
        "source": request["source"], "dest": dest}], hparams)
    for p_i, prompt in enumerate(prompts):
        enc = tok([prompt], padding="max_length", truncation=True,
                  max_length=tok.model_max_length)
        n_real = int(np.asarray(enc["attention_mask"][0]).sum())
        try:
            _, end = find_token_range(
                tok, np.asarray(enc["input_ids"][0][:n_real]),
                request["source"])
            idx = end - 1
        except ValueError:
            idx = n_real - 1
        arrays["source_ids"][0, p_i] = enc["input_ids"][0]
        arrays["inject_mask"][0, :, p_i, :] = 0.0
        arrays["inject_mask"][0, 0, p_i, idx] = 1.0
        arrays["source_lookup"][0, p_i] = idx
    arrays["latents_mean"] = mean[None, None]
    arrays["latents_logvar"] = logvar[None, None]
    batch = concept_batch_to_device(arrays, components.device)
    optz = ZOptimizer(components.text_encoder, components.unet,
                      components.schedule, hparams, layer)
    zs, _, _, losses = optz.run(batch, gen)
    if verbose:
        final = (f"{float(losses[-1]):.5f}" if len(losses)
                 else "n/a (0 steps)")
        print(f"global z opt final loss {final}")
    return zs.cpu().numpy()[0]


def compute_z_refact(
    components,
    request: Dict,
    hparams,
    layer: int,
    clip_text_model=None,
    rng: Optional[torch.Generator] = None,
    verbose: bool = True,
) -> np.ndarray:
    """ReFACT-style contrastive z (reference compute_z_refact,
    compute_z.py:1991-2175): a delta at the edit token of layer ``layer``
    so that the edited prompts' pooled embeddings win a distance-softmax
    over [dest] + negatives, plus ``v_weight_decay * |delta| / |z0|^2``;
    Adam at ``v_lr`` for ``v_num_grad_steps`` with the L2-ball projection
    ``|delta| <= clamp_norm_factor * |z0|`` after each step.

    The embedding space is the text tower of ``components`` (with its
    projection where it has one), or ``clip_text_model``.  ``components``
    needs only ``tokenizer`` and ``text_encoder``.  The objective draws no
    random numbers; ``rng`` is taken for the signature's sake.  Returns
    z0 + delta (H,) on the host."""
    del rng
    hp = hparams
    tok = components.tokenizer
    text = clip_text_model or components.text_encoder
    dev = next(text.parameters()).device

    src_prompts = [p.format(request["source"]) for p in request["prompts"]]
    enc = tok(src_prompts, padding="max_length", truncation=True,
              max_length=tok.model_max_length)
    ids = torch.as_tensor(enc["input_ids"], device=dev).long()
    P, S = ids.shape
    mask = np.zeros((P, S), np.float32)
    for p in range(P):
        n_real = int(np.asarray(enc["attention_mask"][p]).sum())
        _, end = find_token_range(tok, np.asarray(enc["input_ids"][p][:n_real]),
                                  request["source"])
        mask[p, end - 1] = 1.0
    mask = torch.as_tensor(mask, device=dev)

    dest_texts = [request["dest"]] + list(request.get("negative_prompts") or [])
    d_enc = tok(dest_texts, padding="max_length", truncation=True,
                max_length=tok.model_max_length)
    with torch.no_grad():
        dest_pooled = text(torch.as_tensor(d_enc["input_ids"], device=dev)
                           .long()).pooled_output.float()
        out0 = text(ids[:1], capture=("layer_out",), stop_at_layer=layer)
        z0 = (out0.taps["layer_out"][layer][0].float()
              * mask[0][:, None]).sum(0)
        z0n = z0.norm()

    H = z0.shape[-1]
    delta = torch.zeros(H, device=dev, requires_grad=True)
    m1 = torch.zeros_like(delta)
    m2 = torch.zeros_like(delta)
    max_norm = hp.clamp_norm_factor * z0n
    losses = []
    for step in range(hp.v_num_grad_steps):
        inj = mask[..., None] * delta[None, None, :]
        pooled = text(ids, inject_layer=layer,
                      inject_delta=inj).pooled_output.float()  # (P, H')
        # negative-distance logits (the reference's -cdist)
        d = (pooled[:, None, :] - dest_pooled[None, :, :]).norm(dim=-1)
        nll = -torch.log_softmax(-d, dim=-1)[:, 0].mean()
        reg = (hp.v_weight_decay * torch.sqrt(delta.pow(2).sum() + 1e-12)
               / z0n ** 2)
        loss = nll + reg
        grad, = torch.autograd.grad(loss, delta)
        with torch.no_grad():
            m1.mul_(ADAM_B1).add_(grad, alpha=1 - ADAM_B1)
            m2.mul_(ADAM_B2).addcmul_(grad, grad, value=1 - ADAM_B2)
            n = step + 1
            upd = (m1 / (1 - ADAM_B1 ** n)) / (
                torch.sqrt(m2 / (1 - ADAM_B2 ** n)) + ADAM_EPS)
            delta -= float(hp.v_lr) * upd
            delta *= torch.clamp(max_norm / delta.norm().clamp_min(1e-12),
                                 max=1.0)
        losses.append(float(loss.detach()))
    if verbose and losses:
        print(f"refact z opt: nll {losses[0]:.4f} -> {losses[-1]:.4f}")
    return (z0 + delta.detach()).cpu().numpy()
