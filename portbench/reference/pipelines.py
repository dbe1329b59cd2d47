"""What the cells' entries compute, in plain PyTorch: images from prompts
(SD and SDXL), the covariances, the training-image posteriors, Stage 1
and the float64 Stage 2 of an EMCID edit block.

Inputs are the benchmark's own: token ids from ``portbench.tokens``, the
weights the benchmark made (read through ``Prec``), the requests and
seeds.  Stage 1 draws its noise from a ``torch.Generator`` in the order the
product's seeded protocol fixes (``stage1``), so the same block gives the
same draws on both sides.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
import torch

from portbench.reference import clip, samplers, unet, vae
from portbench.reference.ops import Prec

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


def initial_latents(seeds: Sequence[int], hw: int, channels: int,
                    device) -> torch.Tensor:
    """(B, c, h, w) standard normal latents, one generator per seed, drawn
    channel-last as the product draws them."""
    out = []
    for s in seeds:
        g = torch.Generator(device=device).manual_seed(int(s))
        out.append(torch.randn((hw, hw, channels), generator=g, device=device))
    return torch.stack(out).permute(0, 3, 1, 2)


# -- generation ---------------------------------------------------------------

def generate_sd(p: Prec, cfg: Dict, ids: torch.Tensor, neg_ids: torch.Tensor,
                seeds: Sequence[int], traffic: Dict) -> torch.Tensor:
    """uint8 images (B, H, W, 3) of SD: CFG over the negative prompts."""
    tcfg, ucfg = cfg["text_encoder"], cfg["unet"]
    ctx = torch.cat([clip.encode(p, tcfg, neg_ids)[0],
                     clip.encode(p, tcfg, ids)[0]])
    g = traffic["guidance_scale"]

    def eps(x, t):
        e = unet.unet(p, ucfg, torch.cat([x, x]),
                      torch.tensor([t], device=x.device), ctx)
        e_u, e_c = e.chunk(2)
        return e_u + g * (e_c - e_u)

    hw = traffic["resolution"] // cfg["vae_scale"]
    x = initial_latents(seeds, hw, ucfg["in_channels"], ids.device)
    lat = samplers.sample(traffic["sampler"], eps, x, traffic["steps"])
    sf = cfg["vae"]["scaling_factor"]
    return vae.to_uint8(vae.decode(p, cfg["vae"], lat / sf))


def sdxl_condition(p: Prec, cfg: Dict, ids: torch.Tensor):
    """(context (B, S, H1 + H2), pooled (B, proj)): both encoders'
    penultimate layer outputs, bigG's projected pooled output."""
    outs = []
    for key, prefix in (("text_encoder", "te1."), ("text_encoder_2", "te2.")):
        tcfg = cfg[key]
        taps: Dict[str, List[torch.Tensor]] = {}
        _, pooled = clip.encode(p, tcfg, ids, prefix=prefix, taps=taps)
        outs.append((taps["layer_out"][tcfg["num_hidden_layers"] - 2],
                     pooled))
    return torch.cat([outs[0][0], outs[1][0]], -1), outs[1][1]


def generate_sdxl(p: Prec, cfg: Dict, ids: torch.Tensor,
                  neg_ids: torch.Tensor, seeds: Sequence[int],
                  traffic: Dict) -> torch.Tensor:
    """uint8 images (B, H, W, 3) of SDXL-base: CFG over the negative
    prompts, the size conditions (H, W, 0, 0, H, W)."""
    ucfg = cfg["unet"]
    res = traffic["resolution"]
    ctx_c, pool_c = sdxl_condition(p, cfg, ids)
    ctx_u, pool_u = sdxl_condition(p, cfg, neg_ids)
    B = ids.shape[0]
    tid = torch.tensor([res, res, 0, 0, res, res], dtype=torch.float32,
                       device=ids.device).expand(2 * B, 6)
    added = {"text_embeds": torch.cat([pool_u, pool_c]), "time_ids": tid}
    ctx = torch.cat([ctx_u, ctx_c])
    g = traffic["guidance_scale"]

    def eps(x, t):
        e = unet.unet(p, ucfg, torch.cat([x, x]),
                      torch.tensor([t], device=x.device), ctx, added)
        e_u, e_c = e.chunk(2)
        return e_u + g * (e_c - e_u)

    x = initial_latents(seeds, res // cfg["vae_scale"], ucfg["in_channels"],
                        ids.device)
    lat = samplers.sample(traffic["sampler"], eps, x, traffic["steps"])
    sf = cfg["vae"]["scaling_factor"]
    return vae.to_uint8(vae.decode(p, cfg["vae"], lat / sf))


# -- the edit -----------------------------------------------------------------

def covariance(p: Prec, tcfg: Dict, ids: torch.Tensor, mask: torch.Tensor,
               layer: int, batch: int = 500) -> torch.Tensor:
    """E[k k^T] (float64) of one layer's fc2 inputs over the real tokens of
    the captions ``ids`` (N, S) with padding ``mask``."""
    acc = None
    for i in range(0, ids.shape[0], batch):
        taps: Dict[str, List[torch.Tensor]] = {}
        clip.encode(p, tcfg, ids[i:i + batch], stop_at=layer, taps=taps)
        k = taps["fc2_in"][layer][mask[i:i + batch].bool()].double()
        acc = k.T @ k if acc is None else acc + k.T @ k
    return acc / float(mask.sum())


def training_posteriors(p: Prec, cfg: Dict, ids: torch.Tensor,
                        neg_ids: torch.Tensor, seeds: Sequence[int],
                        edit: Dict):
    """Scaled posterior (mean, logvar), (n, c, h, w), of the training
    images: DPM++ with CFG on the first ``cfg_interval`` of the steps,
    decoded, quantized to uint8 levels, encoded again."""
    tcfg, ucfg = cfg["text_encoder"], cfg["unet"]
    c_ctx = clip.encode(p, tcfg, ids)[0]
    ctx = torch.cat([clip.encode(p, tcfg, neg_ids)[0], c_ctx])
    g = edit["train_guidance_scale"]
    dev = ids.device

    def eps(x, t):
        e_u, e_c = unet.unet(p, ucfg, torch.cat([x, x]),
                             torch.tensor([t], device=dev), ctx).chunk(2)
        return e_u + g * (e_c - e_u)

    def eps_tail(x, t):
        return unet.unet(p, ucfg, x, torch.tensor([t], device=dev), c_ctx)

    steps = edit["train_steps"]
    x = initial_latents(seeds, edit["train_res"] // cfg["vae_scale"],
                        ucfg["in_channels"], dev)
    n_guided = max(1, int(round(edit["cfg_interval"] * steps)))
    lat = samplers.sample(edit["train_sampler"], eps, x, steps,
                          eps_tail=eps_tail, n_guided=n_guided)
    sf = cfg["vae"]["scaling_factor"]
    img = torch.clamp(vae.decode(p, cfg["vae"], lat / sf) / 2 + 0.5, 0, 1)
    img = torch.round(img * 255.0) / 255.0 * 2.0 - 1.0
    mean, logvar = vae.encode(p, cfg["vae"], img)
    return mean * sf, logvar + 2.0 * math.log(sf)


def lr_values(edit: Dict) -> np.ndarray:
    """The product's cosine z schedule: from ``z_peak * v_lr`` down over
    ``z_frac`` of ``v_num_grad_steps`` (runs of 50 steps or more), else a
    constant ``v_lr``."""
    total, v_lr = edit["v_num_grad_steps"], edit["v_lr"]
    if total >= 50:
        n = max(1, int(round(edit["z_frac"] * total)))
        peak = v_lr * edit["z_peak"]
        return 0.5 * peak * (1.0 + np.cos(np.pi * np.arange(n) / n))
    return np.full(max(total, 1), v_lr)


def stage1(p: Prec, cfg: Dict, blk: Dict, mean: torch.Tensor,
           logvar: torch.Tensor, rows: Sequence[int], edit: Dict,
           rng_seed: int) -> Dict[str, torch.Tensor]:
    """z (len(rows), H) of the concepts ``rows`` of a block.

    ``blk`` holds the block's token ids ``src`` and ``dst`` (C, P, S) and
    the edit-token positions ``pos`` (C, P); ``mean``/``logvar`` are the
    posteriors of the rows' training images (len(rows), P, c, h, w).  The
    draws are those of the whole block of C concepts from one generator
    seeded ``rng_seed``: K pool draws (image index, posterior sample,
    noise, timestep), then one pool index per step; the rows' share is
    used.  The loss per concept: the mean squared eps gap to the dest
    text's eps over the pooled draw, the weight decay on |delta| / |z0|^2,
    and the pooled-text alignment; Adam (0.9, 0.999, 1e-8), then the
    projection to |delta| <= clamp_norm_factor * |z0|."""
    tcfg, ucfg = cfg["text_encoder"], cfg["unet"]
    src, dst, pos = blk["src"], blk["dst"], blk["pos"]
    C, P, S = src.shape
    L = edit["layers"][-1]
    dev = src.device
    r = torch.as_tensor(list(rows), device=dev)
    R = len(rows)
    hw = edit["train_res"] // cfg["vae_scale"]
    ch = ucfg["in_channels"]
    with torch.no_grad():
        dest_h, dest_pool = clip.encode(p, tcfg, dst[r].reshape(R * P, S))
        lay0, _ = clip.encode(p, tcfg, src[r, 0], stop_at=L)
        z0 = lay0[torch.arange(R, device=dev), pos[r, 0]]
    z0n = z0.norm(dim=-1)
    gen = torch.Generator(device=dev).manual_seed(int(rng_seed))
    K = edit["eps_pool"]
    pool = []
    for _ in range(K):
        torch.randint(0, 1, (C, P), generator=gen, device=dev)  # image index
        post = torch.randn((C, P, hw, hw, ch), generator=gen, device=dev)
        noise = torch.randn((C, P, hw, hw, ch), generator=gen, device=dev)
        t = torch.randint(0, samplers.T_TRAIN, (C, P), generator=gen,
                          device=dev)
        post, noise = (a[r].permute(0, 1, 4, 2, 3) for a in (post, noise))
        lat = mean + torch.exp(0.5 * logvar) * post
        t = t[r].reshape(-1)
        noisy = samplers.add_noise(lat.flatten(0, 1), noise.flatten(0, 1), t)
        with torch.no_grad():
            e = unet.unet(p, ucfg, noisy, t, dest_h)
        pool.append((noisy, t, e))
    noisy_k = torch.stack([a[0] for a in pool])
    t_k = torch.stack([a[1] for a in pool])
    eps_k = torch.stack([a[2] for a in pool])
    H = z0.shape[-1]
    delta = torch.zeros((R, H), device=dev, requires_grad=True)
    m1, m2 = torch.zeros_like(delta), torch.zeros_like(delta)
    max_norm = edit["clamp_norm_factor"] * z0n
    col = torch.arange(R * P, device=dev)
    src_r = src[r].reshape(R * P, S)
    at = (torch.arange(R * P, device=dev), pos[r].reshape(-1))
    for step, lr in enumerate(lr_values(edit)):
        idx = torch.randint(0, K, (C, P), generator=gen, device=dev)
        i = (idx[r].reshape(-1), col)
        inj = torch.zeros((R * P, S, H), device=dev)
        inj = inj.index_put(at, delta.repeat_interleave(P, dim=0))
        hid, pooled = clip.encode(p, tcfg, src_r, inject=(L, inj))
        e = unet.unet(p, ucfg, noisy_k[i], t_k[i], hid)
        loss = (e - eps_k[i]).pow(2).reshape(R, -1).mean(1)
        loss = loss + edit["v_weight_decay"] * torch.sqrt(
            delta.pow(2).sum(-1) + 1e-12) / z0n ** 2
        loss = loss + edit["text_repr_loss_scale_factor"] * (
            pooled - dest_pool).pow(2).reshape(R, -1).mean(1)
        grad, = torch.autograd.grad(loss.sum(), delta)
        with torch.no_grad():
            n = step + 1
            m1.mul_(ADAM_B1).add_(grad, alpha=1 - ADAM_B1)
            m2.mul_(ADAM_B2).addcmul_(grad, grad, value=1 - ADAM_B2)
            delta -= float(lr) * (m1 / (1 - ADAM_B1 ** n)) / (
                torch.sqrt(m2 / (1 - ADAM_B2 ** n)) + ADAM_EPS)
            dn = delta.norm(dim=-1)
            delta *= torch.clamp(max_norm / dn.clamp_min(1e-12),
                                 max=1.0)[:, None]
    return {"z": (z0 + delta).detach(), "z0": z0}


def stage2(p: Prec, tcfg: Dict, ids: torch.Tensor, pos: torch.Tensor,
           zs: torch.Tensor, covs: Sequence[torch.Tensor], edit: Dict
           ) -> List[torch.Tensor]:
    """The fc2 update (out, in) of every edited layer, float64: one walk
    of the prompts ``ids`` (R*P, S) with edit tokens at ``pos`` (R*P,),
    keys and current values averaged over each request's P prompts, at each
    edited layer ``adj_k = (lam C + K K^T)^-1 K`` and the residual toward
    ``zs`` (R, H) spread over the layers left; the walk continues with the
    update applied."""
    layers = list(edit["layers"])
    lam = float(edit["mom2_update_weight"])
    alpha = float(edit.get("edit_weight", 0.5))
    k_scale, c_scale = math.sqrt(alpha / 0.5), (1.0 - alpha) / 0.5
    R = zs.shape[0]
    P = ids.shape[0] // R
    at = torch.arange(ids.shape[0], device=ids.device)
    ups: List[torch.Tensor] = []

    def patch(i, h, fc2_in, cur):
        if i not in layers:
            return h
        j = layers.index(i)
        K = fc2_in[at, pos].double().reshape(R, P, -1).mean(1).T * k_scale
        V = cur[at, pos].double().reshape(R, P, -1).mean(1).T
        A = lam * c_scale * covs[j].double() + K @ K.T
        adj = torch.linalg.solve(A, K)
        resid = (zs.double().T - V) * k_scale / (len(layers) - j)
        upd = resid @ adj.T
        ups.append(upd)
        return h + (fc2_in.double() @ upd.T).to(h.dtype)

    with torch.no_grad():
        clip.encode(p, tcfg, ids, stop_at=max(layers), patch=patch)
    return ups
