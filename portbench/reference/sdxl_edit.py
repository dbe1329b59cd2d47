"""The EMCID edit of SDXL's two text encoders, in plain PyTorch: the
training-image posteriors at SDXL's conditions, the joint two-delta
Stage 1, both encoders' covariances and the two float64 Stage-2 inserts.

Inputs are the benchmark's own, as in ``pipelines``: token ids from
``portbench.tokens``, the weights the benchmark made (read through
``Prec``; CLIP-L under ``te1.``, bigG under ``te2.``), the requests and
seeds.  Stage 1 draws from one ``torch.Generator`` seeded with the block's
seed, in the order the product's seeded protocol fixes: for each step, for
each concept of the block, the training-image index, the posterior's
standard-normal draw, the noise (channel-last latents) and the timestep.
Every concept's draws are made; the checked concepts' are used.

The edit (Podell et al., arXiv:2307.01952, for the conditioning; EMCID
for the rest):

- context: both encoders' penultimate layer outputs (layer n - 2, no
  final LayerNorm) side by side; ``text_embeds``: bigG's projected pooled
  output; ``time_ids``: (H, W, 0, 0, H, W);
- one delta per encoder, added at the edit token's output of its last
  edited layer, optimized jointly: per concept, the mean squared gap
  between the UNet's eps under the edited source prompts and under the
  dest prompts (ablate-dest), the weight decay |d| / |z0|^2 of each
  encoder, and the text-representation term on both pooled outputs;
  Adam (0.9, 0.999, 1e-8) at a constant ``v_lr``, then each delta
  projected to ``clamp_norm_factor * |z0|``;
- Stage 2: each encoder's insert with its own layers and
  ``mom2_update_weight`` (``pipelines.stage2``).

Where it departs from the published description:

- encoder 2's source-side ids are CLIP's with 0 after the first end token
  (``tokenizer_2`` pads with "!", id 0), as the product and the reference
  implementation feed bigG; the dest side reads the encoder-1 ids (end
  tokens as padding) for both encoders, and so do the training images;
- the eps term's gradient is taken prompt by prompt and summed (the
  gradient of their mean), so that the float32 model at 1024 px fits one
  card (the float8 control also recomputes the UNet's transformers in the
  backward pass); the dest eps is computed at the same draw without
  gradient;
- the covariances walk the captions once for all edited layers of an
  encoder (one ``clip.encode`` pass with a ``patch`` that reads the fc2
  inputs), E[k k^T] over the captions' real tokens in float64;
- the UNet's downsampler pads the bottom and right edge (``unet.py``).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, List, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference import clip, pipelines, samplers, unet, vae
from portbench.reference.ops import Prec

PREFIX = {1: "te1.", 2: "te2."}
KEY = {1: "text_encoder", 2: "text_encoder_2"}


def encoder(p: Prec, which: int) -> Prec:
    """A ``Prec`` over one encoder's tensors, named without its prefix."""
    pre = PREFIX[which]
    return Prec({k[len(pre):]: v for k, v in p.params.items()
                 if k.startswith(pre)}, fp8=p.fp8)


def encoder2_ids(ids: torch.Tensor, eos_id: int) -> torch.Tensor:
    """CLIP ids with 0 at every position after the first end token."""
    first = (ids == eos_id).int().argmax(-1, keepdim=True)
    after = torch.arange(ids.shape[-1], device=ids.device) > first
    return torch.where(after, torch.zeros_like(ids), ids)


def condition(p: Prec, cfg: Dict, ids: torch.Tensor, ids_2=None,
              inject_1=None, inject_2=None):
    """(context (B, S, H1 + H2), pooled_1 (B, H1), pooled_2 (B, proj)):
    ``ids_2`` feeds encoder 2 (default ``ids``); ``inject_k`` = (layer,
    delta (B, S, H)) is added to that layer's output of encoder k."""
    outs = []
    for which, x, inj in ((1, ids, inject_1),
                          (2, ids if ids_2 is None else ids_2, inject_2)):
        tcfg = cfg[KEY[which]]
        taps: Dict[str, List[torch.Tensor]] = {}
        _, pooled = clip.encode(p, tcfg, x, prefix=PREFIX[which],
                                inject=inj, taps=taps)
        outs.append((taps["layer_out"][tcfg["num_hidden_layers"] - 2],
                     pooled))
    return torch.cat([outs[0][0], outs[1][0]], -1), outs[0][1], outs[1][1]


@contextlib.contextmanager
def recomputed_transformers(on: bool):
    """With ``on``, the UNet's transformers keep no activations for the
    backward pass and run again inside it (``torch.utils.checkpoint``):
    the same numbers in less memory.  The float8 control needs it at 1024
    px, where the rounded copy of every product's operands that it keeps
    for its backward would not fit one card beside the float32 model."""
    orig = unet._transformer
    if on:
        unet._transformer = lambda *a: checkpoint(orig, *a,
                                                  use_reentrant=False)
    try:
        yield
    finally:
        unet._transformer = orig


def time_ids(res: int, n: int, device) -> torch.Tensor:
    return torch.tensor([res, res, 0, 0, res, res], dtype=torch.float32,
                        device=device).expand(n, 6)


@torch.no_grad()
def training_posteriors(p: Prec, cfg: Dict, ids: torch.Tensor,
                        neg_ids: torch.Tensor, seeds: Sequence[int],
                        edit: Dict):
    """Scaled posterior (mean, logvar), (n, c, h, w), of the training
    images at ``edit["resolution"]``: ``edit["sampler"]`` over
    ``edit["steps"]`` with CFG at ``edit["guidance_scale"]`` over the
    negative prompts on the first ``cfg_interval`` of the steps, the
    conditional half alone after; decoded to uint8 levels one image at a
    time, encoded again."""
    ucfg = cfg["unet"]
    res, dev = edit["resolution"], ids.device
    ctx_c, pool_c = pipelines.sdxl_condition(p, cfg, ids)
    ctx_u, pool_u = pipelines.sdxl_condition(p, cfg, neg_ids)
    B = ids.shape[0]
    tid = time_ids(res, B, dev)
    ctx = torch.cat([ctx_u, ctx_c])
    added = {"text_embeds": torch.cat([pool_u, pool_c]),
             "time_ids": torch.cat([tid, tid])}
    added_c = {"text_embeds": pool_c, "time_ids": tid}
    g = edit["guidance_scale"]

    def eps(x, t):
        e_u, e_c = unet.unet(p, ucfg, torch.cat([x, x]),
                             torch.tensor([t], device=dev), ctx,
                             added).chunk(2)
        return e_u + g * (e_c - e_u)

    def eps_tail(x, t):
        return unet.unet(p, ucfg, x, torch.tensor([t], device=dev), ctx_c,
                         added_c)

    steps = edit["steps"]
    x = pipelines.initial_latents(seeds, res // cfg["vae_scale"],
                                  ucfg["in_channels"], dev)
    n_guided = max(1, int(round(edit["cfg_interval"] * steps)))
    lat = samplers.sample(edit["sampler"], eps, x, steps, eps_tail=eps_tail,
                          n_guided=n_guided)
    sf = cfg["vae"]["scaling_factor"]
    means, logvars = [], []
    for i in range(B):
        img = vae.to_uint8(vae.decode(p, cfg["vae"], lat[i:i + 1] / sf))
        img = img.permute(0, 3, 1, 2).float() / 255.0 * 2.0 - 1.0
        m, lv = vae.encode(p, cfg["vae"], img)
        means.append(m * sf)
        logvars.append(lv + 2.0 * math.log(sf))
    return torch.cat(means), torch.cat(logvars)


def stage1(p: Prec, cfg: Dict, blk: Dict, mean: torch.Tensor,
           logvar: torch.Tensor, rows: Sequence[int], edit: Dict,
           rng_seed: int) -> Dict[str, List[torch.Tensor]]:
    """The z and z0 of both encoders, ``[(len(rows), H1), (len(rows),
    H2)]``, of the concepts ``rows`` of a block.

    ``blk`` holds the block's encoder-1 token ids ``src`` and ``dst``
    (C, P, S) and the edit-token positions ``pos`` (C, P);
    ``mean``/``logvar`` are the posteriors of the rows' training images
    (len(rows), P, c, h, w), one image per prompt."""
    ucfg = cfg["unet"]
    src, dst, pos = blk["src"], blk["dst"], blk["pos"]
    C, P, S = src.shape
    dev = src.device
    R = len(rows)
    r = torch.as_tensor(list(rows), device=dev)
    src_2 = encoder2_ids(src, cfg["text_encoder"]["eos_token_id"])
    L = {1: edit["layers"][-1], 2: edit["layers_2"][-1]}
    hw = edit["resolution"] // cfg["vae_scale"]
    ch = ucfg["in_channels"]
    with torch.no_grad():
        z0 = []
        for which, ids in ((1, src), (2, src_2)):
            h, _ = clip.encode(p, cfg[KEY[which]], ids[r, 0],
                               prefix=PREFIX[which], stop_at=L[which])
            z0.append(h[torch.arange(R, device=dev), pos[r, 0]])
        ctx_d, pool1_d, pool2_d = (a.reshape((R, P) + a.shape[1:]) for a in
                                   condition(p, cfg, dst[r].reshape(R * P, S)))
    z0n = [z.norm(dim=-1) for z in z0]
    tid = time_ids(edit["resolution"], 1, dev)
    deltas = [torch.zeros_like(z) for z in z0]
    moments = [(torch.zeros_like(z), torch.zeros_like(z)) for z in z0]
    wd, lr = edit["v_weight_decay"], edit["v_lr"]
    ta = edit["text_repr_loss_scale_factor"]
    at = torch.arange(P, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(rng_seed))
    for step in range(edit["v_num_grad_steps"]):
        draws = []
        for _ in range(C):
            torch.randint(0, 1, (P,), generator=gen, device=dev)  # image
            post = torch.randn((P, hw, hw, ch), generator=gen, device=dev)
            noise = torch.randn((P, hw, hw, ch), generator=gen, device=dev)
            t = torch.randint(0, samplers.T_TRAIN, (P,), generator=gen,
                              device=dev)
            draws.append((post.permute(0, 3, 1, 2),
                          noise.permute(0, 3, 1, 2), t))
        grads = [torch.zeros_like(d) for d in deltas]
        for j, c in enumerate(rows):
            post, noise, t = draws[c]
            lat = mean[j] + torch.exp(0.5 * logvar[j]) * post
            noisy = samplers.add_noise(lat, noise, t)
            d = [x[j].clone().requires_grad_() for x in deltas]
            inj = [torch.zeros((P, S, x.shape[-1]), device=dev).index_put(
                (at, pos[c]), x.expand(P, -1)) for x in d]
            ctx, pool1, pool2 = condition(p, cfg, src[c], src_2[c],
                                          inject_1=(L[1], inj[0]),
                                          inject_2=(L[2], inj[1]))
            loss = sum(wd * torch.sqrt(x.pow(2).sum() + 1e-12) / n[j] ** 2
                       for x, n in zip(d, z0n))
            loss = loss + ta * ((pool1 - pool1_d[j]).pow(2).mean()
                                + (pool2 - pool2_d[j]).pow(2).mean())
            g = list(torch.autograd.grad(loss, d, retain_graph=True))
            for k in range(P):
                one = slice(k, k + 1)
                with torch.no_grad():
                    e_d = unet.unet(p, ucfg, noisy[one], t[one], ctx_d[j, one],
                                    {"text_embeds": pool2_d[j, one],
                                     "time_ids": tid})
                with recomputed_transformers(p.fp8):
                    e = unet.unet(p, ucfg, noisy[one], t[one], ctx[one],
                                  {"text_embeds": pool2[one],
                                   "time_ids": tid})
                gk = torch.autograd.grad((e - e_d).pow(2).mean() / P, d,
                                         retain_graph=k < P - 1)
                g = [a + b for a, b in zip(g, gk)]
            for x, gx in zip(grads, g):
                x[j] = gx
        with torch.no_grad():
            n = step + 1
            b1, b2 = pipelines.ADAM_B1, pipelines.ADAM_B2
            eps = pipelines.ADAM_EPS
            for x, (m1, m2), gx, zn in zip(deltas, moments, grads, z0n):
                m1.mul_(b1).add_(gx, alpha=1 - b1)
                m2.mul_(b2).addcmul_(gx, gx, value=1 - b2)
                x -= lr * (m1 / (1 - b1 ** n)) / (
                    torch.sqrt(m2 / (1 - b2 ** n)) + eps)
                x *= torch.clamp(edit["clamp_norm_factor"] * zn
                                 / x.norm(dim=-1).clamp_min(1e-12),
                                 max=1.0)[:, None]
    return {"z": [z + x for z, x in zip(z0, deltas)], "z0": z0}


@torch.no_grad()
def covariances(p: Prec, cfg: Dict, ids: torch.Tensor, mask: torch.Tensor,
                edit: Dict, batch: int = 250) -> List[List[torch.Tensor]]:
    """Per encoder, E[k k^T] (float64) of each edited layer's fc2 inputs
    over the real tokens of the captions ``ids`` (N, S) with padding
    ``mask``."""
    out = []
    for which, layers in ((1, edit["layers"]), (2, edit["layers_2"])):
        pe = encoder(p, which)
        acc: Dict[int, torch.Tensor] = {}
        for i in range(0, ids.shape[0], batch):
            real = mask[i:i + batch].bool()

            def patch(layer, h, fc2_in, fc2_out):
                if layer in layers:
                    k = fc2_in[real].double()
                    acc[layer] = k.T @ k + acc.get(layer, 0.0)
                return h

            clip.encode(pe, cfg[KEY[which]], ids[i:i + batch],
                        stop_at=max(layers), patch=patch)
        out.append([acc[i] / float(mask.sum()) for i in layers])
    return out


def stage2(p: Prec, cfg: Dict, ids: torch.Tensor, pos: torch.Tensor,
           zs: Sequence[torch.Tensor], covs: Sequence[Sequence[torch.Tensor]],
           edit: Dict) -> List[torch.Tensor]:
    """The float64 fc2 updates of encoder 1's edited layers, then encoder
    2's: each encoder's insert (``pipelines.stage2``) from its own z
    ``zs[k]`` (R, H), covariances, layers and ``mom2_update_weight``.  The
    prompts ``ids`` (R*P, S) are the encoder-1 ids of both: attention is
    causal, and the padding after the edit token reaches no key."""
    ups: List[torch.Tensor] = []
    for which, layers, w in ((1, edit["layers"], edit["mom2_update_weight"]),
                             (2, edit["layers_2"],
                              edit["mom2_update_weight_2"])):
        ups += pipelines.stage2(
            encoder(p, which), cfg[KEY[which]], ids, pos, zs[which - 1],
            covs[which - 1], dict(edit, layers=layers,
                                  mom2_update_weight=w))
    return ups
