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

``apply_emcid_sdxl`` is the edit of a block, as ``editor.apply_emcid`` is
for SD: covariances, training images, Stage 1 and Stage 2, each phase a
span ``edit.<phase>`` with its seconds in ``timings``.  Each Stage-1 step
is a ``stage1.step`` span, each concept's no-grad dest forward inside it a
``stage1.dest`` span.

CUDA graphs (``compute_z`` says when and how they engage).  On the card
each concept's Stage-1 work replays three captures
(``_capture_concept``): both encoders' forward with their injects and its
backward into them, the edited UNet's eps with its backward into the
context and the pooled embeds, and the dest forward, without a backward.
"""

from __future__ import annotations

from pathlib import Path
from typing import (Any, Callable, Dict, List, NamedTuple, Optional,
                    Sequence, Tuple)

import numpy as np
import torch

from emcid_torch.engine.compute_z import (
    adam_step_,
    clamp_to_ball_,
    count_step,
    prepare_concept_batch,
    stage1_graphs,
)
from emcid_torch.engine.emcid import execute_emcid_text_encoder, z_cache_path
from emcid_torch.hparams import EMCIDHyperParams, EMCIDXLHyperParams
from emcid_torch.models.scheduler import Schedule, add_noise
from emcid_torch.models.sdxl import (
    SDXLComponents,
    generate_sdxl,
    sdxl_condition,
    sdxl_time_ids,
)
from emcid_torch.ops import graphs as cuda_graphs
from emcid_torch.parallel import gather, replicate
from emcid_torch.parallel.distributed import is_writer
from emcid_torch.profiling import each, phase, span


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


def _unet_eps(unet, noisy, t, ctx, pooled, time_ids) -> torch.Tensor:
    """The SDXL UNet's eps (f32) as Stage 1 calls it."""
    return unet(noisy, t, ctx, {"text_embeds": pooled,
                                "time_ids": time_ids}).sample.float()


class TwoEncoderDenoiser:
    """The model's side of the two-encoder Stage-1 loop
    (``stage1_two_encoders``): the edited CLIP encoders ``text1``/``text2``,
    the denoiser ``net`` and the inject layers.  A subclass gives
    ``inputs`` (the noisy input, the model's timesteps and the noise
    term's target from x0, noise and the timestep draw), ``cond_args``
    (the denoiser's conditioning of a concept's edited or dest side),
    ``predict``, ``num_train_timesteps``, ``label`` (the capture warning's)
    and ``key`` (what the captures depend on beyond the loop's shapes)."""

    key: Tuple = ()

    def __init__(self, text1, text2, net, layers):
        self.text1, self.text2, self.net = text1, text2, net
        self.layers = layers

    def condition(self, ids, ids_2, inj1, inj2):
        """(ctx, pool1, pool2) with both injects."""
        return sdxl_condition(self.text1, self.text2, ids, ids_2,
                              inject_1=(self.layers[0], inj1),
                              inject_2=(self.layers[1], inj2))


class SDXLDenoiser(TwoEncoderDenoiser):
    """SDXL's side: DDPM noising, the noise as target, and the UNet's eps
    at the edited or the dest conditioning.  ``on(text1, text2, unet,
    device)`` is the same over a mesh entry's replicas."""

    label = "SDXL Stage 1"

    def __init__(self, text1, text2, unet, schedule: Schedule, layers,
                 time_ids: torch.Tensor):
        super().__init__(text1, text2, unet, layers)
        self.schedule, self.time_ids = schedule, time_ids
        self.num_train_timesteps = schedule.num_train_timesteps

    def on(self, text1, text2, net, device) -> "SDXLDenoiser":
        return SDXLDenoiser(text1, text2, net, self.schedule, self.layers,
                            self.time_ids.to(device))

    def inputs(self, lat, noise, t, device, dtype):
        """(noisy NCHW in ``dtype``, the model's timesteps, the target of
        the noise term) on ``device``."""
        noisy = add_noise(self.schedule, lat, noise, t).permute(0, 3, 1, 2)
        # contiguous, as a captured graph holds it: the UNet's first
        # convolution takes another path on channel-last strides
        noisy = noisy.to(device, dtype, memory_format=torch.contiguous_format)
        return noisy, t.to(device), noise.to(device).permute(0, 3, 1, 2)

    def cond_args(self, c: int, side: str, ctx, pool1, pool2) -> Tuple:
        """The UNet's conditioning arguments of concept ``c``'s ``side``
        ("src" edited, "dst")."""
        return ctx, pool2, self.time_ids

    def predict(self, noisy, t, *cond) -> torch.Tensor:
        return _unet_eps(self.net, noisy, t, *cond)


def _capture_concept(den, cond_in, noisy, t, cond_src, dest_in
                     ) -> Dict[str, cuda_graphs.Captured]:
    """A concept's Stage-1 work at these inputs, captured: ``den.condition
    (ids, ids_2, inj1, inj2)`` -> (ctx, pool1, pool2), backward into the
    injects (``cond``); ``den.predict(noisy, t, *cond_src(ctx, pool1,
    pool2))`` -> (prediction,), backward into the conditioning (``eps``);
    the same at the dest's arguments ``dest_in``, forward only
    (``dest``)."""
    cap = {"cond": cuda_graphs.capture(den.condition, cond_in)}
    outs = (o.detach().requires_grad_() for o in cap["cond"](*cond_in))
    args = tuple(a.detach().requires_grad_(a.requires_grad)
                 for a in cond_src(*outs))
    cap["eps"] = cuda_graphs.capture(den.predict, (noisy, t, *args))
    cap["dest"] = cuda_graphs.capture(den.predict, (noisy, t, *dest_in))
    return cap


def stage1_two_encoders(
    den,
    components,
    requests: Sequence[Dict],
    hparams: EMCIDXLHyperParams,
    latents_mean,
    latents_logvar,
    gen: Optional[torch.Generator] = None,
    mesh=None,
    replay: Optional[SDXLDraws] = None,
    verbose: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """The joint two-delta Stage 1 of SDXL and SD3 -> (zs_1 (C, T, H1),
    zs_2 (C, T, H2)).  ``den`` is the model's side (``SDXLDenoiser``,
    ``engine.sd3.SD3Denoiser``): the conditioning, the noisy input and
    target, the prediction; the rest is shared.  See
    ``compute_z_sdxl_text_encoders`` for the arguments."""
    hp = hparams
    if getattr(hp, "replace_repr", False):
        raise NotImplementedError(
            "replace_repr=True (the reference replaces the hidden state "
            "instead of adding the delta) is not implemented, as in the JAX "
            "package; no shipped hparams JSON uses it")
    text1, text2, net = den.text1, den.text2, den.net
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
        d_pool1_in = d_pool1.reshape(C, P, -1)
        d_pool1 = d_pool1_in.float()
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

    # per concept: (the model's side over its mesh entry's replicas,
    # device), None where that entry belongs to another process
    if mesh is None:
        where = [(den, dev)] * C
    else:
        reps = [(den.on(*m, d), d) for *m, d in zip(
            replicate(text1, mesh), replicate(text2, mesh),
            replicate(net, mesh), mesh.devices)]
        entry = [c * mesh.size // C - mesh.first for c in range(C)]
        where = [reps[e] if 0 <= e < len(reps) else None for e in entry]
    apart = mesh is not None and mesh.spans_processes

    graphs = None if hp.no_noise_loss else stage1_graphs(
        (text1, text2, net), ((z1_layer, z2_layer), P, S,
                              tuple(mean.shape[3:5]), *den.key), mesh)

    d1, d2 = torch.zeros_like(z0_1), torch.zeros_like(z0_2)
    moments = [torch.zeros_like(d) for d in (d1, d1, d2, d2)]
    ar = torch.arange(P, device=dev)
    wd = float(hp.v_weight_decay)
    total = int(hp.v_num_grad_steps)
    step_losses = []
    for step in each("stage1.step", range(total)):
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
                t = torch.randint(0, den.num_train_timesteps, (P,),
                                  generator=gen, device=dev)
            if where[c] is None:  # drawn, run by its own process
                continue
            lat = mean[c, img, ar] + torch.exp(0.5 * logvar[c, img, ar]) * eps
            dn, d = where[c]
            noisy, t, target = dn.inputs(lat, noise, t, d, dtype)
            dc1 = d1[c].clone().requires_grad_()
            dc2 = d2[c].clone().requires_grad_()
            inj1 = torch.einsum("tps,th->psh", mask[c].to(d), dc1.to(d))
            inj2 = torch.einsum("tps,th->psh", mask[c].to(d), dc2.to(d))
            cond_in = (src_ids[c].to(d), src_ids_2[c].to(d), inj1, inj2)
            dest_in = dn.cond_args(c, "dst", d_ctx[c].to(d),
                                   d_pool1_in[c].to(d), d_pool2_in[c].to(d))
            cond_src = lambda *o: dn.cond_args(c, "src", *o)  # noqa: E731
            cap = None if graphs is None else graphs.ready(
                lambda: _capture_concept(dn, cond_in, noisy, t, cond_src,
                                         dest_in), den.label)
            ctx, pool1, pool2 = (dn.condition(*cond_in) if cap is None
                                 else cap["cond"](*cond_in))
            # safe norms: their gradient at delta = 0 is 0, not NaN
            loss = wd * (torch.sqrt(dc1.pow(2).sum() + 1e-12) / z0n_1[c] ** 2
                         + torch.sqrt(dc2.pow(2).sum() + 1e-12)
                         / z0n_2[c] ** 2)
            if not hp.no_noise_loss:
                args = cond_src(ctx, pool1, pool2)
                pred = (dn.predict(noisy, t, *args) if cap is None
                        else cap["eps"](noisy, t, *args)[0])
                with torch.no_grad(), span("stage1.dest"):
                    pred_d = (dn.predict(noisy, t, *dest_in) if cap is None
                              else cap["dest"](noisy, t, *dest_in)[0])
                mse_ablate = (pred - pred_d).pow(2).mean()
                mse_noise = (pred - target).pow(2).mean()
                loss = (samp_w[c] * mse_noise + (1.0 - samp_w[c]) * mse_ablate
                        ).to(dev) + loss
            if hp.cal_text_repr_loss:
                loss = loss + ta_w[c] * hp.text_repr_loss_scale_factor * (
                    (pool1.float().to(dev) - d_pool1[c]).pow(2).mean()
                    + (pool2.float().to(dev) - d_pool2[c]).pow(2).mean())
            g1[c], g2[c] = torch.autograd.grad(loss, (dc1, dc2))
            concept_loss[c] = loss.detach()
        count_step(graphs)
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
        print(f"{den.label}: final loss {float(step_losses[-1]):.6f}")
    return (z0_1 + d1).cpu().numpy(), (z0_2 + d2).cpu().numpy()


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
    den = SDXLDenoiser(
        components.text_encoder, components.text_encoder_2, components.unet,
        components.schedule, (hparams.layers[-1], hparams.layers_2[-1]),
        sdxl_time_ids(len(requests[0]["prompts"]), height, width,
                      device=components.device))
    return stage1_two_encoders(den, components, requests, hparams,
                               latents_mean, latents_logvar, gen=gen,
                               mesh=mesh, replay=replay, verbose=verbose)


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
    from emcid_torch.engine.training_images import (
        encode_posterior,
        resolve_cfg_interval,
    )

    cfg_interval = resolve_cfg_interval(cfg_interval, num_inference_steps)

    def render(c, prompts, seeds):
        return generate_sdxl(components, prompts, seeds,
                             num_inference_steps=num_inference_steps,
                             height=height, width=width, guidance_scale=7.5,
                             cfg_interval=cfg_interval)

    return training_posteriors(
        requests, hparams, height, render,
        lambda arr: encode_posterior(components.sd_view(), arr), verbose)


def training_posteriors(requests: Sequence[Dict], hparams, height: int,
                        render: Callable, encode: Callable,
                        verbose: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(C, Simg, P, h, w, c) posterior (mean, logvar) of each request's
    training images: its ``images`` or ``training_img_paths``, else
    ``render(c, prompts, seeds)`` (uint8) of its source prompts, one seed
    ``seed_train * 10007 + s * 101 + p`` each; ``encode`` maps all of
    them, in [-1, 1], to the posterior."""
    import os

    from emcid_torch.engine.training_images import preprocess_images

    Simg = getattr(hparams, "samples_per_prompt", 1)
    P = len(requests[0]["prompts"])
    imgs_all = []
    for c, request in enumerate(requests):
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
                print(f"generating {len(prompts)} training images")
            imgs = render(c, prompts, seeds)
            arr = imgs.astype(np.float32) / 255.0 * 2.0 - 1.0
        imgs_all.append(arr)
    mean, logvar = encode(np.concatenate(imgs_all))
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


def keep_z_pairs(requests: Sequence[Dict], rows: Sequence[int], z1, z2,
                 zs_1: List, zs_2: List, cache_name: Optional[str], hparams):
    """Put Stage 1's (z1[k], z2[k]) at ``rows[k]`` of ``zs_1``/``zs_2`` and,
    with ``cache_name``, into the two-file z cache (``load_z_pairs``)."""
    for k, i in enumerate(rows):
        zs_1[i], zs_2[i] = z1[k], z2[k]
        if cache_name is not None and is_writer():
            p1, p2 = z_cache_paths(cache_name, requests[i], hparams)
            p1.parent.mkdir(exist_ok=True, parents=True)
            np.savez(p1, v_star=z1[k])
            np.savez(p2, v_star=z2[k])


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
    with phase("edit.stage1", timings, "stage1"):
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
            keep_z_pairs(requests, missing, z1, z2, zs_1, zs_2, cache_name,
                         hparams)
        sync()
    with phase("edit.stage2", timings, "stage2"):
        out = execute_emcid_sd_xl_text_encoders(
            components, requests, hparams, np.stack(zs_1), np.stack(zs_2),
            covs_1, covs_2, mom2_weight=mom2_weight,
            mom2_weight_2=mom2_weight_2, edit_weight=edit_weight,
            verbose=verbose)
        sync()
    return out


def apply_emcid_sdxl(
    components: SDXLComponents,
    requests: Sequence[Dict],
    hparams: EMCIDXLHyperParams,
    mom2_weight=None,
    mom2_weight_2=None,
    edit_weight=None,
    cache_name: Optional[str] = None,
    stats_dir_1=None,
    stats_dir_2=None,
    captions: Optional[Sequence[str]] = None,
    height: int = 1024,
    width: int = 1024,
    num_inference_steps: int = 50,
    cfg_interval: Optional[float] = None,
    mesh=None,
    rng_seed: int = 0,
    timings: Optional[Dict[str, float]] = None,
    verbose: bool = True,
) -> Tuple[Dict, Dict, SDXLComponents]:
    """The SDXL edit of a block -> (deltas_1, deltas_2, edited
    components): both encoders' covariances (``resolve_covariances_sdxl``
    over ``stats_dir_1``/``stats_dir_2`` and ``captions``), SDXL training
    images of the concepts the two-file z cache lacks
    (``sdxl_training_latents``: ``num_inference_steps`` DDIM steps at
    ``height`` x ``width``, ``cfg_interval``; placed at their requests'
    rows of a posterior of every request), then
    ``apply_emcid_to_sdxl_text_encoders`` (Stage 1 from ``rng_seed``,
    Stage 2).  ``timings`` (when given) collects the seconds of each
    phase under ``apply_emcid``'s keys: "covariances", "generation" (only
    when a z is computed), "stage1", "stage2"; each phase is the span
    ``edit.<phase>`` (``edit.train_images`` for "generation")."""
    timings = {} if timings is None else timings
    dev = components.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    with phase("edit.covariances", timings, "covariances"):
        covs_1, covs_2 = resolve_covariances_sdxl(
            components, hparams, stats_dir_1, stats_dir_2,
            captions=captions, verbose=verbose)
        sync()
    missing = load_z_pairs(requests, cache_name, hparams)[2]
    mean = logvar = None
    if missing:
        with phase("edit.train_images", timings, "generation"):
            post = sdxl_training_latents(
                components, [requests[i] for i in missing], hparams,
                height=height, width=width,
                num_inference_steps=num_inference_steps,
                cfg_interval=cfg_interval, verbose=verbose)
            mean, logvar = (
                a.new_zeros((len(requests),) + a.shape[1:]).index_copy_(
                    0, torch.as_tensor(missing, device=a.device), a)
                for a in post)
            sync()
    return apply_emcid_to_sdxl_text_encoders(
        components, requests, hparams, mean, logvar, covs_1, covs_2,
        mom2_weight=mom2_weight, mom2_weight_2=mom2_weight_2,
        edit_weight=edit_weight, cache_name=cache_name, height=height,
        width=width, mesh=mesh, rng_seed=rng_seed, timings=timings,
        verbose=verbose)
