"""UNet region editing: spread a closed-form edit through conv / attn-out
sub-blocks.

Counterpart of ``emcid_tpu/engine/unet_edit.py``.  The editable kinds are
``res-last-conv`` (a resnet's conv2, 3x3), ``attn-out`` (``attn2.to_out.0``)
and ``mlp`` (``ff.net.2``).  A conv is edited like a linear layer: with W as
the (out*k*k, in) matrix "o i h w -> (o h w) i", ``W x[p]`` gives, for
every input position p, the k*k contributions that fold into the output
positions around p, so the keys are the module's inputs at the points of
the k-dilated region, and the desired pre-fold output is the unfold of the
masked output delta with its window turned by 180 degrees.

Stage 1 (``compute_delta_unet``) optimizes one channel delta per time
block on the final layer's output inside the region, injected through
``models.unet.unet_inject``.  Stage 2 (``execute_emcid_unet``) walks back
through the same-kind sub-blocks (``retrieve_spreading_layers``) and
solves each, earliest first, on the progressively edited model, with the
residual spread as ``sources / (L - i)`` and the float64 host solve.

JAX details kept: the region mask is resized with half-pixel centres
(``nearest-exact``, as ``jax.image.resize(..., "nearest")``); conv taps
are flattened to (B, H*W, C) in row-major (h, w) order (JAX's NHWC
layout); Stage 1's clamp divides by the norm of the whole delta, not of
the rows it clamps; the original output of each time block is one
image's region mean at one timestep of the block (``single``) or the
batch mean (``batchmean``), by ``EMCID_TPU_UNET_ORIG_EST`` read at call
time.  The JAX package's ``EMCID_TPU_Z_CHUNK`` and its compile caches are
its own compile plumbing and have no counterpart here.

Record/replay: ``compute_delta_unet(replay=DeltaDraws(...))``,
``capture_module_inputs(replay=InputDraws(...))`` and
``execute_emcid_unet(replay=[RegionDraws(...), ...])`` take the draws the
generators would make; the generators are then not read.  Without replay,
each request's region draws come from a generator seeded by (``seed``,
request index), so the desired outputs and every layer's keys of one
request see the same draws, as in the JAX package.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from emcid_torch.engine.compute_z import _f32, adam_step_
from emcid_torch.engine.uce import _with_new_weights
from emcid_torch.models.pipeline import SDComponents, encode_prompts
from emcid_torch.models.scheduler import add_noise
from emcid_torch.models.unet import unet_inject, unet_taps
from emcid_torch.ops.solve import solve_adj_k
from emcid_torch.runtime import precise_matmuls

# ---------------------------------------------------------------------------
# layer walk
# ---------------------------------------------------------------------------

_NUM_DOWN = 4
_NUM_UP = 4


def list2name(layer: Sequence) -> str:
    """["up_blocks", 3, "attn-out", 2] -> dotted module name."""
    kind = layer[2]
    tmp = {
        "attn-out": "{}.{}.attentions.{}.transformer_blocks.0.attn2.to_out.0",
        "mlp": "{}.{}.attentions.{}.transformer_blocks.0.ff.net.2",
        "res-last-conv": "{}.{}.resnets.{}.conv2",
        "downsampler-conv": "{}.{}.downsamplers.0.conv",
        "upsampler-conv": "{}.{}.upsamplers.0.conv",
    }[kind]
    name = tmp.format(layer[0], layer[1], layer[3])
    if "mid_block" in name:
        name = name.replace(f"mid_block.{layer[1]}.", "mid_block.")
    return name


def backward_const_res_single(layer: List) -> List:
    """One backward step through same-resolution sub-blocks."""
    group, idx, kind, sub = layer[0], layer[1], layer[2], layer[3]
    if "sampler" in kind:
        raise ValueError("Cannot backward across sampler")

    if group == "down_blocks" and idx < _NUM_DOWN - 1:
        if idx == 0 and "res" in kind and sub == 0:
            raise ValueError("at start of down_blocks, cannot backward")
        if sub == 0 and "res" in kind:
            return ["down_blocks", idx - 1, "downsampler-conv", 0]
        if "attn" in kind:
            return ["down_blocks", idx, "res-last-conv", sub]
        return ["down_blocks", idx, "attn-out", sub - 1]

    if group == "down_blocks" and idx == _NUM_DOWN - 1:
        if sub == 0:
            return ["down_blocks", idx - 1, "downsampler-conv", 0]
        return ["down_blocks", idx, "res-last-conv", sub - 1]

    if group == "mid_block":
        if "attn" in kind:
            return ["mid_block", idx, "res-last-conv", sub]
        if sub == 0:
            return ["down_blocks", _NUM_DOWN - 1, "res-last-conv", 1]
        return ["mid_block", idx, "attn-out", sub - 1]

    if group == "up_blocks" and idx > 0:
        if sub == 0 and "res" in kind:
            return ["up_blocks", idx - 1, "upsampler-conv", 0]
        if "attn" in kind:
            return ["up_blocks", idx, "res-last-conv", sub]
        return ["up_blocks", idx, "attn-out", sub - 1]

    if group == "up_blocks" and idx == 0:
        if sub == 0:
            return ["mid_block", 0, "res-last-conv", 1]
        return ["up_blocks", idx, "res-last-conv", sub - 1]

    raise ValueError("reach unexpected condition")


def retrieve_spreading_layers(hparams) -> List[Tuple[str, List]]:
    """(module name, layer coords), final layer first, keeping only the
    layers of the final layer's kind (other kinds have other key widths)."""
    current = list(hparams.final_layer)
    if len(current) == 3:  # shipped configs give 3 fields, sub index implied
        current = current + [2 if current[0] == "up_blocks" else 1]
    out = [(list2name(current), list(current))]
    for _ in range(hparams.spread_sub_block_cnt):
        current = backward_const_res_single(current)
        if current[2] != out[0][1][2]:
            continue
        if getattr(hparams, "skip_res_conv", False) and "res" in current[2]:
            continue
        out.append((list2name(current), list(current)))
    return out


# ---------------------------------------------------------------------------
# conv-as-matmul machinery
# ---------------------------------------------------------------------------


def dilate(mask: torch.Tensor, kernel_size: int) -> torch.Tensor:
    """Binary dilation of (B, H, W) masks with a k x k window."""
    k = torch.ones((1, 1, kernel_size, kernel_size), dtype=mask.dtype,
                   device=mask.device)
    out = F.conv2d(mask[:, None], k, padding=kernel_size // 2)[:, 0]
    return torch.clamp(out, 0.0, 1.0)


def resize_nearest(mask: torch.Tensor, side: int) -> torch.Tensor:
    """(B, H, W) -> (B, side, side) nearest, sampling half-pixel centres
    as ``jax.image.resize(..., "nearest")`` does (8 -> 4 reads rows 1, 3,
    5, 7; torch's ``"nearest"`` would read 0, 2, 4, 6)."""
    return F.interpolate(mask[:, None], size=(side, side),
                         mode="nearest-exact")[:, 0]


def conv_weight_as_matrix(weight: torch.Tensor) -> torch.Tensor:
    """Conv weight (out, in, kh, kw) -> (out*kh*kw, in): "o i h w ->
    (o h w) i"."""
    cout, cin, kh, kw = weight.shape
    return weight.permute(0, 2, 3, 1).reshape(cout * kh * kw, cin)


def matrix_as_conv_weight(mat: torch.Tensor, kh: int, kw: int
                          ) -> torch.Tensor:
    cout = mat.shape[0] // (kh * kw)
    return mat.reshape(cout, kh, kw, mat.shape[1]).permute(0, 3, 1, 2)


def pre_fold_output_delta(output_delta: torch.Tensor, ksz: int
                          ) -> torch.Tensor:
    """Masked output delta (B, C, H, W) -> pre-fold delta (B, H*W, C*k*k):
    the unfold of delta / k^2 with the window turned by 180 degrees,
    ordered (c, kh, kw) as ``conv_weight_as_matrix``'s rows; points in
    row-major (h, w) order."""
    B, C, H, W = output_delta.shape
    patches = F.unfold(output_delta / (ksz ** 2), ksz, padding=ksz // 2)
    p = patches.reshape(B, C, ksz, ksz, H * W).flip(2, 3)
    return p.reshape(B, C * ksz * ksz, H * W).transpose(1, 2)


def _is_conv(kind: str) -> bool:
    return "conv" in kind or "res" in kind


def _module_weight(unet, name: str, kind: str
                   ) -> Tuple[torch.Tensor, int, Optional[torch.Tensor]]:
    """(W as an (out*k*k, in) f32 matrix, k, f32 bias).  The bias is
    returned for both kinds: the pre-fold output always adds
    ``repeat_interleave(bias, k*k)``."""
    mod = unet.get_submodule(name)
    bias = None if mod.bias is None else mod.bias.float()
    if _is_conv(kind):
        return (conv_weight_as_matrix(mod.weight.float()),
                mod.weight.shape[2], bias)
    return mod.weight.float(), 1, bias


@torch.no_grad()
def _set_module_weight(unet, name: str, kind: str, w_mat: torch.Tensor
                       ) -> None:
    """Write the (out*k*k, in) matrix ``w_mat`` into the module's weight,
    in place, in the weight's dtype."""
    p = unet.get_submodule(name).weight
    if _is_conv(kind):
        w_mat = matrix_as_conv_weight(w_mat, p.shape[2], p.shape[3])
    p.copy_(w_mat.to(p.device, p.dtype))


# ---------------------------------------------------------------------------
# activation capture at regions
# ---------------------------------------------------------------------------

_TAP_IN = {"attn-out": "attn_out_in", "mlp": "ff2_in",
           "res-last-conv": "conv2_in"}
_TAP_OUT = {"attn-out": "attn_out_out", "mlp": "ff2_out",
            "res-last-conv": "conv2_out"}


def _owner_path(name: str, kind: str) -> str:
    """Module name -> the module that owns its tap (the attn2, the ff, the
    resnet)."""
    if kind == "attn-out":
        return name.rsplit(".to_out", 1)[0]
    if kind == "mlp":
        return name.rsplit(".net", 1)[0]
    return name.rsplit(".conv2", 1)[0]


def _inject_path(name: str, kind: str) -> str:
    if kind == "attn-out":
        return name.rsplit(".to_out", 1)[0]  # the attn2 output
    return name  # ...ff.net.2 or ...conv2


def _tap_rows(x: torch.Tensor) -> torch.Tensor:
    """A tap as (B, N, C) f32: conv maps NCHW -> (B, H*W, C) in row-major
    (h, w) order."""
    if x.dim() == 4:
        B, C, H, W = x.shape
        x = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
    return x.float()


def _module_side(unet, name: str, latent_hw: int) -> int:
    """Spatial side of a down/mid/up block's resnets and attentions at
    square latents of side ``latent_hw`` (each downsampler halves it)."""
    n = len(unet.config.block_out_channels)
    group = name.split(".")[0]
    if group == "mid_block":
        return latent_hw >> (n - 1)
    lvl = int(name.split(".")[1])
    return latent_hw >> (lvl if group == "down_blocks" else n - 1 - lvl)


def _source_prompts(request: Dict) -> List[str]:
    if "prompts" in request:
        return [p.format(request["source"]) for p in request["prompts"]]
    return list(request["source_prompts"])


def _eps(unet, noisy_nhwc: torch.Tensor, ts: torch.Tensor, ctx) -> Any:
    """UNet forward on channel-last noisy latents (result discarded by
    the callers that read a tap)."""
    dtype = next(unet.parameters()).dtype
    return unet(noisy_nhwc.permute(0, 3, 1, 2).to(dtype), ts, ctx).sample


class InputDraws(NamedTuple):
    """``capture_module_inputs``'s draws per timestep: the posterior's
    standard normal draw and the noise, channel-last."""

    post_eps: Any  # (n_t, P, h, w, c)
    noise: Any  # (n_t, P, h, w, c)


@torch.no_grad()
def capture_module_inputs(
    components: SDComponents,
    request: Dict,
    module_name: str,
    kind: str,
    timesteps: Sequence[int],
    latents_mean,
    latents_logvar,
    gen: Optional[torch.Generator] = None,
    replay: Optional[InputDraws] = None,
) -> torch.Tensor:
    """Mean module input over the given timesteps, a fresh posterior draw
    and noise each: (P, H*W or N, C_in) f32."""
    prompts = (list(request["source_prompts"]) if "source_prompts" in request
               else [p.format(request["source"])
                     for p in request.get("prompts", ["{}"])])
    ctx = encode_prompts(components, prompts)
    dev = components.device
    mean = _f32(latents_mean[0], dev)
    logvar = _f32(latents_logvar[0], dev)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    owner, leaf = _owner_path(module_name, kind), _TAP_IN[kind]
    acc = 0.0
    with unet_taps(components.unet, {owner: leaf}) as taps:
        for i, t in enumerate(timesteps):
            if replay is not None:
                eps = _f32(replay.post_eps[i], dev)
                noise = _f32(replay.noise[i], dev)
            else:
                eps = torch.randn(mean.shape, generator=gen, device=dev)
                noise = torch.randn(mean.shape, generator=gen, device=dev)
            latents = mean + torch.exp(0.5 * logvar) * eps
            ts = torch.full((mean.shape[0],), int(t), device=dev)
            _eps(components.unet, add_noise(components.schedule, latents,
                                            noise, ts), ts, ctx)
            acc = acc + _tap_rows(taps[owner][leaf])
    return acc / len(timesteps)


# ---------------------------------------------------------------------------
# Stage 1: per-time-block output delta at the final layer
# ---------------------------------------------------------------------------


class BlockDraws(NamedTuple):
    """``capture_block_outputs``'s draws per time block: the noise, the
    timestep's offset in the block and the image whose region mean is
    read (``single``)."""

    noise: Any  # (n_blocks, P, h, w, c)
    t_offset: Any  # (n_blocks,) int
    img: Any  # (n_blocks,) int


@torch.no_grad()
def capture_block_outputs(
    components: SDComponents,
    ctx: torch.Tensor,
    module_name: str,
    kind: str,
    latents0: torch.Tensor,
    mask_mod: torch.Tensor,
    num_t_blocks: int,
    gen: Optional[torch.Generator] = None,
    replay: Optional[BlockDraws] = None,
) -> torch.Tensor:
    """Per-time-block region-mean module output (num_t_blocks, C_out):
    per block one uniform timestep in the block and fresh noise on
    ``latents0`` (P, h, w, c), then one uniformly drawn image's region
    mean (``EMCID_TPU_UNET_ORIG_EST=single``, the default) or the mean over
    the images (``batchmean``).  ``mask_mod``: (P, N, 1)."""
    est = os.environ.get("EMCID_TPU_UNET_ORIG_EST", "single")
    dev = latents0.device
    n_ts = components.schedule.num_train_timesteps
    block_size = n_ts // num_t_blocks
    B = latents0.shape[0]
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    owner, leaf = _owner_path(module_name, kind), _TAP_OUT[kind]
    den = torch.clamp(mask_mod.sum(dim=1), min=1.0)
    rows = []
    with unet_taps(components.unet, {owner: leaf}) as taps:
        for i in range(num_t_blocks):
            if replay is not None:
                noise = _f32(replay.noise[i], dev)
                off, b = int(replay.t_offset[i]), int(replay.img[i])
            else:
                noise = torch.randn(latents0.shape, generator=gen, device=dev)
                off = int(torch.randint(0, block_size, (), generator=gen,
                                        device=dev))
                b = int(torch.randint(0, B, (), generator=gen, device=dev))
            ts = torch.full((B,), i * block_size + off, device=dev)
            _eps(components.unet, add_noise(components.schedule, latents0,
                                            noise, ts), ts, ctx)
            out = _tap_rows(taps[owner][leaf])
            per_img = (out * mask_mod).sum(dim=1) / den  # (B, C)
            rows.append(per_img.mean(dim=0) if est == "batchmean"
                        else per_img[b])
    return torch.stack(rows)


class DeltaDraws(NamedTuple):
    """``compute_delta_unet``'s draws: the one posterior draw, the draws
    of ``capture_block_outputs`` per time block, and each step's noise
    and timesteps (channel-last latents)."""

    post_eps: Any  # (P, h, w, c)
    orig_noise: Any  # (n_blocks, P, h, w, c)
    orig_t_offset: Any  # (n_blocks,) int
    orig_img: Any  # (n_blocks,) int
    noise: Any  # (steps, P, h, w, c)
    timesteps: Any  # (steps, P) int


def compute_delta_unet(
    components: SDComponents,
    request: Dict,
    hparams,
    latents_mean,
    latents_logvar,
    region_mask,
    gen: Optional[torch.Generator] = None,
    replay: Optional[DeltaDraws] = None,
    verbose: bool = True,
) -> np.ndarray:
    """Optimize per-time-block channel deltas (num_t_blocks, C_out) on the
    final layer's output inside the region.

    One posterior draw before the loop (the original-output capture shares
    it); per step fresh noise and one timestep per prompt, each prompt's
    delta row its timestep's block (``t // block_size``).  Targets: esd
    (``eps_dst - mu (eps_src - eps_dst)``, dest = empty prompts),
    ``use_sampled_noise`` (the noise), else the unedited UNet on the dest
    prompts.  Loss: MSE over the whole eps map plus ``wd |delta[idx]| /
    |orig[idx]|^2``; Adam, then the rows of this step are clamped to
    ``clamp |orig[idx]|``, scaled by ``max / |delta|`` (the whole delta's
    norm, the JAX package's quirk).  ``region_mask``: (P, h, w) at latent
    resolution; ``latents_mean``/``latents_logvar``: (Simg, P, h, w, c),
    the first sample read."""
    hp = hparams
    unet, schedule = components.unet, components.schedule
    dev, dtype = components.device, components.dtype
    final_name, final_layer = retrieve_spreading_layers(hp)[0]
    kind = final_layer[2]
    inject_path = _inject_path(final_name, kind)
    ctx = encode_prompts(components, _source_prompts(request))
    P = ctx.shape[0]
    if hp.objective == "esd":
        dest_prompts = [""] * P
    elif "dest_prompts" in request:
        dest_prompts = request["dest_prompts"]
    elif "prompts" in request and "dest" in request:
        dest_prompts = [p.format(request["dest"]) for p in request["prompts"]]
    else:
        raise ValueError("non-esd UNet region edits need "
                         "request['dest_prompts']")
    ctx_dst = encode_prompts(components, dest_prompts)
    mean = _f32(latents_mean[0], dev)
    logvar = _f32(latents_logvar[0], dev)
    n_ts = schedule.num_train_timesteps
    n_blocks = hp.num_t_blocks
    block_size = n_ts // n_blocks
    if replay is not None:
        replay = DeltaDraws(*(_f32(a, dev) for a in replay))
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)

    C_out = unet.get_submodule(final_name).weight.shape[0]
    side = _module_side(unet, final_name, mean.shape[1])
    region = _f32(region_mask, dev)
    mask = resize_nearest(region, side).reshape(region.shape[0], -1, 1)

    eps0 = (replay.post_eps if replay is not None
            else torch.randn(mean.shape, generator=gen, device=dev))
    latents0 = mean + torch.exp(0.5 * logvar) * eps0
    orig = capture_block_outputs(
        components, ctx, final_name, kind, latents0, mask, n_blocks, gen=gen,
        replay=None if replay is None else BlockDraws(
            replay.orig_noise, replay.orig_t_offset, replay.orig_img))

    conv_kind = kind == "res-last-conv"
    use_samp = bool(getattr(hp, "use_sampled_noise", False))
    mu = (float(hp.esd_mu) if getattr(hp, "esd_mu", None)
          not in (None, "None") else 1.0)
    wd, clamp = float(hp.v_weight_decay), float(hp.clamp_norm_factor)
    delta = torch.zeros((n_blocks, C_out), device=dev)
    m1, m2 = torch.zeros_like(delta), torch.zeros_like(delta)
    mask_map = mask.reshape(P, 1, side, side)
    losses = []
    for step in range(int(hp.v_num_grad_steps)):
        if replay is not None:
            noise, ts = replay.noise[step], replay.timesteps[step].long()
        else:
            noise = torch.randn(latents0.shape, generator=gen, device=dev)
            ts = torch.randint(0, n_ts, (P,), generator=gen, device=dev)
        idxs = torch.clamp(ts // block_size, 0, n_blocks - 1)
        noisy = add_noise(schedule, latents0, noise, ts).permute(0, 3, 1, 2)
        noisy = noisy.to(dtype)
        with torch.no_grad():
            if hp.objective == "esd":
                eps_dst = unet(noisy, ts, ctx_dst).sample.float()
                eps_src = unet(noisy, ts, ctx).sample.float()
                target = eps_dst - mu * (eps_src - eps_dst)
            elif use_samp:
                target = noise.permute(0, 3, 1, 2)
            else:
                target = unet(noisy, ts, ctx_dst).sample.float()
        leaf = delta.clone().requires_grad_()
        d_sel = leaf[idxs]  # (P, C_out)
        inj = (mask_map * d_sel[:, :, None, None] if conv_kind
               else mask * d_sel[:, None, :])
        with unet_inject(unet, {inject_path: inj}):
            eps_edit = unet(noisy, ts, ctx).sample.float()
        orig_sq = orig[idxs].pow(2).sum()
        loss = ((eps_edit - target).pow(2).mean()
                + wd * torch.sqrt(d_sel.pow(2).sum() + 1e-12)
                / torch.clamp(orig_sq, min=1e-12))
        grad, = torch.autograd.grad(loss, leaf)
        with torch.no_grad():
            adam_step_(delta, m1, m2, grad, float(hp.v_lr), step + 1)
            sel = delta[idxs]
            sel_n = torch.sqrt(sel.pow(2).sum() + 1e-12)
            max_n = clamp * torch.sqrt(orig_sq + 1e-12)
            clamped = delta.clone()
            clamped[idxs] = sel * (max_n / torch.sqrt(delta.pow(2).sum()
                                                      + 1e-12))
            delta.copy_(torch.where(sel_n > max_n, clamped, delta))
        losses.append(loss.detach())
    if verbose and losses:
        print(f"unet delta opt: loss {float(losses[0]):.5f} -> "
              f"{float(losses[-1]):.5f}")
    return delta.cpu().numpy()


# ---------------------------------------------------------------------------
# Stage 2: spread + solve
# ---------------------------------------------------------------------------


class RegionDraws(NamedTuple):
    """``_region_io``'s draws for one request: the posterior's standard
    normal draw and the noise of every (block, step) in block-major order,
    channel-last."""

    post_eps: Any  # (P, h, w, c)
    noise: Any  # (n_blocks * per_block, P, h, w, c)


def _region_io(
    components: SDComponents,
    request: Dict,
    hparams,
    name: str,
    kind: str,
    lm,
    lv,
    region_mask,
    gen: Optional[torch.Generator] = None,
    replay: Optional[RegionDraws] = None,
    delta=None,
    num_step_per_block: int = 4,
):
    """Region keys and pre-fold outputs of one request at one module:

    * one posterior draw; per time block the timesteps ``range(b*bs,
      (b+1)*bs, bs // num_step_per_block)`` (not truncated: 4 or 5), fresh
      noise each; the module inputs averaged per block;
    * keys (Npts, C_in): the block means at the k-dilated region points,
      in (block, image, point) order;
    * ``orig_pf = keys W^T + repeat_interleave(bias, k*k)``;
    * with ``delta`` (n_blocks, C_out): ``desired = orig_pf`` plus the
      masked per-block output delta, pre-folded, at the same points.

    Returns (keys, orig_pf, desired or None), f32 on the device."""
    hp = hparams
    unet, dev = components.unet, components.device
    ctx = encode_prompts(components, _source_prompts(request))
    mean = _f32(lm[0], dev)
    logvar = _f32(lv[0], dev)
    num_imgs = mean.shape[0]
    n_blocks = hp.num_t_blocks
    block_size = components.schedule.num_train_timesteps // n_blocks
    stride = max(block_size // num_step_per_block, 1)
    ts_list = [list(range(b * block_size, (b + 1) * block_size, stride))
               for b in range(n_blocks)]
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    eps0 = (_f32(replay.post_eps, dev) if replay is not None
            else torch.randn(mean.shape, generator=gen, device=dev))
    latents0 = mean + torch.exp(0.5 * logvar) * eps0

    owner, leaf = _owner_path(name, kind), _TAP_IN[kind]
    inputs_b = []
    i = 0
    with torch.no_grad(), unet_taps(unet, {owner: leaf}) as taps:
        for ts_b in ts_list:
            acc = 0.0
            for t in ts_b:
                noise = (_f32(replay.noise[i], dev) if replay is not None
                         else torch.randn(mean.shape, generator=gen,
                                          device=dev))
                i += 1
                ts = torch.full((num_imgs,), t, device=dev)
                _eps(unet, add_noise(components.schedule, latents0, noise,
                                     ts), ts, ctx)
                acc = acc + _tap_rows(taps[owner][leaf])
            inputs_b.append(acc / len(ts_b))
    N = inputs_b[0].shape[1]
    side = int(round(N ** 0.5))

    w_mat, ksz, bias = _module_weight(unet, name, kind)
    mask = resize_nearest(_f32(region_mask, dev), side)
    in_mask = dilate(mask, ksz) if ksz > 1 else mask
    sel = in_mask.reshape(num_imgs, N) > 0.5  # the same points every block

    l_inputs = torch.cat([inputs_b[b][img][sel[img]]
                          for b in range(n_blocks)
                          for img in range(num_imgs)])  # (Npts, C_in)
    bias_rep = (0.0 if bias is None
                else torch.repeat_interleave(bias, ksz * ksz))
    with precise_matmuls():
        orig_pf = l_inputs @ w_mat.T + bias_rep  # (Npts, out*k*k)

    desired = None
    if delta is not None:
        d = _f32(delta, dev)  # (n_blocks, C_out)
        out_delta = (mask[None, :, None] * d[:, None, :, None, None]).reshape(
            n_blocks * num_imgs, d.shape[1], side, side)
        pf = (pre_fold_output_delta(out_delta, ksz) if ksz > 1
              else _tap_rows(out_delta))
        pf = pf.reshape(n_blocks, num_imgs, N, -1)
        desired = orig_pf + torch.cat([pf[b, img][sel[img]]
                                       for b in range(n_blocks)
                                       for img in range(num_imgs)])
    return l_inputs, orig_pf, desired


def region_generator(dev, seed: int, r: int) -> torch.Generator:
    """The generator of request ``r``'s region draws under ``seed``."""
    return torch.Generator(device=dev).manual_seed(seed * 1_000_003 + r)


def execute_emcid_unet(
    components: SDComponents,
    requests: Sequence[Dict],
    hparams,
    deltas_star: Sequence[np.ndarray],
    region_masks: Sequence[np.ndarray],
    latents: Sequence[Tuple[Any, Any]],
    cov,
    mom2_weight=None,
    num_steps_per_block: int = 4,
    seed: int = 0,
    replay: Optional[Sequence[RegionDraws]] = None,
    verbose: bool = True,
) -> Tuple[Dict, SDComponents]:
    """Insert the optimized final-layer deltas by editing the spreading
    sub-blocks:

    * the desired pre-fold targets are computed once, at the final layer
      on the unedited model;
    * each spreading layer, earliest first, reads its keys and current
      pre-fold output on the progressively edited model (so later layers
      make up for the drift of earlier edits);
    * ``resid = (desired - cur) / (L - i)``, solved in float64 on the host
      (``solve_adj_k(..., method="f64")``), the update written in the
      weight's dtype.

    ``deltas_star[r]``: (num_t_blocks, C_out); ``latents[r]``: (mean,
    logvar), each (Simg, P, h, w, c); ``cov``: (C_in, C_in) shared, or a
    {layer name: cov} dict.  Returns ({name.weight: (adj_k, resid)},
    components with a new UNet; parameters of other layers are shared)."""
    hp = hparams
    lam = float(mom2_weight if mom2_weight is not None
                else hp.mom2_update_weight)
    layers = retrieve_spreading_layers(hp)
    final_name, final_coords = layers[0]
    dev = components.device

    def io(comps, r, name, kind, delta=None):
        lm, lv = latents[r]
        return _region_io(
            comps, requests[r], hp, name, kind, lm, lv, region_masks[r],
            gen=region_generator(dev, seed, r),
            replay=None if replay is None else replay[r], delta=delta,
            num_step_per_block=num_steps_per_block)

    final_desired = torch.cat([
        io(components, r, final_name, final_coords[2], deltas_star[r])[2]
        for r in range(len(requests))]).T.double()

    unet = _with_new_weights(components.unet, {
        name: components.unet.get_submodule(name).weight
        for name, _ in layers})
    comps = components.replace_unet(unet)
    deltas_out: Dict[str, Tuple[np.ndarray, np.ndarray]] = {}
    n_layers = len(layers)
    for i, (name, coords) in enumerate(reversed(layers)):
        kind = coords[2]
        ios = [io(comps, r, name, kind) for r in range(len(requests))]
        K = torch.cat([k for k, _, _ in ios]).T.double()  # (C_in, Npts)
        cur_pf = torch.cat([c for _, c, _ in ios]).T.double()
        sources = final_desired - cur_pf
        resid = sources / (n_layers - i)
        cov_l = cov[name] if isinstance(cov, dict) else cov
        if torch.is_tensor(cov_l):
            cov_l = cov_l.detach().cpu().numpy()
        adj_k = torch.as_tensor(solve_adj_k(
            np.asarray(cov_l, np.float64), K.cpu().numpy(), lam,
            method="f64"), device=dev)
        upd = resid @ adj_k.T  # (C_out*k*k, C_in), float64
        w_mat, _, _ = _module_weight(unet, name, kind)
        _set_module_weight(unet, name, kind, w_mat.double() + upd)
        deltas_out[f"{name}.weight"] = (adj_k.float().cpu().numpy(),
                                        resid.float().cpu().numpy())
        if verbose:
            print(f"{name}: wrote {K.shape[1]} region keys, z error "
                  f"{float(sources.norm(dim=0).mean()):.4f}, "
                  f"upd norm {float(upd.norm()):.4f}")
    return deltas_out, comps
