"""UNet-layer covariance pre-cache.

Counterpart of ``emcid_tpu/engine/unet_stats.py``: for an editable UNet
module, the second moment of its inputs over (image, caption) pairs, with
one VAE posterior draw per pair and ``t_steps_per_pair`` noised forwards.
The conv taps are NCHW here and are flattened channel-last ((B, H, W, C)
rows, JAX's layout) before ``X^T X``, accumulated in f32 under
``precise_matmuls``.  Cache codec (the JAX package's):
``{stats_dir}/unet/{ds}_stats/{layer}_{prec}_mom2_t{steps}_{pairs}.npz``.

The draws come from ``torch.Generator(rng_seed)`` on the device;
``replay=UnetStatsDraws(...)`` gives them instead (per pair in the
loader's order).
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, NamedTuple, Optional, Sequence, Tuple

import torch

from emcid_torch.engine.compute_z import _f32
from emcid_torch.engine.unet_edit import _TAP_IN, _owner_path, _tap_rows
from emcid_torch.models.pipeline import SDComponents, tokenize
from emcid_torch.models.scheduler import add_noise
from emcid_torch.models.unet import unet_taps
from emcid_torch.runtime import precise_matmuls
from emcid_torch.stats import CombinedStat, SecondMoment, tally


class UnetStatsDraws(NamedTuple):
    """The draws of every pair (in the loader's order): the posterior's
    standard normal draw, and per forward the noise and the timestep,
    channel-last latents."""

    post_eps: Any  # (n_pairs, h, w, c)
    noise: Any  # (n_pairs, steps, h, w, c)
    timesteps: Any  # (n_pairs, steps) int


def unet_stats_filename(stats_dir, ds_name, layer_name, precision,
                        t_steps, n_pairs) -> Path:
    return Path(stats_dir) / (
        f"unet/{ds_name}_stats/"
        f"{layer_name}_{precision}_mom2_t{t_steps}_{n_pairs}.npz")


def layer_stats_unet(
    components: SDComponents,
    layer_name: str,
    kind: str,
    pairs: Sequence[Tuple[Any, str]],
    stats_dir="data/stats",
    ds_name: str = "ccs_filtered",
    t_steps_per_pair: int = 10,
    precision: str = "float32",
    sample_pair_size: Optional[int] = None,
    force_recompute: bool = False,
    rng_seed: int = 0,
    replay: Optional[UnetStatsDraws] = None,
) -> CombinedStat:
    """Second moment of ``layer_name``'s inputs over caption/image pairs
    (image in [-1, 1], (H, W, 3)).  ``kind`` in {"attn-out", "mlp",
    "res-last-conv"} selects the input tap."""
    filename = unet_stats_filename(
        stats_dir, ds_name, layer_name, precision, t_steps_per_pair,
        sample_pair_size or len(pairs))
    stat = CombinedStat(mom2=SecondMoment())
    loader = tally(stat, list(pairs),
                   cache=(str(filename) if not force_recompute else None),
                   sample_size=sample_pair_size, batch_size=1,
                   random_sample=1, quiet=True,
                   collate_fn=lambda items: items[0])
    unet, vae, schedule = (components.unet, components.vae,
                           components.schedule)
    dev, dtype = components.device, components.dtype
    owner, leaf = _owner_path(layer_name, kind), _TAP_IN[kind]
    gen = torch.Generator(device=dev).manual_seed(rng_seed)
    n_ts = schedule.num_train_timesteps
    for i, (img, caption) in enumerate(loader):
        with torch.no_grad(), unet_taps(unet, {owner: leaf}) as taps:
            x = _f32(img, dev)[None].permute(0, 3, 1, 2).to(dtype)
            dist = vae.encode(x)
            mean = dist.mean.float()
            eps = (_f32(replay.post_eps[i], dev)[None].permute(0, 3, 1, 2)
                   if replay is not None else
                   torch.randn(mean.shape, generator=gen, device=dev))
            std = torch.exp(0.5 * torch.clamp(dist.logvar.float(), -30.0,
                                              20.0))
            latents = (mean + std * eps) * components.scaling_factor
            ctx = components.text_encoder(
                tokenize(components, [caption])).last_hidden_state
            total, count = 0.0, 0
            for s in range(t_steps_per_pair):
                if replay is not None:
                    noise = _f32(replay.noise[i][s], dev)[None].permute(
                        0, 3, 1, 2)
                    ts = torch.as_tensor(replay.timesteps[i][s],
                                         device=dev).long().reshape(1)
                else:
                    noise = torch.randn(latents.shape, generator=gen,
                                        device=dev)
                    ts = torch.randint(0, n_ts, (1,), generator=gen,
                                       device=dev)
                unet(add_noise(schedule, latents, noise, ts).to(dtype), ts,
                     ctx)
                feats = _tap_rows(taps[owner][leaf])
                feats = feats.reshape(-1, feats.shape[-1])
                with precise_matmuls():
                    total = total + feats.T @ feats
                count += feats.shape[0]
        if stat.mom2.mom2 is None:
            stat.mom2.mom2 = torch.zeros_like(total)
        stat.mom2.mom2 = stat.mom2.mom2 + total
        stat.mom2.count += count
    return stat
