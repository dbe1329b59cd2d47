"""Covariance (second-moment) pre-cache: C = E[k k^T] of fc2 inputs.

Counterpart of ``emcid_tpu/engine/layer_stats.py``.  Same cache path codec
``{stats_dir}/{model_name}/{ds_name}_stats/{layer_name}_{precision}_
{collect}_t{batch_tokens}_{sample_size}.npz`` and the same npz schema, so
caches move between the two packages.  Caption batches are fixed-shape
(padded to ``batch_size`` rows, attention-mask weighted): masked positions
are exactly zero in the accumulate.  The accumulate runs under
``precise_matmuls``.  ``to_collect`` names the statistics of
``STAT_TYPES`` (``mom2``, ``mean``, ``norm_mean``); with any besides
``mom2`` every statistic sees the real tokens' rows only, gathered on the
host, as in the JAX package.
"""

from __future__ import annotations

import re
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from emcid_torch.stats import (
    CombinedStat,
    Mean,
    NormMean,
    SecondMoment,
    tally,
)

STAT_TYPES = {
    "mom2": SecondMoment,
    "mean": Mean,
    "norm_mean": NormMean,
}


def stats_filename(
    stats_dir,
    model_name: str,
    ds_name: str,
    layer_name: str,
    precision: str = "float32",
    to_collect: Sequence[str] = ("mom2",),
    batch_tokens: int = 3 * 1024,
    sample_size: Optional[int] = None,
) -> Path:
    """Cache path codec (reference layer_stats.py:166-174)."""
    size_suffix = "" if sample_size is None else f"_{sample_size}"
    size_suffix = f"_t{batch_tokens}" + size_suffix
    file_extension = (
        f"{model_name}/{ds_name}_stats/"
        f"{layer_name}_{precision}_{'-'.join(sorted(to_collect))}{size_suffix}.npz"
    )
    return Path(stats_dir) / file_extension


def _layer_index_from_name(layer_name: str) -> int:
    m = re.search(r"layers[._](\d+)", layer_name)
    if m is None:
        raise ValueError(f"cannot parse layer index from {layer_name!r}")
    return int(m.group(1))


@torch.no_grad()
def fc2_inputs(model, input_ids: torch.Tensor, attention_mask: torch.Tensor,
               layer_index: int) -> torch.Tensor:
    """Masked fc2 inputs (B, S, in_dim) f32 of one layer (partial forward);
    padded positions are zero."""
    out = model(input_ids, attention_mask, capture=("fc2_in",),
                stop_at_layer=layer_index)
    feats = out.taps["fc2_in"][layer_index].float()
    return feats * attention_mask.float()[..., None]


def layer_stats_text_encoder(
    model,
    tokenizer,
    layer_name: str,
    stats_dir="data/stats",
    ds_name: str = "ccs_filtered",
    to_collect: Sequence[str] = ("mom2",),
    model_name: str = "text_encoder",
    sample_size: Optional[int] = None,
    precision: str = "float32",
    batch_tokens: int = 3 * 1024,
    batch_size: int = 100,
    captions: Optional[Sequence[str]] = None,
    force_recompute: bool = False,
    max_length: Optional[int] = None,
) -> CombinedStat:
    """Load-or-compute the cached statistics ``to_collect`` of one
    layer's fc2 input."""
    filename = stats_filename(stats_dir, model_name, ds_name, layer_name,
                              precision, to_collect, batch_tokens, sample_size)
    stat = CombinedStat(**{k: STAT_TYPES[k]() for k in to_collect})
    if captions is None and not filename.exists():
        raise FileNotFoundError(
            f"stats cache {filename} missing and no caption corpus provided")
    loader = tally(
        stat, list(captions) if captions is not None else [],
        cache=(str(filename) if not force_recompute else None),
        sample_size=sample_size, batch_size=batch_size, random_sample=1,
        quiet=True)
    layer_index = _layer_index_from_name(layer_name)
    max_length = max_length or tokenizer.model_max_length
    device = next(model.parameters()).device
    for batch_texts in loader:
        enc = tokenizer(batch_texts, padding="max_length", truncation=True,
                        max_length=max_length)
        ids = np.asarray(enc["input_ids"], np.int64)
        mask = np.asarray(enc["attention_mask"], np.int64)
        pad = batch_size - ids.shape[0]
        if pad > 0:  # zero-mask rows add nothing; only the count is masked
            ids = np.pad(ids, ((0, pad), (0, 0)))
            mask = np.pad(mask, ((0, pad), (0, 0)))
        ids_t = torch.as_tensor(ids, device=device)
        mask_t = torch.as_tensor(mask, device=device)
        feats = fc2_inputs(model, ids_t, mask_t, layer_index)
        flat = feats.reshape(-1, feats.shape[-1])
        if set(to_collect) == {"mom2"}:
            stat.mom2.add(flat, n_valid=int(mask.sum()))
        else:  # Mean and NormMean must see the real tokens only
            real = torch.as_tensor(mask.reshape(-1).astype(bool),
                                   device=device)
            stat.add(flat[real])
    return stat


def get_cov_text_encoder(
    model,
    tokenizer,
    layer_name: str,
    mom2_dataset: str = "ccs_filtered",
    mom2_n_samples: Optional[int] = None,
    mom2_dtype: str = "float32",
    stat_dir="data/stats",
    model_name: str = "text_encoder",
    captions: Optional[Sequence[str]] = None,
    force_recompute: bool = False,
    verbose: bool = True,
) -> torch.Tensor:
    """The count-normalized second moment (in_dim, in_dim) f32, on the
    model's device.  The npz cache is the memo (the JAX package's extra
    in-process dict keyed by layer name is not kept)."""
    if verbose:
        print(f"Retrieving covariance statistics for {model_name} @ "
              f"{layer_name}.")
    stat = layer_stats_text_encoder(
        model, tokenizer, layer_name, stats_dir=stat_dir,
        ds_name=mom2_dataset, sample_size=mom2_n_samples,
        precision=mom2_dtype, captions=captions,
        force_recompute=force_recompute, model_name=model_name)
    device = next(model.parameters()).device
    return stat.mom2.moment().float().to(device)
