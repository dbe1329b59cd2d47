"""Full CLIP-model joint edit: the ReFACT/contrastive protocol applied to a
standalone CLIP text tower (reference apply_emcid_to_clip /
execute_emcid_clip, emcid_main.py:109-311).

Counterpart of ``emcid_tpu/engine/clip_edit.py``.  The same two stages as
the SD text-encoder edit: Stage 1 is ``compute_z_refact`` (the contrastive
pooled-embedding objective) per request, Stage 2 the same multi-layer fc2
insert over the port's covariances (``layer_stats``).  The model is a
``CLIPTextEncoder`` (typically with a projection) outside any diffusion
pipeline, so the interface is (model, tokenizer).  The edit returns a copy
of the model; the caller's is unchanged.
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from emcid_torch.engine.compute_z_variants import compute_z_refact
from emcid_torch.engine.emcid import (
    execute_emcid_text_encoder,
    load_z_list,
    save_z_cache,
)


def execute_emcid_clip(
    text_model,
    tokenizer,
    requests: Sequence[Dict],
    hparams,
    covs: Optional[Sequence] = None,
    stats_dir=None,
    stats_captions: Optional[Sequence[str]] = None,
    cache_name: Optional[str] = None,
    mom2_weight: Optional[float] = None,
    edit_weight: Optional[float] = None,
    rng_seed: int = 0,
    model_name: str = "clip_text",
    verbose: bool = True,
) -> Tuple[Dict[str, Tuple[np.ndarray, np.ndarray]], torch.nn.Module]:
    """(deltas, edited model copy) for a CLIP text tower
    (reference execute_emcid_clip, emcid_main.py:148-311).

    Per request: the contrastive z (``compute_z_refact``, z-npz cached with
    the reference's source_/dest_ key), then one fused multi-layer
    insert."""
    shim = SimpleNamespace(tokenizer=tokenizer, text_encoder=text_model)
    dev = next(text_model.parameters()).device
    z_list, missing = load_z_list(requests, cache_name, hparams)
    for i in missing:
        z = compute_z_refact(
            shim, requests[i], hparams, hparams.layers[-1],
            rng=torch.Generator(device=dev).manual_seed(rng_seed + i),
            verbose=verbose,
        )
        z_list[i] = z
        if cache_name is not None:
            save_z_cache(cache_name, requests[i], z, hparams, idx=i)
    zs = np.stack([np.asarray(z) for z in z_list])
    if zs.ndim == 2:
        zs = zs[:, None, :]

    if covs is None:
        from emcid_torch.engine.editor import resolve_covariances_for

        covs = resolve_covariances_for(
            text_model, tokenizer, hparams, stats_dir=stats_dir,
            captions=stats_captions, model_name=model_name, verbose=verbose,
        )

    return execute_emcid_text_encoder(
        text_model, tokenizer, requests, hparams,
        zs=zs, covs=covs, mom2_weight=mom2_weight, edit_weight=edit_weight,
        verbose=verbose,
    )


def apply_emcid_to_clip(
    text_model,
    tokenizer,
    requests: Sequence[Dict],
    hparams,
    mom2_weight: Optional[float] = None,
    edit_weight: Optional[float] = None,
    cache_name: Optional[str] = None,
    return_orig_text_model: bool = False,
    **kwargs,
):
    """(edited text model, deltas) (reference apply_emcid_to_clip,
    emcid_main.py:109-146).  The caller's ``text_model`` is untouched;
    ``return_orig_text_model`` keeps the reference signature and hands it
    back as a third value."""
    deltas, new_model = execute_emcid_clip(
        text_model, tokenizer, requests, hparams,
        cache_name=cache_name, mom2_weight=mom2_weight,
        edit_weight=edit_weight, **kwargs,
    )
    if return_orig_text_model:
        return new_model, deltas, text_model
    return new_model, deltas
