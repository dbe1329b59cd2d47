"""Ablations (reference experiments/ablation.py): sweeps over edit_weight
(25-142), layer combinations (269-423) and num_edit_tokens (425-576), each
running the AICE protocol and accumulating into the same summary JSONs,
and the I2P guidance sweep (reference experiments/i2p_guidance_ablation.py).

Counterpart of ``emcid_tpu/experiments/ablation.py``, over the port's
``evals/iceb`` and ``evals/i2p_eval``."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from emcid_torch.evals.iceb import emcid_test_text_encoder_imgnet


def edit_weight_ablation(
    components, scorer, hparams, hparam_name,
    edit_weights: Sequence[float] = (0.3, 0.4, 0.5, 0.6, 0.7),
    num_edit: int = 10,
    **kwargs,
) -> Dict[float, Dict]:
    """Sweep the alpha knob (reference ablation.py:25-142)."""
    out = {}
    for ew in edit_weights:
        out[ew] = emcid_test_text_encoder_imgnet(
            components, scorer, hparams, hparam_name,
            num_edit=num_edit, edit_weight=ew, **kwargs,
        )
    return out


def layer_combination_ablation(
    components, scorer, hparams, hparam_name,
    layer_sets: Sequence[Sequence[int]],
    num_edit: int = 10,
    **kwargs,
) -> Dict[str, Dict]:
    """Sweep edited-layer sets (reference ablation.py:269-423); results keyed
    by a "l{a}-{b}" suffix appended to the hparam name."""
    out = {}
    for layers in layer_sets:
        hp = dataclasses.replace(hparams, layers=list(layers))
        name = f"{hparam_name}_l{layers[0]}-{layers[-1]}"
        out[name] = emcid_test_text_encoder_imgnet(
            components, scorer, hp, name, num_edit=num_edit, **kwargs,
        )
    return out


def num_edit_tokens_ablation(
    components, scorer, hparams, hparam_name,
    token_counts: Sequence[int] = (1, 2, 3, 4, 5, 6),
    num_edit: int = 10,
    **kwargs,
) -> Dict[int, Dict]:
    """Sweep num_edit_tokens 1..6 (reference ablation.py:425-576)."""
    out = {}
    for t in token_counts:
        hp = dataclasses.replace(hparams, num_edit_tokens=t)
        name = f"{hparam_name}_tok{t}"
        out[t] = emcid_test_text_encoder_imgnet(
            components, scorer, hp, name, num_edit=num_edit, **kwargs,
        )
    return out


def i2p_guidance_ablation(
    components, rows, out_root,
    guidance_scales: Sequence[float] = (0.0, 1.5, 3.0, 4.5, 6.0, 7.5),
    gen_kwargs: Optional[dict] = None,
) -> Dict[float, str]:
    """Nudity-rate vs guidance scale sweep
    (reference experiments/i2p_guidance_ablation.py:33-80): generates per
    guidance into ``{out_root}/g{scale}`` for external NudeNet runs."""
    from pathlib import Path

    from emcid_torch.evals.i2p_eval import generate_i2p_imgs

    dirs = {}
    for g in guidance_scales:
        rows_g = [dict(r, evaluation_guidance=g) for r in rows]
        d = Path(out_root) / f"g{g}"
        generate_i2p_imgs(components, rows_g, d, gen_kwargs=gen_kwargs)
        dirs[g] = str(d)
    return dirs
