"""Concept Rectification benchmark (reference emcid_test_imgnet_mend,
emcid_test.py:57-315; rectify_imgnet_classes.py noise-only training
variant).

Protocol: edit the misgenerated class names (ImageNetMendRequestDataset) →
pre/post source/dest scores on edit + val prompts + specificity, written to
``imgnet_mend_summary.json`` under ``edit{N}_weight{W}[_ew{E}]`` (EMCID) or
``edit{N}`` (the UCE baseline, results/baselines/uce).  Optional COCO
preservation legs ride the coco_eval module (the reference shells out to
pytorch-fid; here FID is native, evals/scorers.py).

Counterpart of ``emcid_tpu/evals/rectification.py``; ``timings`` (when
given) collects what ``evals/iceb.py``'s harness collects.
"""

from __future__ import annotations

import random
import time
from typing import Dict, Optional

from emcid_torch.evals.iceb import (
    _add,
    _sync,
    measure_scores,
    measure_specificity,
)
from emcid_torch.evals.summary import (
    lookup_summary,
    summary_key,
    summary_path,
    update_summary,
)


def emcid_test_imgnet_mend(
    components,
    scorer,
    hparams,
    hparam_name: str,
    num_edit: int = 140,
    method: str = "emcid",
    mom2_weight=None,
    edit_weight=None,
    dataset_name: str = "imgnet_mend",
    data_dir=None,
    cache_dir=None,
    results_dir=None,
    gen_kwargs: Optional[dict] = None,
    specificity_classes: Optional[int] = None,
    apply_kwargs: Optional[dict] = None,
    uce_kwargs: Optional[dict] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """Rectification end-to-end with EMCID or the UCE baseline."""
    from emcid_torch.dsets import ImageNetMendRequestDataset

    mom2_weight = mom2_weight if mom2_weight is not None else hparams.mom2_update_weight
    edit_weight = edit_weight if edit_weight is not None else hparams.edit_weight
    if method == "uce":
        spath = summary_path("../baselines/uce", dataset_name, results_dir)
        key = f"edit{num_edit}"
    else:
        spath = summary_path(hparam_name, dataset_name, results_dir)
        key = summary_key(num_edit, mom2_weight, edit_weight)
    existing = lookup_summary(spath, key)
    if existing is not None:
        print(f"{key} already in {spath}, returning")
        return existing

    requests = ImageNetMendRequestDataset(data_dir=data_dir,
                                          type="edit")[:num_edit]
    val_requests = ImageNetMendRequestDataset(data_dir=data_dir,
                                              type="val")[:num_edit]

    def bundle(comps, is_edited, prefix):
        gsrc, gdst, _ = measure_scores(
            comps, scorer, val_requests, is_edited, "imgnet_aug",
            is_val=True, gen_kwargs=gen_kwargs, cache_dir=cache_dir,
            timings=timings,
        ) if val_requests else (None, None, None)
        esrc, edst, _ = measure_scores(
            comps, scorer, requests, is_edited, "imgnet_aug",
            gen_kwargs=gen_kwargs, cache_dir=cache_dir, timings=timings,
        )
        spec = measure_specificity(
            comps, scorer, is_edited, "imgnet_aug", data_dir=data_dir,
            cache_dir=cache_dir, gen_kwargs=gen_kwargs,
            max_classes=specificity_classes, timings=timings,
        )
        return {
            f"{prefix}_source_score_edit": esrc,
            f"{prefix}_dest_score_edit": edst,
            f"{prefix}_source_score_general": gsrc,
            f"{prefix}_dest_score_general": gdst,
            f"{prefix}_cls_score_specificity": spec,
        }

    t0 = time.time()
    record = bundle(components, False, "pre")
    _add(timings, "pre_edit_eval", time.time() - t0)

    order = list(range(len(requests)))
    random.shuffle(order)
    shuffled = [requests[i] for i in order]
    t0 = time.time()
    if method == "uce":
        from emcid_torch.engine.uce import edit_model_uce

        edited = edit_model_uce(
            components,
            [r["source"] for r in shuffled],
            [r["dest"] for r in shuffled],
            **(uce_kwargs or {}),
        )
    else:
        from emcid_torch.engine.editor import apply_emcid

        cache_name = (f"{cache_dir}/{hparam_name}/{dataset_name}/"
                      if cache_dir else None)
        edited, _ = apply_emcid(
            components, shuffled, hparams,
            mom2_weight=mom2_weight, edit_weight=edit_weight,
            cache_name=cache_name, **(apply_kwargs or {}),
        )
    _sync(edited)
    record["edit_time_s"] = time.time() - t0
    _add(timings, "edit", record["edit_time_s"])

    t0 = time.time()
    record.update(bundle(edited, True, "post"))
    _add(timings, "post_edit_eval", time.time() - t0)
    update_summary(spath, key, record)
    return record
