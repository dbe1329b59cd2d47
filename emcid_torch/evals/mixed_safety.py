"""Mixed ICEB + safety editing (reference emcid_test_sd_imgnet_and_i2p,
emcid_test.py:319-576): apply the EMCID text-encoder edit for ICEB concepts,
then the UCE cross-attn edit for unsafe concepts on the SAME pipeline,
evaluate ICEB metrics and generate the I2P images for the external NudeNet
nudity-rate count.

Counterpart of ``emcid_tpu/evals/mixed_safety.py``, over the port's AICE
bundle (``evals/iceb``), ``apply_emcid``, ``edit_model_uce`` and summary
codec (``evals/summary``): the same summary file, key and record."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Sequence

from emcid_torch.evals.iceb import eval_pipe_imgnet
from emcid_torch.evals.summary import (
    lookup_summary,
    summary_key,
    summary_path,
    update_summary,
)


def emcid_test_sd_imgnet_and_i2p(
    components,
    scorer,
    hparams,
    hparam_name: str,
    num_edit: int = 10,
    mom2_weight=None,
    edit_weight=None,
    nsfw_keywords: Sequence[str] = ("nudity",),
    uce_kwargs: Optional[dict] = None,
    dataset_name: str = "imgnet_aug",
    data_dir=None,
    cache_dir=None,
    results_dir=None,
    gen_kwargs: Optional[dict] = None,
    apply_kwargs: Optional[dict] = None,
    i2p_rows: Optional[Sequence[Dict]] = None,
    i2p_out_dir=None,
    specificity_classes: Optional[int] = None,
) -> Dict:
    """EMCID-then-UCE combined edit with ICEB eval + I2P generation."""
    from emcid_torch.dsets import RequestDataset, compose_alias_test_requests
    from emcid_torch.engine.editor import apply_emcid
    from emcid_torch.engine.uce import edit_model_uce

    mom2_weight = mom2_weight if mom2_weight is not None else hparams.mom2_update_weight
    edit_weight = edit_weight if edit_weight is not None else hparams.edit_weight
    spath = summary_path(hparam_name, dataset_name + "_i2p", results_dir)
    key = summary_key(num_edit, mom2_weight, edit_weight)
    existing = lookup_summary(spath, key)
    if existing is not None:
        return existing

    requests = RequestDataset(
        data_dir=data_dir, type="edit", file_name=dataset_name + "_edit.json"
    )[:num_edit]
    val_requests = RequestDataset(
        data_dir=data_dir, type="val", file_name=dataset_name + "_edit.json"
    )[:num_edit]
    alias = compose_alias_test_requests(val_requests, data_dir=data_dir)

    record = eval_pipe_imgnet(
        components, scorer, requests, alias, num_edit, is_edited=False,
        dataset_name=dataset_name, data_dir=data_dir, cache_dir=cache_dir,
        gen_kwargs=gen_kwargs, val_requests=val_requests,
        specificity_classes=specificity_classes,
    )

    # EMCID text-encoder edit for the concepts...
    edited, _ = apply_emcid(
        components, requests, hparams,
        mom2_weight=mom2_weight, edit_weight=edit_weight,
        cache_name=(f"{cache_dir}/{hparam_name}/{dataset_name}/"
                    if cache_dir else None),
        **(apply_kwargs or {}),
    )
    # ...then the UCE cross-attn edit for the unsafe keywords
    # (reference emcid_test.py:377-414)
    edited = edit_model_uce(
        edited, list(nsfw_keywords), [" "] * len(nsfw_keywords),
        **(uce_kwargs or {}),
    )

    record.update(eval_pipe_imgnet(
        edited, scorer, requests, alias, num_edit, is_edited=True,
        dataset_name=dataset_name, data_dir=data_dir, cache_dir=cache_dir,
        gen_kwargs=gen_kwargs, val_requests=val_requests,
        specificity_classes=specificity_classes,
    ))

    if i2p_rows:
        from emcid_torch.evals.i2p_eval import generate_i2p_imgs

        out = Path(i2p_out_dir or
                   f"{results_dir or 'results'}/images/i2p/{hparam_name}_{key}")
        generate_i2p_imgs(edited, i2p_rows, out, gen_kwargs=gen_kwargs)
        record["i2p_image_dir"] = str(out)

    update_summary(spath, key, record)
    return record
