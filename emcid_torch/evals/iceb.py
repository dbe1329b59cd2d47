"""ICEB AICE benchmark harness (reference experiments/emcid_test.py:991-1216).

Protocol parity: same metrics (efficacy on edit prompts, generalization on
val prompts, alias generality, specificity on held-out classes; each as
source/dest/source-dest ViT class probabilities), same summary-JSON schema
(keys ``edit{N}_weight{W}[_ew{E}]`` with 10 pre + 10 post fields), same
pre-edit image cache layout (``cache/images/{dataset}/train_{class}_{pre}_
{idx}.png``), same idempotent skip.

Counterpart of ``emcid_tpu/evals/iceb.py``.  The reference generates one
image per pipe() call (emcid_test.py:1399-1454); here, as in the JAX
package, every evaluation leg plans its full (prompt, seed, cache-path) job
list first, generates in batches, and scores all images in one batched ViT
pass per leg.  ``timings`` (where a function takes it) collects the
seconds of generation ("generation") and of ViT scoring ("scoring"), the
counts of images generated and scored ("generated_images",
"scored_images") and, in
``emcid_test_text_encoder_imgnet``, the seconds of each phase
("pre_edit_eval", "edit", "post_edit_eval").
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from emcid_torch.evals.scorers import ViTScorer, cls_scores_batched
from emcid_torch.evals.summary import (
    lookup_summary,
    summary_key,
    summary_path,
    update_summary,
)
from emcid_torch.globals_cfg import CACHE_DIR
from emcid_torch.models.pipeline import SDComponents, generate
from emcid_torch.parallel.distributed import is_writer


@dataclass
class _Job:
    prompt: str
    seed: int
    cache_path: Optional[Path]  # load/save here when set (pre-edit legs)
    group: int  # scoring group index


def _add(timings: Optional[Dict[str, float]], key: str, value) -> None:
    if timings is not None:
        timings[key] = timings.get(key, 0) + value


def _sync(components) -> None:
    """Wait for the card, so that a phase's seconds hold its work."""
    dev = getattr(components, "device", None)
    if dev is not None and dev.type == "cuda":
        import torch

        torch.cuda.synchronize()


def _run_jobs(components: SDComponents, jobs: List[_Job], gen_kwargs,
              batch_size: int = 16,
              timings: Optional[Dict[str, float]] = None
              ) -> List[np.ndarray]:
    """Execute generation jobs with file-cache reuse; returns images in
    job order."""
    from PIL import Image

    images: List[Optional[np.ndarray]] = [None] * len(jobs)
    to_gen: List[int] = []
    for i, job in enumerate(jobs):
        if job.cache_path is not None and job.cache_path.exists():
            images[i] = np.asarray(Image.open(job.cache_path).convert("RGB"))
        else:
            to_gen.append(i)
    if to_gen:
        prompts = [jobs[i].prompt for i in to_gen]
        seeds = [jobs[i].seed for i in to_gen]
        t0 = time.time()
        gen = generate(components, prompts, seeds, batch_size=batch_size,
                       **gen_kwargs)
        _add(timings, "generation", time.time() - t0)
        _add(timings, "generated_images", len(to_gen))
        for k, i in enumerate(to_gen):
            images[i] = gen[k]
            if jobs[i].cache_path is not None and is_writer():
                jobs[i].cache_path.parent.mkdir(parents=True, exist_ok=True)
                Image.fromarray(gen[k]).save(jobs[i].cache_path)
    return images  # type: ignore[return-value]


def _score_groups(scorer: ViTScorer, images: List[np.ndarray],
                  jobs: List[_Job], group_class_ids: Dict[int, int],
                  image_size: Optional[int] = None,
                  timings: Optional[Dict[str, float]] = None
                  ) -> Dict[int, float]:
    """Mean class prob per scoring group, one batched ViT pass."""
    order = sorted(range(len(jobs)), key=lambda i: jobs[i].group)
    arr = np.stack([np.asarray(images[i]) for i in order])
    class_ids, sizes, groups = [], [], []
    for i in order:
        g = jobs[i].group
        if groups and groups[-1] == g:
            sizes[-1] += 1
        else:
            groups.append(g)
            sizes.append(1)
            class_ids.append(group_class_ids[g])
    t0 = time.time()
    scores = cls_scores_batched(scorer, arr, class_ids, sizes)
    _add(timings, "scoring", time.time() - t0)
    _add(timings, "scored_images", len(arr))
    return dict(zip(groups, scores))


def generate_cal_cls_score(
    components: SDComponents,
    scorer: ViTScorer,
    requests: Sequence[Dict],
    is_edited: bool,
    img_cache_dir=None,
    is_val: bool = False,
    gen_kwargs: Optional[dict] = None,
    batch_size: int = 16,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, List[float]]:
    """Source/dest/source-dest scores per request
    (reference emcid_test.py:1359-1454), batched."""
    img_cache_dir = Path(img_cache_dir) if img_cache_dir else None
    gen_kwargs = gen_kwargs or {}
    edit_str = "post" if is_edited else "pre"
    name_tmp = ("val_{}_{}_{}.png" if is_val else "train_{}_{}_{}.png")

    jobs: List[_Job] = []
    group_cls: Dict[int, int] = {}
    # groups: 3 per request — source-imgs/source-id, dest-imgs/dest-id,
    # source-imgs/dest-id (scored on the same source images)
    src_ranges: List[Tuple[int, int]] = []
    for r, request in enumerate(requests):
        seeds = request.get("seeds") or [0] * len(request["prompts"])
        indices = request.get("indices", list(range(len(request["prompts"]))))
        for kind, who, cls_key in (("source", request["source"], "source id"),
                                   ("dest", request["dest"], "dest id")):
            g = r * 3 + (0 if kind == "source" else 1)
            group_cls[g] = int(request[cls_key])
            for i, prompt in enumerate(request["prompts"]):
                cache = None
                if not is_edited and img_cache_dir is not None:
                    cache = img_cache_dir / name_tmp.format(
                        who, edit_str, indices[i]
                    )
                jobs.append(_Job(prompt.format(who), int(seeds[i]), cache, g))
    images = _run_jobs(components, jobs, gen_kwargs, batch_size, timings)

    # third group: source images scored under dest id (no extra generation)
    extra_jobs, extra_images = [], []
    for r, request in enumerate(requests):
        g = r * 3 + 2
        group_cls[g] = int(request["dest id"])
        for i, job in enumerate(jobs):
            if job.group == r * 3:
                extra_jobs.append(_Job(job.prompt, job.seed, None, g))
                extra_images.append(images[i])
    scores = _score_groups(scorer, images + extra_images, jobs + extra_jobs,
                           group_cls, timings=timings)
    n = len(requests)
    return {
        "source_scores": [scores[r * 3] for r in range(n)],
        "dest_scores": [scores[r * 3 + 1] for r in range(n)],
        "source_dest_scores": [scores[r * 3 + 2] for r in range(n)],
    }


def measure_scores(components, scorer, requests, is_edited, dataset_name,
                   is_val=False, gen_kwargs=None, cache_dir=None,
                   batch_size: int = 16, timings=None):
    img_cache_dir = Path(cache_dir or CACHE_DIR) / "images" / dataset_name
    result = generate_cal_cls_score(
        components, scorer, requests, is_edited,
        img_cache_dir=img_cache_dir, is_val=is_val, gen_kwargs=gen_kwargs,
        batch_size=batch_size, timings=timings,
    )
    mean = lambda xs: float(np.mean(xs)) if len(xs) else None
    return (mean(result["source_scores"]), mean(result["dest_scores"]),
            mean(result["source_dest_scores"]))


def _test_batches(test_file, batch_size=3) -> List[Dict]:
    """Per-class specificity batches from a {dataset}_test.json
    (reference emcid_test.py:1282-1313)."""
    import json

    with open(test_file) as f:
        items = json.load(f)
    batches = []
    cur: List[Dict] = []
    for item in items:
        if cur and item["class id"] != cur[-1]["class id"]:
            batches.append(cur)
            cur = []
        cur.append(item)
    if cur:
        batches.append(cur)
    return [
        {
            "prompts": [i["text prompt"] for i in grp][:batch_size],
            "random seed": grp[-1]["random seed"],
            "class id": grp[0]["class id"],
            "class name": grp[0]["class name"],
            "indices": [i["idx"] for i in grp][:batch_size],
        }
        for grp in batches
    ]


def measure_specificity(components, scorer, is_edited, dataset_name,
                        data_dir=None, cache_dir=None, batch_size: int = 3,
                        gen_kwargs=None, gen_batch: int = 16,
                        max_classes: Optional[int] = None,
                        timings=None) -> float:
    """Mean ViT P(true class) on held-out (non-edited) classes
    (reference emcid_test.py:1315-1356)."""
    from emcid_torch.globals_cfg import DATA_DIR

    test_file = Path(data_dir or DATA_DIR) / "iceb_data" / f"{dataset_name}_test.json"
    img_cache_dir = Path(cache_dir or CACHE_DIR) / "images" / dataset_name
    batches = _test_batches(test_file, batch_size)
    if max_classes:
        batches = batches[:max_classes]
    jobs: List[_Job] = []
    group_cls: Dict[int, int] = {}
    for g, batch in enumerate(batches):
        group_cls[g] = int(batch["class id"])
        for i, prompt in enumerate(batch["prompts"]):
            cache = None
            if not is_edited:
                cache = img_cache_dir / f"{batch['class name']}_{batch['indices'][i]}.png"
            # per-image seeds derived from the batch seed (torch's one
            # generator for the whole batch cannot be replicated; this is the
            # documented RNG divergence)
            jobs.append(_Job(prompt, int(batch["random seed"]) + i, cache, g))
    images = _run_jobs(components, jobs, gen_kwargs or {}, gen_batch, timings)
    scores = _score_groups(scorer, images, jobs, group_cls, timings=timings)
    return float(np.mean(list(scores.values())))


def eval_pipe_imgnet(components, scorer, requests, alias_val_requests,
                     num_edit, is_edited, dataset_name="imgnet_aug",
                     data_dir=None, cache_dir=None, gen_kwargs=None,
                     val_requests=None, specificity_classes=None,
                     batch_size: int = 16, timings=None) -> Dict[str, float]:
    """The 10-field metric bundle (reference emcid_test.py:991-1079)."""
    p = "post" if is_edited else "pre"
    src, dst, sd = measure_scores(
        components, scorer, requests, is_edited, dataset_name,
        gen_kwargs=gen_kwargs, cache_dir=cache_dir, batch_size=batch_size,
        timings=timings,
    )
    spec = measure_specificity(
        components, scorer, is_edited, dataset_name, data_dir=data_dir,
        cache_dir=cache_dir, gen_kwargs=gen_kwargs, gen_batch=batch_size,
        max_classes=specificity_classes, timings=timings,
    )
    if val_requests is None:
        from emcid_torch.dsets import RequestDataset

        val_requests = RequestDataset(
            data_dir=data_dir, type="val", file_name=dataset_name + "_edit.json"
        )[:num_edit]
    gsrc, gdst, gsd = measure_scores(
        components, scorer, val_requests, is_edited, dataset_name,
        is_val=True, gen_kwargs=gen_kwargs, cache_dir=cache_dir,
        batch_size=batch_size, timings=timings,
    )
    asrc, adst, asd = measure_scores(
        components, scorer, alias_val_requests, is_edited, dataset_name,
        is_val=not is_edited, gen_kwargs=gen_kwargs, cache_dir=cache_dir,
        batch_size=batch_size, timings=timings,
    ) if alias_val_requests else (None, None, None)
    return {
        f"{p}_source_cls_score_edit": src,
        f"{p}_dest_cls_score_edit": dst,
        f"{p}_source_dest_cls_score_edit": sd,
        f"{p}_cls_score_specificity": spec,
        f"{p}_source_cls_score_general": gsrc,
        f"{p}_dest_cls_score_general": gdst,
        f"{p}_source_dest_cls_score_general": gsd,
        f"{p}_source_cls_score_alias": asrc,
        f"{p}_dest_cls_score_alias": adst,
        f"{p}_source_dest_cls_score_alias": asd,
    }


def emcid_test_text_encoder_imgnet(
    components: SDComponents,
    scorer: ViTScorer,
    hparams,
    hparam_name: str,
    num_edit: int = 10,
    mom2_weight=None,
    edit_weight=None,
    dataset_name: str = "imgnet_aug",
    data_dir=None,
    cache_dir=None,
    results_dir=None,
    gen_kwargs: Optional[dict] = None,
    specificity_classes: Optional[int] = None,
    batch_size: int = 16,
    apply_kwargs: Optional[dict] = None,
    timings: Optional[Dict[str, float]] = None,
) -> Dict[str, float]:
    """AICE end-to-end (reference emcid_test.py:1082-1216): idempotence
    check → requests → pre eval → timed edit → post eval → summary write."""
    from emcid_torch.dsets import RequestDataset, compose_alias_test_requests
    from emcid_torch.engine.editor import apply_emcid

    mom2_weight = mom2_weight if mom2_weight is not None else hparams.mom2_update_weight
    edit_weight = edit_weight if edit_weight is not None else hparams.edit_weight
    spath = summary_path(hparam_name, dataset_name, results_dir)
    key = summary_key(num_edit, mom2_weight, edit_weight)
    existing = lookup_summary(spath, key)
    if existing is not None:
        print(f"{key} already in {spath}, returning")
        return existing

    requests = RequestDataset(
        data_dir=data_dir, type="edit", file_name=dataset_name + "_edit.json"
    )[:num_edit]
    val_requests = RequestDataset(
        data_dir=data_dir, type="val", file_name=dataset_name + "_edit.json"
    )[:num_edit]
    alias_val_requests = compose_alias_test_requests(val_requests,
                                                     data_dir=data_dir)

    record: Dict[str, float] = {}
    t0 = time.time()
    record.update(eval_pipe_imgnet(
        components, scorer, requests, alias_val_requests, num_edit,
        is_edited=False, dataset_name=dataset_name, data_dir=data_dir,
        cache_dir=cache_dir, gen_kwargs=gen_kwargs,
        val_requests=val_requests, specificity_classes=specificity_classes,
        batch_size=batch_size, timings=timings,
    ))
    _add(timings, "pre_edit_eval", time.time() - t0)

    # shuffled edit order (reference emcid_test.py:1165-1170)
    order = list(range(len(requests)))
    random.shuffle(order)
    shuffled = [requests[i] for i in order]

    cache_name = f"{cache_dir or CACHE_DIR}/{hparam_name}/{dataset_name}/"
    t0 = time.time()
    edited, _ = apply_emcid(
        components, shuffled, hparams,
        mom2_weight=mom2_weight, edit_weight=edit_weight,
        cache_name=cache_name, **(apply_kwargs or {}),
    )
    _sync(edited)
    edit_time = time.time() - t0
    print(f"apply_emcid took {edit_time:.1f} s for {num_edit} edits")
    record["edit_time_s"] = edit_time
    _add(timings, "edit", edit_time)

    t0 = time.time()
    record.update(eval_pipe_imgnet(
        edited, scorer, requests, alias_val_requests, num_edit,
        is_edited=True, dataset_name=dataset_name, data_dir=data_dir,
        cache_dir=cache_dir, gen_kwargs=gen_kwargs,
        val_requests=val_requests, specificity_classes=specificity_classes,
        batch_size=batch_size, timings=timings,
    ))
    _add(timings, "post_edit_eval", time.time() - t0)
    update_summary(spath, key, record)
    return record
