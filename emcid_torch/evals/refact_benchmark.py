"""RoAD / TIMED single-concept benchmark harness
(reference scripts/refact_benchmark_eval.py).

Protocol parity: per request, edit → generate (source prompt + 5 positive +
5 negative prompts, per global seed) → restore; scores from CLIP
image-text softmax over [old, new]: efficacy = P(new)>P(old) on source
images; generality over positives (+ thresholds @0.75/@0.9); specificity =
P(new)<P(old) on negatives; F1 = 2GS/(G+S).  Image layout
(``results/images/{ds}/{hparam}_w{W}/emcid/source_{s}_dest_{n}/{prompt}/
seed_{seed}.png``), result JSON (``{ds}_results_{emcid|oracle}.json`` keyed
``weight{W}[_ew{E}]`` with the 11 metric fields) and the per-concept CSV all
match the reference.

Counterpart of ``emcid_tpu/evals/refact_benchmark.py``.  All 11 prompts
of a request generate in one batched ``generate`` call (the reference runs
5 pipe() calls of <= 3 images, refact_benchmark_eval.py:209-269).  Restore
is free: every edit returns a copy of the text encoder, so the shared
components are never written.  An image's seed is ``global_seed * 1000003
+ crc32(prompt) % 997``: the JAX package takes Python's ``hash(prompt)``,
which changes with every process (``PYTHONHASHSEED``), so its seeds do not
repeat across runs; CRC-32 makes them repeat.  Scoring uses the
``CLIPScorer`` (any CLIP does for the softmax protocol).
"""

from __future__ import annotations

import csv
import json
import zlib
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from emcid_torch.models.pipeline import SDComponents, generate
from emcid_torch.models.vision import CLIPScorer
from emcid_torch.parallel.distributed import shared_writes


def _eval_output_path(dataset, hparam_name, mom2_weight, edit_weight, row,
                      oracle, results_dir="results"):
    path_key = "old" if "timed" in dataset else "prompt"
    source, new = row[path_key], row["new"]
    if oracle:
        return Path(results_dir) / "images" / dataset / "oracle" / (
            f"source_{source}_dest_{new}")
    ew = "" if float(edit_weight) == 0.5 else f"_ew{edit_weight}"
    return Path(results_dir) / "images" / dataset / (
        f"{hparam_name}_w{int(mom2_weight)}{ew}") / "emcid" / (
        f"source_{source}_dest_{new}")


def _request_eval_prompts(row, dataset, oracle) -> List[str]:
    path_key = "old" if "timed" in dataset else "prompt"
    pos_new_key = "gt" if "timed" in dataset else "positive_new"
    if oracle:
        prompts = [row["new"]]
        prompts += [row[f"{pos_new_key}{i}"] for i in range(1, 6)]
    else:
        prompts = [row[path_key]]
        prompts += [row[f"positive{i}"] for i in range(1, 6)]
    prompts += [row[f"negative{i}"] for i in range(1, 6)]
    return prompts


def eval_seed(global_seed: int, prompt: str) -> int:
    """The seed of one eval image, the same in every process."""
    return global_seed * 1000003 + zlib.crc32(prompt.encode()) % 997


def generate_imgs_for_eval_single(
    components: SDComponents,
    row: Dict[str, str],
    dataset: str,
    hparam_name: str,
    mom2_weight,
    edit_weight,
    global_seed: int,
    oracle: bool = False,
    results_dir: str = "results",
    gen_kwargs: Optional[dict] = None,
) -> Path:
    """Generate all 11 eval images for one request/seed in one batch, with
    the reference's file layout and exists-skip."""
    from PIL import Image

    out = _eval_output_path(dataset, hparam_name, mom2_weight, edit_weight,
                            row, oracle, results_dir)
    prompts = _request_eval_prompts(row, dataset, oracle)
    paths = [out / p / f"seed_{global_seed}.png" for p in prompts]
    todo = [(p, pa) for p, pa in zip(prompts, paths) if not pa.exists()]
    with shared_writes() as write:
        if todo:
            # per-image seeds from (global_seed, prompt); the reference's
            # single sequential torch RNG cannot be replicated
            seeds = [eval_seed(global_seed, p) for p, _ in todo]
            imgs = generate(components, [p for p, _ in todo], seeds,
                            **(gen_kwargs or {}))
            if write:
                for (p, pa), img in zip(todo, imgs):
                    pa.parent.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(img).save(pa)
    return out


def emcid_test(
    components: SDComponents,
    requests: Sequence[Dict],
    hparams,
    hparam_name: str,
    dataset: str,
    mom2_weight=None,
    edit_weight=None,
    seed_num: int = 1,
    oracle: bool = False,
    results_dir: str = "results",
    gen_kwargs: Optional[dict] = None,
    apply_kwargs: Optional[dict] = None,
    cache_name: Optional[str] = None,
    method: str = "emcid",
    verbose: bool = True,
):
    """Per-request edit → generate → restore loop
    (reference refact_benchmark_eval.py:36-168).

    ``method="contrast"`` routes through the CLIP joint edit loop
    (execute_emcid_clip: contrastive compute_z_refact targets + the same
    fused insert — reference emcid_main.py:109-311) instead of the
    diffusion-supervised Stage-1.  Each edit returns edited copies, so
    ``components`` stay as they were (the restore)."""
    from emcid_torch.engine.editor import apply_emcid

    mom2_weight = mom2_weight if mom2_weight is not None else hparams.mom2_update_weight
    edit_weight = edit_weight if edit_weight is not None else hparams.edit_weight
    for seed in range(seed_num):
        for request in requests:
            row = request["row"]
            if oracle:
                pipe = components  # generate from gt prompts, no edit
            elif method == "contrast":
                from emcid_torch.engine.clip_edit import execute_emcid_clip

                _, new_text = execute_emcid_clip(
                    components.text_encoder, components.tokenizer,
                    [request], hparams,
                    cache_name=cache_name, mom2_weight=mom2_weight,
                    edit_weight=edit_weight,
                    stats_dir=(apply_kwargs or {}).get("stats_dir"),
                    verbose=verbose,
                )
                pipe = components.replace_text_encoder(new_text)
            else:
                pipe, _ = apply_emcid(
                    components, [request], hparams,
                    mom2_weight=mom2_weight, edit_weight=edit_weight,
                    cache_name=cache_name, verbose=verbose,
                    **(apply_kwargs or {}),
                )
            generate_imgs_for_eval_single(
                pipe, row, dataset, hparam_name, mom2_weight, edit_weight,
                global_seed=seed, oracle=oracle, results_dir=results_dir,
                gen_kwargs=gen_kwargs,
            )
            # restore: `components` is unchanged; `pipe` goes out of scope


def _scores(scorer: CLIPScorer, image_path, old: str, new: str) -> np.ndarray:
    from PIL import Image

    img = np.asarray(Image.open(image_path).convert("RGB"))
    logits = scorer.logits_per_image(img[None], [old, new])[0].cpu().numpy()
    e = np.exp(logits.astype(np.float64) - np.max(logits))
    return e / e.sum()


def eval_all(
    scorer: CLIPScorer,
    requests: Sequence[Dict],
    dataset: str,
    hparam_name: str,
    mom2_weight,
    edit_weight=0.5,
    num_seeds: int = 1,
    oracle: bool = False,
    results_dir: str = "results",
) -> float:
    """Score generated images → summary JSON + per-concept CSV
    (reference refact_benchmark_eval.py:343-597).  Returns F1."""
    pos_old_key = "positive" if "timed" in dataset else "positive_old"
    pos_new_key = "gt" if "timed" in dataset else "positive_new"
    neg_new_key = "gn" if "timed" in dataset else "negative_new"
    path_key = "old" if "timed" in dataset else "prompt"

    all_eff, all_gen, all_g75, all_g90, all_spec = [], [], [], [], []
    all_old, all_new = [], []
    missing: List[str] = []
    for request in requests:
        row = request["row"]
        out = _eval_output_path(dataset, hparam_name, mom2_weight,
                                edit_weight, row, oracle, results_dir)
        eff, gen, g75, g90, spec = [], [], [], [], []
        for seed in range(num_seeds):
            def score(prompt, old, new):
                p = out / prompt / f"seed_{seed}.png"
                if not p.exists():
                    missing.append(str(p))
                    return None
                return _scores(scorer, p, old, new)

            s = score(row["new"] if oracle else row[path_key],
                      row["old"] if "timed" in dataset else row[path_key],
                      row["new"])
            if s is not None:
                eff.append(int(s[1] > s[0]))
            cg = c75 = c90 = 0
            for i in range(1, 6):
                prompt = row[f"{pos_new_key}{i}"] if oracle else row[f"positive{i}"]
                s = score(prompt, row[f"{pos_old_key}{i}"], row[f"{pos_new_key}{i}"])
                if s is None:
                    continue
                cg += int(s[1] > s[0])
                c75 += int(s[1] > 0.75)
                c90 += int(s[1] > 0.9)
            gen.append(cg / 5)
            g75.append(c75 / 5)
            g90.append(c90 / 5)
            cs = 0
            for i in range(1, 6):
                s = score(row[f"negative{i}"], row[f"negative{i}"],
                          row[f"{neg_new_key}{i}"])
                if s is not None:
                    cs += int(s[1] < s[0])
            spec.append(cs / 5)
        all_eff.append(eff)
        all_gen.append(gen)
        all_g75.append(g75)
        all_g90.append(g90)
        all_spec.append(spec)
        all_old.append(row["old"])
        all_new.append(row["new"])
    if missing:
        raise FileNotFoundError(f"Missing eval images: {missing[:5]}...")

    arr = lambda x: np.array(x, dtype=np.float64)
    all_eff, all_gen = arr(all_eff), arr(all_gen)
    all_g75, all_g90, all_spec = arr(all_g75), arr(all_g90), arr(all_spec)

    key = f"weight{mom2_weight}" + (
        f"_ew{edit_weight}" if float(edit_weight) != 0.5 else "")
    record = {
        "efficacy": float(all_eff.mean()),
        "efficacy_std": float(all_eff.mean(axis=0).std()),
        "generality": float(all_gen.mean()),
        "generality_std": float(all_gen.mean(axis=0).std()),
        "generality_90": float(all_g90.mean()),
        "generality_90_std": float(all_g90.mean(axis=0).std()),
        "generality_75": float(all_g75.mean()),
        "generality_75_std": float(all_g75.mean(axis=0).std()),
        "specificity": float(all_spec.mean()),
        "specificity_std": float(all_spec.mean(axis=0).std()),
    }
    denom = record["generality"] + record["specificity"]
    record["f1_score"] = (
        2 * record["generality"] * record["specificity"] / denom
        if denom > 0 else 0.0
    )

    suffix = "oracle" if oracle else "emcid"
    rdir = Path(results_dir) / "emcid" / hparam_name
    rdir.mkdir(parents=True, exist_ok=True)
    jpath = rdir / f"{dataset}_results_{suffix}.json"
    results = {}
    if jpath.exists():
        with open(jpath) as f:
            results = json.load(f) or {}
    results[key] = record
    with shared_writes() as write:
        if write:
            with open(jpath, "w") as f:
                json.dump(results, f, indent=4)
            with open(rdir / f"{dataset}_results_{suffix}.csv", "w",
                      newline="") as f:
                w = csv.writer(f)
                w.writerow(["old", "new", "efficacy", "generality",
                            "generality90", "generality75", "specificity"])
                for i in range(len(all_old)):
                    w.writerow([
                        all_old[i], all_new[i], all_eff[i].mean(),
                        all_gen[i].mean(), all_g90[i].mean(),
                        all_g75[i].mean(), all_spec[i].mean(),
                    ])
    return record["f1_score"]
