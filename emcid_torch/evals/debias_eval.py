"""Debias evaluation (reference scripts/eval_debias.py:235-367):
generate images per profession over validation prompts × seeds, CLIP-argmax
each as female/male, report delta = |P(female) − 0.5| / 0.5 per profession
and the mean±std "total" row as CSV.  Counterpart of
``emcid_tpu/evals/debias_eval.py``."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from emcid_torch.evals.debias_shared import ratio_delta
from emcid_torch.models.pipeline import SDComponents, generate
from emcid_torch.models.vision import CLIPScorer
from emcid_torch.parallel.distributed import shared_writes


def generate_debias_eval_imgs(
    components: SDComponents,
    prompts: Sequence[str],
    out_dir,
    imgs_per_prompt: int = 12,
    num_seeds: int = 10,
    gen_kwargs: Optional[dict] = None,
    batch_size: int = 24,
):
    """Seeded generation grid (reference eval_debias.py:235-272): images land
    at ``{out_dir}/{prompt}/seed{seed}_img{i}.png`` with exists-skip."""
    from PIL import Image

    out_dir = Path(out_dir)
    jobs = []
    for prompt in prompts:
        for seed in range(num_seeds):
            for i in range(imgs_per_prompt):
                p = out_dir / prompt / f"seed{seed}_img{i}.png"
                if not p.exists():
                    jobs.append((prompt, seed * 1000 + i, p))
    with shared_writes() as write:
        for start in range(0, len(jobs), batch_size):
            chunk = jobs[start:start + batch_size]
            imgs = generate(components, [j[0] for j in chunk],
                            [j[1] for j in chunk], **(gen_kwargs or {}))
            if write:
                for (prompt, _, path), img in zip(chunk, imgs):
                    path.parent.mkdir(parents=True, exist_ok=True)
                    Image.fromarray(img).save(path)


def eval_ratios(
    scorer: CLIPScorer,
    professions: Sequence[Dict],
    img_root,
    out_csv,
    num_seeds: int = 10,
    imgs_per_prompt: int = 12,
) -> Dict[str, float]:
    """Per-profession delta = |P(female) − 0.5| / 0.5 from generated images
    (reference eval_debias.py:275-367).  ``professions`` rows need
    {source, dests: [female_text, male_text], val_prompts}.  Writes the CSV
    with a final 'total' mean±std row; returns {profession: delta}."""
    from PIL import Image

    img_root = Path(img_root)
    deltas: Dict[str, float] = {}
    per_prof_std: Dict[str, float] = {}
    for row in professions:
        dests = row["dests"]
        seed_deltas = []
        for seed in range(num_seeds):
            female = male = 0
            for prompt in row["val_prompts"]:
                imgs = []
                for i in range(imgs_per_prompt):
                    p = img_root / prompt / f"seed{seed}_img{i}.png"
                    if p.exists():
                        imgs.append(np.asarray(Image.open(p).convert("RGB")))
                if not imgs:
                    continue
                logits = torch.as_tensor(scorer.logits_per_image(
                    np.stack(imgs), list(dests))).cpu().numpy()
                winners = logits.argmax(-1)
                female += int((winners == 0).sum())
                male += int((winners == 1).sum())
            total = female + male
            if total:
                seed_deltas.append(ratio_delta(female / total))
        deltas[row["source"]] = float(np.mean(seed_deltas)) if seed_deltas else float("nan")
        per_prof_std[row["source"]] = float(np.std(seed_deltas)) if seed_deltas else float("nan")

    out_csv = Path(out_csv)
    out_csv.parent.mkdir(parents=True, exist_ok=True)
    with open(out_csv, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["profession", "delta_mean", "delta_std"])
        for name, d in deltas.items():
            w.writerow([name, d, per_prof_std[name]])
        vals = [v for v in deltas.values() if np.isfinite(v)]
        w.writerow(["total", float(np.mean(vals)) if vals else float("nan"),
                    float(np.std(vals)) if vals else float("nan")])
    return deltas
