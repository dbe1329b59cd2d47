"""COCO-30k preservation evals (reference scripts/eval_coco.py):
seeded generation with file-exists skip, LPIPS(alex)@64 vs pre-edit
generations, CLIP score, FID hook — merged into ``coco_summary.json`` under
``edit_{N}_weight{W}[_ew{E}]`` keys (reference eval_coco.py:108, 186-190).

Counterpart of ``emcid_tpu/evals/coco_eval.py``: the same file layout,
summary keys and record fields; FID is ``evals.scorers.fid_between_folders``
over ``models.inception.make_fid_extractor``."""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from emcid_torch.evals.summary import summary_path, update_summary
from emcid_torch.models.lpips import LPIPSScorer
from emcid_torch.models.pipeline import SDComponents, generate
from emcid_torch.models.vision import CLIPScorer
from emcid_torch.parallel.distributed import shared_writes


def coco_summary_key(num_edit, mom2_weight, edit_weight=0.5) -> str:
    key = f"edit_{num_edit}_weight{mom2_weight}"
    if edit_weight is not None and float(edit_weight) != 0.5:
        key += f"_ew{edit_weight}"
    return key


def generate_coco(
    components: SDComponents,
    rows: Sequence[Dict],
    out_dir,
    gen_kwargs: Optional[dict] = None,
    batch_size: int = 16,
):
    """Seeded COCO generation (reference eval_coco.py:40-70): one image per
    row at ``{out_dir}/{case_number}.png``, skipping existing files."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [r for r in rows if not (out_dir / f"{r['case_number']}.png").exists()]
    with shared_writes() as write:
        for i in range(0, len(todo), batch_size):
            chunk = todo[i:i + batch_size]
            imgs = generate(
                components, [r["prompt"] for r in chunk],
                [r["evaluation_seed"] for r in chunk], **(gen_kwargs or {}),
            )
            if write:
                for r, img in zip(chunk, imgs):
                    Image.fromarray(img).save(out_dir / f"{r['case_number']}.png")


def cal_lpips_coco(
    lpips: LPIPSScorer,
    rows: Sequence[Dict],
    edited_dir,
    orig_dir,
    batch_size: int = 32,
) -> Dict[str, float]:
    """LPIPS at 64x64 between edited and pre-edit generations
    (reference eval_coco.py:73-193)."""
    from PIL import Image

    edited_dir, orig_dir = Path(edited_dir), Path(orig_dir)
    dists: List[float] = []
    batch_a, batch_b = [], []

    def flush():
        if batch_a:
            d = lpips.distance(np.stack(batch_a), np.stack(batch_b))
            dists.extend(np.asarray(d).tolist())
            batch_a.clear()
            batch_b.clear()

    for r in rows:
        pa = edited_dir / f"{r['case_number']}.png"
        pb = orig_dir / f"{r['case_number']}.png"
        if not (pa.exists() and pb.exists()):
            continue
        batch_a.append(np.asarray(Image.open(pa).convert("RGB")))
        batch_b.append(np.asarray(Image.open(pb).convert("RGB")))
        if len(batch_a) == batch_size:
            flush()
    flush()
    return {"lpips": float(np.mean(dists)), "lpips_std": float(np.std(dists)),
            "n": len(dists)}


def cal_clip_score_coco(
    scorer: CLIPScorer,
    rows: Sequence[Dict],
    img_dir,
    batch_size: int = 32,
    key_prefix: str = "clip_vit_large",
) -> Dict[str, float]:
    """Mean/std CLIP logits over (image, prompt) pairs
    (reference eval_coco.py:196-301)."""
    from PIL import Image

    img_dir = Path(img_dir)
    scores: List[float] = []
    imgs, texts = [], []

    def flush():
        if imgs:
            ie = scorer.image_embeds(np.stack(imgs))
            te = scorer.text_embeds(texts)
            cos = (ie * te).sum(-1).cpu().numpy()
            scores.extend((scorer.logit_scale * cos).tolist())
            imgs.clear()
            texts.clear()

    for r in rows:
        p = img_dir / f"{r['case_number']}.png"
        if not p.exists():
            continue
        imgs.append(np.asarray(Image.open(p).convert("RGB")))
        texts.append(r["prompt"])
        if len(imgs) == batch_size:
            flush()
    flush()
    return {f"{key_prefix}": float(np.mean(scores)),
            f"{key_prefix}_std": float(np.std(scores)), "n": len(scores)}


def write_coco_summary(hparam_name, num_edit, mom2_weight, record,
                       edit_weight=0.5, results_dir=None):
    """Merge ``record`` into ``coco_summary.json`` under its key;
    returns (the summary, the key)."""
    path = summary_path(hparam_name, "coco", results_dir)
    path = path.with_name("coco_summary.json")
    key = coco_summary_key(num_edit, mom2_weight, edit_weight)
    return update_summary(path, key, record), key
