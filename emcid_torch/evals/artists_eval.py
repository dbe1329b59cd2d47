"""Artist-erasure evaluation (reference scripts/eval_artists.py +
emcid_test.py:578-748): generate erased/holdout artist prompts pre and post
edit, compare with LPIPS (higher on erased = stronger erasure) and CLIP
prompt alignment (lower on erased = erased; stable on holdout = preserved).

Counterpart of ``emcid_tpu/evals/artists_eval.py``: the same file layout
and result fields."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from emcid_torch.models.lpips import LPIPSScorer
from emcid_torch.models.pipeline import SDComponents, generate
from emcid_torch.models.vision import CLIPScorer
from emcid_torch.parallel.distributed import is_writer, shared_writes


def generate_artist_images(
    components: SDComponents,
    prompt_rows: Sequence[Dict],
    out_dir,
    gen_kwargs: Optional[dict] = None,
    batch_size: int = 16,
):
    """One image per eval CSV row at ``{out_dir}/{case_number}_{seed}.png``
    with exists-skip (rows from dsets.load_artist_eval_prompts)."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [
        r for r in prompt_rows
        if not (out_dir / f"{r['case_number']}_{r['evaluation_seed']}.png").exists()
    ]
    with shared_writes() as write:
        for i in range(0, len(todo), batch_size):
            chunk = todo[i:i + batch_size]
            imgs = generate(
                components, [r["prompt"] for r in chunk],
                [r["evaluation_seed"] for r in chunk], **(gen_kwargs or {}),
            )
            if write:
                for r, img in zip(chunk, imgs):
                    name = f"{r['case_number']}_{r['evaluation_seed']}.png"
                    Image.fromarray(img).save(out_dir / name)


def eval_artists(
    prompt_rows: Sequence[Dict],
    pre_dir,
    post_dir,
    lpips: Optional[LPIPSScorer] = None,
    clip: Optional[CLIPScorer] = None,
    out_json=None,
) -> Dict[str, Dict[str, float]]:
    """LPIPS(pre, post) and CLIP(post, prompt) split by erased/holdout
    (reference eval_artists.py:21-312)."""
    from PIL import Image

    pre_dir, post_dir = Path(pre_dir), Path(post_dir)
    buckets: Dict[str, Dict[str, List[float]]] = {
        "erased": {"lpips": [], "clip": []},
        "holdout": {"lpips": [], "clip": []},
    }
    for r in prompt_rows:
        name = f"{r['case_number']}_{r['evaluation_seed']}.png"
        pa, pb = pre_dir / name, post_dir / name
        if not (pa.exists() and pb.exists()):
            continue
        a = np.asarray(Image.open(pa).convert("RGB"))
        b = np.asarray(Image.open(pb).convert("RGB"))
        kind = r["type"]
        if lpips is not None:
            buckets[kind]["lpips"].append(float(lpips.distance(a, b)[0]))
        if clip is not None:
            buckets[kind]["clip"].append(
                float(clip.clip_score(b[None], [r["prompt"]])[0])
            )
    result = {
        kind: {
            metric: (float(np.mean(vals)) if vals else None)
            for metric, vals in metrics.items()
        } | {
            f"{metric}_std": (float(np.std(vals)) if vals else None)
            for metric, vals in metrics.items()
        } | {"n": len(metrics["lpips"]) or len(metrics["clip"])}
        for kind, metrics in buckets.items()
    }
    if out_json is not None and is_writer():
        Path(out_json).parent.mkdir(parents=True, exist_ok=True)
        with open(out_json, "w") as f:
            json.dump(result, f, indent=4)
    return result
