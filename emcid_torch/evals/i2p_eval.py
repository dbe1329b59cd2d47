"""I2P nudity evaluation (reference scripts/eval_i2p_nudity.py):
seeded generation of the 4,703 unsafe prompts, NudeNet detection via an
external process (the same subprocess seam the reference uses — NudeNet is
an external CPU model), and the exposed-label count summary.

Counterpart of ``emcid_tpu/evals/i2p_eval.py``: the same file layout, CSV
schema and summary keys."""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

from emcid_torch.evals.scorers import NUDENET_EXPOSED_LABELS, cal_nudity_rate
from emcid_torch.models.pipeline import SDComponents, generate
from emcid_torch.parallel.distributed import is_writer, shared_writes


def generate_i2p_imgs(
    components: SDComponents,
    rows: Sequence[Dict],
    out_dir,
    gen_kwargs: Optional[dict] = None,
    batch_size: int = 16,
):
    """One image per I2P row at ``{out_dir}/{case_number}.png``, seeded with
    ``evaluation_seed`` (+ the row's guidance), exists-skip
    (reference eval_i2p_nudity.py:42-77)."""
    from PIL import Image

    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [r for r in rows
            if not (out_dir / f"{r['case_number']}.png").exists()]
    # group by guidance so each batch is one compiled call
    by_g: Dict[float, List[Dict]] = {}
    for r in todo:
        by_g.setdefault(float(r.get("evaluation_guidance", 7.0)), []).append(r)
    with shared_writes() as write:
        for g, group in by_g.items():
            for i in range(0, len(group), batch_size):
                chunk = group[i:i + batch_size]
                kw = dict(gen_kwargs or {})
                kw["guidance_scale"] = g
                imgs = generate(
                    components, [r["prompt"] for r in chunk],
                    [r["evaluation_seed"] for r in chunk], **kw,
                )
                if write:
                    for r, img in zip(chunk, imgs):
                        Image.fromarray(img).save(
                            out_dir / f"{r['case_number']}.png")


def detect_nude_classes(img_dir, out_csv, detector_cmd: Optional[str] = None
                        ) -> List[List[str]]:
    """NudeNet detection seam.

    Cmd contract (exercised offline by ``scripts/fake_nudenet.py`` +
    tests/test_torch_preservation.py): the detector is invoked as

        {detector_cmd} {img_dir} {out_csv}

    (subprocess boundary, reference emcid_test.py:419-422) and must write a
    CSV in the reference detectNudeClasses schema
    (eval_i2p_nudity.py:23-39): one row per image with a ``case_number``
    column and a ``NudeNet_label`` column holding the '-'-joined class
    labels above threshold (empty/missing for clean images).  The real
    NudeNet wrapper is a ~15-line script in that schema; this build ships
    only the fake (no bundled detector weights offline).

    Without ``detector_cmd``, loads an existing CSV in that schema; a CSV
    without a ``NudeNet_label`` column raises ``ValueError``.
    """
    out_csv = Path(out_csv)
    if detector_cmd:
        import subprocess

        subprocess.run(
            detector_cmd.split() + [str(img_dir), str(out_csv)], check=True
        )
    if not out_csv.exists():
        raise FileNotFoundError(
            f"{out_csv} missing — run NudeNet externally (no bundled detector "
            "in this offline build) and point detect_nude_classes at its CSV"
        )
    detections = []
    with open(out_csv) as f:
        reader = csv.DictReader(f)
        if "NudeNet_label" not in (reader.fieldnames or ()):
            raise ValueError(f"{out_csv} has no NudeNet_label column")
        for row in reader:
            raw = row["NudeNet_label"] or ""
            detections.append(
                [l for l in raw.split("-") if l and l != "0.0"])
    return detections


def i2p_nudity_summary(detections: Sequence[Sequence[str]], out_json=None
                       ) -> Dict[str, int]:
    """Returns the full count dict (incl. the in-memory extras
    ``total_nude_images``/``total_images``); the ``out_json`` artifact is
    written with ONLY the reference i2p_nudity_cnt.json key set — the 10
    exposed labels + ``total`` (eval_i2p_nudity.py:114-119) — per the
    byte-compatible-summary invariant."""
    counts = cal_nudity_rate(detections)
    if out_json is not None and is_writer():
        Path(out_json).parent.mkdir(parents=True, exist_ok=True)
        artifact = {k: counts[k] for k in (*NUDENET_EXPOSED_LABELS, "total")}
        with open(out_json, "w") as f:
            json.dump(artifact, f, indent=4)
    return counts
