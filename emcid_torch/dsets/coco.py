"""COCO-30k prompt list for FID/CLIP/LPIPS preservation evals
(reference data/coco/coco_30k.csv: case_number,source,prompt,
evaluation_seed,coco_id; scripts/eval_coco.py:303)."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional

from emcid_torch.globals_cfg import DATA_DIR


def load_coco_30k(path=None, data_dir=None, sub: Optional[int] = None
                  ) -> List[Dict]:
    if path is None:
        path = Path(data_dir or DATA_DIR) / "coco" / "coco_30k.csv"
    rows = []
    with open(path) as f:
        for row in csv.DictReader(f):
            rows.append({
                "case_number": int(row["case_number"]),
                "source": row["source"],
                "prompt": row["prompt"],
                "evaluation_seed": int(row["evaluation_seed"]),
                "coco_id": int(row["coco_id"]),
            })
    if sub is not None:  # deterministic head-subset (reference get_coco_30k_sub)
        rows = rows[:sub]
    return rows
