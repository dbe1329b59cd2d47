"""TIMED / RoAD single-concept benchmark requests
(reference dsets/timed_road_dataset.py:25-128).

CSV schemas:
* TIMED (``data/timed/TIMED_test_set_filtered_SD14.csv``):
  old,new,positive1,gt1,...,positive5,gt5,negative1,gn1,...,negative5,gn5
* RoAD (``data/road/RoAD_test.csv``):
  Type,Prompt,Oracle,Old,New,Positive{i},Positive_oracle{i},Positive_old{i},
  Positive_new{i} (i=1..5), Negative{i},Negative_new{i}

All keys and values are lowercased on load, matching the reference.
"""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List, Optional

from emcid_torch.globals_cfg import DATA_DIR

CONTEXT_TEMPLATE = [
    "{} in a realistic style portrait image",
    "{}, a portrait",
    "realistic painting of {}",
    "a current image of {}",
    "{}, news image",
    "a beautiful photograph of {}",
    "realistic drawing of {}",
    "{}, realistic portrait",
    "{} in a photo",
]

BASIC_TEMPLATES = ["An image of {}", "A photo of {}", "{}"]


class TIMEDRoadRequestDataset:
    """dataset ∈ {"timed", "road", "timed-val", "road-val"}.  Request:
    {prompts, source (= old / prompt), seed=None (global-seed protocol),
    indices, dest (= new), negative_prompts, negative_images}; the full
    lowercased row rides along as ``row`` for the eval harness
    (positive/negative prompt columns)."""

    def __init__(
        self,
        dataset: str,
        data_dir=None,
        data_path=None,
        use_more_tmp: bool = False,
        num_negative_images: Optional[int] = None,
        num_negative_prompts: Optional[int] = None,
        ccs_sub_file=None,
    ):
        self.dataset = dataset
        base = Path(data_dir or DATA_DIR)
        if data_path is None:
            files = {
                "timed": base / "timed" / "TIMED_test_set_filtered_SD14.csv",
                "road": base / "road" / "RoAD_test.csv",
                "timed-val": base / "timed" / "TIMED_validation_set.csv",
                "road-val": base / "road" / "RoAD_validation.csv",
            }
            if dataset not in files:
                raise ValueError(f"Invalid dataset {dataset!r}")
            data_path = files[dataset]

        with open(data_path) as f:
            rows = [
                {k.lower(): v.lower() for k, v in row.items()}
                for row in csv.DictReader(f)
            ]

        templates = (
            ["{}"] + CONTEXT_TEMPLATE if use_more_tmp else list(BASIC_TEMPLATES)
        )
        prompt_key = "old" if "timed" in dataset else "prompt"

        negative_prompts: Optional[List[str]] = None
        negative_images = None
        if num_negative_prompts or num_negative_images:
            import json

            sub = ccs_sub_file or str(base / "ccs_filtered_sub.json")
            with open(sub) as f:
                ccs = json.load(f)
            n = max(num_negative_prompts or 0, num_negative_images or 0)
            negative_prompts = [item["caption"] for item in ccs[:n]]
            if num_negative_images:
                from PIL import Image

                negative_images = [
                    Image.open(item["path"]).convert("RGB")
                    for item in ccs[:n]
                ]

        self.requests: List[Dict] = []
        for idx, row in enumerate(rows):
            request = {
                "prompts": list(templates),
                "source": row[prompt_key],
                "seed": None,  # ReFACT protocol: global seed
                "indices": [idx] * len(templates),
                "dest": row["new"],
                "negative_prompts": negative_prompts if num_negative_prompts else None,
                "negative_images": negative_images if num_negative_images else None,
                "row": row,
            }
            if row.get("is_human_name", "not_found") != "not_found":
                request["is_human_name"] = row["is_human_name"] == "true"
            self.requests.append(request)

    def __len__(self):
        return len(self.requests)

    def __getitem__(self, idx):
        return self.requests[idx]


def positive_negative_prompts(request: Dict, dataset: str):
    """Eval prompt sets for one request: (source, positives[5], negatives[5],
    gt_positives[5], gt_negatives[5]) from the raw row."""
    row = request["row"]
    if "timed" in dataset:
        pos = [row[f"positive{i}"] for i in range(1, 6)]
        gt = [row[f"gt{i}"] for i in range(1, 6)]
        neg = [row[f"negative{i}"] for i in range(1, 6)]
        gn = [row[f"gn{i}"] for i in range(1, 6)]
    else:
        pos = [row[f"positive{i}"] for i in range(1, 6)]
        gt = [row[f"positive_new{i}"] for i in range(1, 6)]
        neg = [row[f"negative{i}"] for i in range(1, 6)]
        gn = [row[f"negative_new{i}"] for i in range(1, 6)]
    return request["source"], pos, neg, gt, gn
