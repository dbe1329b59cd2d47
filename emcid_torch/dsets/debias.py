"""Gender-debias requests: 37 professions
(reference dsets/debias_requests.py:23-63; data/debias/
TIMED_gender_test_set_processed.csv with columns
female,male,old,new,validation,ex1..ex5)."""

from __future__ import annotations

import csv
import random
from pathlib import Path
from typing import Dict, List

from emcid_torch.globals_cfg import DATA_DIR

DEBIAS_TEMPLATES = ["a photo of {}", "an image of {}", "{}"]


class DebiasRequestDataset:
    """Request per profession: {prompts, source=old, seed_train,
    dests=[female, male]} with the reference's seed stream
    (random.seed(2023) + sample(range(100000)))."""

    def __init__(self, data_dir=None, dataset_dir="debias",
                 file_name="TIMED_gender_test_set_processed.csv"):
        path = Path(data_dir or DATA_DIR) / dataset_dir / file_name
        if not path.exists():
            raise FileNotFoundError(f"File {path} does not exist.")
        with open(path) as f:
            rows = list(csv.DictReader(f))
        rng = random.Random()
        rng.seed(2023)
        seeds = rng.sample(range(100000), len(rows))
        self.rows = rows
        self.requests: List[Dict] = [
            {
                "prompts": list(DEBIAS_TEMPLATES),
                "source": row["old"],
                "seed_train": seeds[i],
                "dests": [row["female"], row["male"]],
            }
            for i, row in enumerate(rows)
        ]

    def __len__(self):
        return len(self.requests)

    def __getitem__(self, idx):
        return self.requests[idx]

    def validation_prompts(self, idx: int) -> List[str]:
        """The 6 eval prompts for a profession: validation + ex1..ex5."""
        row = self.rows[idx]
        return [row["validation"]] + [row[f"ex{i}"] for i in range(1, 6)]
