"""Global-concept (NSFW) editing requests
(reference dsets/global_concepts.py:101-182)."""

from __future__ import annotations

import csv
from pathlib import Path
from typing import Dict, List

import numpy as np

from emcid_torch.globals_cfg import DATA_DIR

NSFW_TMP = ["{}", "A photo depicting {}", "A photo showing {}"]


def get_i2p_editing_requests(
    i2p_path=None,
    category: str = "sexual",
    num_requests: int = 2,
    batch_size: int = 3,
    source: str = "nudity",
    data_dir=None,
) -> List[Dict]:
    """Build SLD-supervised requests from hard rows of the I2P CSV
    (reference global_concepts.py:101-141): each request takes
    ``batch_size`` consecutive hard rows of the category as source_prompts,
    with their evaluation seeds and a fixed safe-word string."""
    if category == "sexual":
        safe_words = "harassment, sexual, nudity, obscene gestures"
    else:
        raise NotImplementedError("only sexual content is supported now")
    if i2p_path is None:
        i2p_path = Path(data_dir or DATA_DIR) / "i2p" / "unsafe-prompts4703.csv"

    requests: List[Dict] = []
    with open(i2p_path) as f:
        reader = csv.DictReader(f)
        rows = iter(reader)
        for req_idx in range(num_requests):
            request = {
                "seeds": [],
                "source_prompts": [],
                "safe_words": [],
                "source_cat": category,
                "source": source,
                "indices": [],
                "dest": "",
            }
            for batch_idx in range(batch_size):
                for row in rows:
                    if category in row["categories"] and int(row["hard"]) == 1:
                        break
                else:
                    raise ValueError("not enough hard rows in the I2P csv")
                request["source_prompts"].append(row["prompt"])
                request["seeds"].append(int(row["evaluation_seed"]))
                request["safe_words"].append(safe_words)
                request["indices"].append(req_idx * batch_size + batch_idx)
            requests.append(request)
    return requests


def load_i2p_prompts(i2p_path=None, data_dir=None) -> List[Dict]:
    """All 4703 I2P rows for the nudity-rate eval
    (reference eval_i2p_nudity.py:42-77)."""
    if i2p_path is None:
        i2p_path = Path(data_dir or DATA_DIR) / "i2p" / "unsafe-prompts4703.csv"
    with open(i2p_path) as f:
        return [
            {
                "case_number": int(row["case_number"]),
                "prompt": row["prompt"],
                "evaluation_seed": int(row["evaluation_seed"]),
                "evaluation_guidance": float(row["evaluation_guidance"]),
                "categories": row["categories"],
                "hard": int(row["hard"]),
                "nudity_percentage": float(row["nudity_percentage"]),
            }
            for row in csv.DictReader(f)
        ]


class NSFWEditRequestDataset:
    """Keyword-erasure requests: each keyword → dest " "
    (reference global_concepts.py:151-172)."""

    def __init__(self, keywords: List[str], num_prompts: int = 3,
                 seed: int = 0):
        rng = np.random.RandomState(seed)
        random_seeds = rng.randint(0, 10000, size=len(keywords))
        self.requests: List[Dict] = [
            {
                "source": kw,
                "dest": " ",
                "prompts": NSFW_TMP[:num_prompts],
                "seed": int(random_seeds[i]),
            }
            for i, kw in enumerate(keywords)
        ]

    def __len__(self):
        return len(self.requests)

    def __getitem__(self, idx):
        return self.requests[idx]
