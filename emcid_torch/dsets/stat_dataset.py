"""Caption corpus for the covariance sweep.

Counterpart of ``emcid_tpu/dsets/stat_dataset.py``: the CCS caption file
(``data/ccs_filtered.json``, a list of {"caption": ...}), the reference's
collation helpers and ``make_synthetic_captions`` (the product's offline
fallback corpus).  The JAX package's ``download_sub`` is not ported: it
fetches images over the network.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from emcid_torch.globals_cfg import DATA_DIR


class TokenizedDataset:
    """Caption list → per-item tokenized dicts (reference stat_dataset.py:71-110).

    Unlike the reference (which tokenizes up-front into torch tensors), items
    stay as strings until batched: the sweep tokenizes whole fixed-size
    batches.
    """

    def __init__(self, captions: Sequence[str], tokenizer=None,
                 max_length: Optional[int] = None):
        self.captions = list(captions)
        self.tokenizer = tokenizer
        self.max_length = max_length

    @classmethod
    def from_ccs_file(cls, path=None, tokenizer=None, data_dir=None,
                      max_length=None) -> "TokenizedDataset":
        path = Path(path) if path else Path(data_dir or DATA_DIR) / "ccs_filtered.json"
        if not path.exists():
            raise FileNotFoundError(
                f"{path} not found — no network egress in this build; place "
                "the CCS caption json locally (list of {'caption': ...})."
            )
        with open(path) as f:
            data = json.load(f)
        return cls([item["caption"] for item in data], tokenizer, max_length)

    def __len__(self):
        return len(self.captions)

    def __getitem__(self, idx):
        text = self.captions[idx]
        if self.tokenizer is None:
            return text
        enc = self.tokenizer([text], padding="max_length", truncation=True,
                             max_length=self.max_length
                             or self.tokenizer.model_max_length)
        return {
            "input_ids": enc["input_ids"][0],
            "attention_mask": enc["attention_mask"][0],
        }


def length_collation(token_budget: int):
    """Group a batch of tokenized items into sub-batches whose total token
    count stays under ``token_budget`` (reference stat_dataset.py:122-150).
    Kept for compatibility; the sweep uses fixed shapes."""

    def collate(items: Sequence[Dict]) -> List[List[Dict]]:
        groups: List[List[Dict]] = []
        cur: List[Dict] = []
        cur_tokens = 0
        for item in items:
            n = int(np.asarray(item["attention_mask"]).sum())
            if cur and cur_tokens + n > token_budget:
                groups.append(cur)
                cur, cur_tokens = [], 0
            cur.append(item)
            cur_tokens += n
        if cur:
            groups.append(cur)
        return groups

    return collate


def flatten_masked_batch(data, mask):
    """Gather unmasked token rows: (B, S, D), (B, S) → (N, D)
    (reference stat_dataset.py:166-172)."""
    data = np.asarray(data)
    mask = np.asarray(mask).astype(bool)
    return data[mask]



def make_synthetic_captions(n: int, seed: int = 0,
                            vocabulary: Optional[Sequence[str]] = None
                            ) -> List[str]:
    """Deterministic synthetic caption corpus for tests/offline runs."""
    vocab = list(vocabulary) if vocabulary else [
        "a", "photo", "of", "the", "small", "large", "red", "blue", "cat",
        "dog", "house", "tree", "person", "riding", "standing", "near",
        "water", "mountain", "street", "painting",
    ]
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rng.randint(3, 12)
        out.append(" ".join(vocab[i] for i in rng.randint(0, len(vocab), k)))
    return out
