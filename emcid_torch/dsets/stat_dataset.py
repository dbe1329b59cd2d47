"""Caption corpus for the covariance sweep.

Counterpart of ``emcid_tpu/dsets/stat_dataset.py`` (only
``make_synthetic_captions`` so far: the product's offline fallback corpus).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np


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
