"""Artist-erasure requests (reference dsets/artist_requests.py:26-53) and
the erased/holdout eval prompt CSVs (``data/artists/prompts_dir/*``)."""

from __future__ import annotations

import csv
import json
from pathlib import Path
from typing import Dict, List, Optional

from emcid_torch.globals_cfg import DATA_DIR

ARTIST_TEMPLATES = ["painting by {}", "artwork by {}", "style of {}"]


def _torch_seed_stream(n: int, seed: int = 2023) -> List[int]:
    """Per-artist training seeds.  The reference draws them from
    ``torch.manual_seed(2023)`` + ``torch.randint(0, 100000)``
    (artist_requests.py:34-38); torch-cpu reproduces the stream exactly,
    with a deterministic numpy fallback when torch is absent."""
    try:
        import torch

        torch.random.manual_seed(seed)
        return [int(torch.randint(0, 100000, (1,)).item()) for _ in range(n)]
    except ImportError:  # pragma: no cover
        import numpy as np

        rng = np.random.RandomState(seed)
        return [int(x) for x in rng.randint(0, 100000, size=n)]


class ArtistRequestsDataset:
    """One erase request per artist from an ``erased-N...txt`` list (a JSON
    array of names).  ``dest`` defaults to the reference's in-code default;
    the shell workflow overrides it to "art" (sh erase_artists launcher)."""

    def __init__(
        self,
        src_file=None,
        data_dir=None,
        num_artists: Optional[int] = None,
        dest: str = "a photographer, real world scene",
    ):
        if src_file is None:
            if num_artists is None:
                num_artists = 5
            src_file = (
                Path(data_dir or DATA_DIR) / "artists" / "info"
                / f"erased-{num_artists}artists-towards_art-preserve_true-"
                  f"sd_1_4-method_replace.txt"
            )
        with open(src_file) as f:
            self.artists: List[str] = json.load(f)
        seeds = _torch_seed_stream(len(self.artists))
        self.requests: List[Dict] = [
            {
                "prompts": list(ARTIST_TEMPLATES),
                "source": artist,
                "seed_train": seeds[i],
                "dest": dest,
            }
            for i, artist in enumerate(self.artists)
        ]
        self.erase_artists = list(self.artists)

    def __len__(self):
        return len(self.requests)

    def __getitem__(self, idx):
        return self.requests[idx]


def load_artist_eval_prompts(
    num_artists: int,
    data_dir=None,
    file_path=None,
) -> List[Dict]:
    """Eval prompt rows {case_number, prompt, evaluation_seed, artist, type}
    with type ∈ {erased, holdout} from the prompts_dir CSVs."""
    if file_path is None:
        file_path = (
            Path(data_dir or DATA_DIR) / "artists" / "prompts_dir"
            / f"erased-{num_artists}artists-towards_art-preserve_true-"
              f"sd_1_4-method_replace.csv"
        )
    rows = []
    with open(file_path) as f:
        for row in csv.DictReader(f):
            rows.append({
                "case_number": int(row["case_number"]),
                "prompt": row["prompt"],
                "evaluation_seed": int(row["evaluation_seed"]),
                "artist": row["artist"],
                "type": row["type"],
            })
    return rows
