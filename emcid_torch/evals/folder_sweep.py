"""Folder-level image scoring sweeps (reference util/evaluate.py:30-347):
the ``ImageItem`` filename codec used by causal-tracing outputs, and
extract_all_images_{cls,clip} equivalents that walk a folder, score every
image, and persist the items to JSON.

Counterpart of ``emcid_tpu/evals/folder_sweep.py`` (numpy and PIL, copied);
the scorers are the port's (``evals/scorers.ViTScorer``,
``models/vision.CLIPScorer``, ``models/blip.NativeBlipScorer``)."""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from emcid_torch.parallel.distributed import shared_writes


class ImageItem:
    """Parser for the causal-trace image naming codec
    (reference util/evaluate.py:30-63; names produced by
    trace_with_patch_text_encoder):

    ``{class}_{idx}_{kind}_..._clean.png`` / ``..._corrupt.png`` /
    ``..._l{layer}_restore_{token}.png`` (single) /
    ``..._s{start}_w{window}_restore_{token}.png`` (window).
    """

    def __init__(self, image_path, score=None):
        self.image_path = str(image_path)
        self.image_name = os.path.basename(self.image_path)
        parts = self.image_name.split("_")
        self.class_name = parts[0]
        self.idx = int(parts[1])
        self.kind = parts[2] if parts[2] in ("mlp", "attn") else None
        self.is_corrupted = "corrupt" in self.image_name
        self.is_clean = "clean" in self.image_name
        self.is_restore = "restore" in self.image_name
        self.restore_type = None
        self.token_to_restore = None
        if self.is_restore:
            self.restore_type = ("single" if "w" not in parts[-3]
                                 else "window")
            self.token_to_restore = parts[-1][:-4]
            if self.restore_type == "window":
                self.restore_window = int(parts[-3][1:])
                self.start_layer = int(parts[-4][1:])
            else:
                self.restore_layer = int(parts[-3][1:])
        self.matching_score = score

    def __repr__(self):
        return f"ImageItem({self.image_path})"

    def __eq__(self, other):
        return self.image_path == getattr(other, "image_path", None)

    def to_dict(self) -> Dict:
        return {"image_path": self.image_path,
                "matching_score": self.matching_score}


def find_trace_images(image_folder) -> List[ImageItem]:
    items = []
    for root, _, files in os.walk(image_folder):
        if "summary" in root:
            continue
        for f in files:
            if f.endswith(".png"):
                items.append(ImageItem(os.path.join(root, f)))
    items.sort(key=lambda x: x.idx)
    return items


def extract_all_images_cls(image_folder, scorer, class_id_fn,
                           file_path=None) -> List[ImageItem]:
    """Score every traced image with the ViT classifier
    (reference evaluate.py:283-347).  ``class_id_fn(item) -> int``."""
    from PIL import Image

    items = find_trace_images(image_folder)
    for item in items:
        img = np.asarray(Image.open(item.image_path).convert("RGB"))
        probs = scorer.probs(img[None])
        item.matching_score = float(probs[0, int(class_id_fn(item))])
    if file_path:
        _save_items(items, file_path)
    return items


def extract_all_images_clip(image_folder, clip_scorer, prompt_fn,
                            file_path=None,
                            prefix: str = "A photo depicts ") -> List[ImageItem]:
    """Score every traced image with the CLIP matching score
    (reference evaluate.py:99-186).  ``prompt_fn(item) -> str``."""
    from PIL import Image

    items = find_trace_images(image_folder)
    for item in items:
        img = np.asarray(Image.open(item.image_path).convert("RGB"))
        item.matching_score = float(
            clip_scorer.clip_score(img[None], [prompt_fn(item)],
                                   prefix=prefix)[0]
        )
    if file_path:
        _save_items(items, file_path)
    return items


def _save_items(items: List[ImageItem], file_path):
    with shared_writes() as write:
        if write:
            Path(file_path).parent.mkdir(parents=True, exist_ok=True)
            with open(file_path, "w") as f:
                json.dump([i.to_dict() for i in items], f, indent=2)


def cal_heatmap(items: List[ImageItem], n_layers: int,
                tokens: List[str]) -> np.ndarray:
    """Assemble the (token × layer) restoration heatmap from scored single
    items (reference causal_trace.py:773-857)."""
    heat = np.full((len(tokens), n_layers), np.nan, np.float32)
    tok_index = {t: i for i, t in enumerate(tokens)}
    for item in items:
        if item.is_restore and item.restore_type == "single":
            ti = tok_index.get(item.token_to_restore)
            if ti is not None and item.restore_layer < n_layers:
                heat[ti, item.restore_layer] = item.matching_score
    return heat
