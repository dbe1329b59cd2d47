"""ICEB dataset construction utilities
(reference dsets/iceb_dataset.py:459-559): splitting the filtered prompt pool
into edit/test sets, with destination classes picked as a random draw from
the k CLIP-text-nearest held-out classes.

Counterpart of ``emcid_tpu/dsets/construction.py``; the text tower is
the port's module (its weights inside it), so no ``text_params`` travel
with it.  The reference computes one pairwise cosine per (edit, test) class
with a separate forward each (O(N²) forwards); here all class-name
embeddings are encoded in one batched pass and similarities are a single
matmul.
"""

from __future__ import annotations

import json
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from emcid_torch.globals_cfg import DATA_DIR
from emcid_torch.parallel.distributed import is_writer


def class_name_embeddings(text_model, tokenizer, names: Sequence[str],
                          template: str = "an image of {}") -> np.ndarray:
    """Unit-normalized pooled embeddings of templated class names (one
    batched forward of the port's ``CLIPTextEncoder``)."""
    import torch

    enc = tokenizer([template.format(n) for n in names],
                    padding="max_length", truncation=True,
                    max_length=tokenizer.model_max_length)
    dev = next(text_model.parameters()).device
    with torch.no_grad():
        out = text_model(torch.as_tensor(enc["input_ids"], device=dev).long())
    emb = out.pooled_output.float().cpu().numpy()
    return emb / np.linalg.norm(emb, axis=-1, keepdims=True)


def find_dest(
    all_class_indices: Sequence[int],
    edit_class_indices: Sequence[int],
    k_nb: int,
    text_model,
    tokenizer,
    id2label: Dict[str, str],
    seed: int = 2023,
) -> List[Dict]:
    """Per edit class: draw the destination uniformly from its ``k_nb``
    CLIP-nearest held-out classes (reference iceb_dataset.py:501-559;
    random.seed(2023) kept)."""
    test_class_indices = sorted(set(all_class_indices) - set(edit_class_indices))
    first_name = lambda cid: id2label[str(cid)].split(",")[0].strip()
    test_names = [first_name(c) for c in test_class_indices]
    edit_names = [first_name(c) for c in edit_class_indices]
    test_emb = class_name_embeddings(text_model, tokenizer, test_names)
    edit_emb = class_name_embeddings(text_model, tokenizer, edit_names)
    sims = edit_emb @ test_emb.T  # (E, T)

    dest_set = []
    for i, edit_cid in enumerate(edit_class_indices):
        order = np.argsort(-sims[i])[:k_nb]
        rng = random.Random()
        rng.seed(seed)
        pick = rng.choice(list(order))
        dest_set.append({
            "class name": edit_names[i],
            "class id": int(edit_cid),
            "dest": test_names[int(pick)],
            "dest id": int(test_class_indices[int(pick)]),
        })
    return dest_set


def edit_test_split(
    text_model,
    tokenizer,
    num_edit: int = 300,
    k_nb: int = 5,
    data_dir=None,
    filtered_file: str = "imgnet_prompts_filtered.json",
    edit_file: str = "imgnet_small_edit_aug.json",
    test_file: str = "objects_test_aug.json",
    vit_config_file: str = "vit_classifier_config.json",
    rng_seed: Optional[int] = 0,
) -> Dict[str, List[Dict]]:
    """Split the filtered prompt pool into edit/test sets and attach dests
    (reference iceb_dataset.py:459-498).  Writes both JSON files into
    ``{data_dir}/iceb_data/`` and returns them."""
    base = Path(data_dir or DATA_DIR) / "iceb_data"
    with open(base / filtered_file) as f:
        pool = json.load(f)
    with open(base / vit_config_file) as f:
        id2label = json.load(f)["id2label"]

    all_class_ids = sorted({item["class id"] for item in pool})
    rng = np.random.RandomState(rng_seed)
    edit_class_ids = rng.choice(all_class_ids, num_edit, replace=False)

    dest_set = find_dest(all_class_ids, list(edit_class_ids), k_nb,
                         text_model, tokenizer, id2label)
    dest_by_cid = {d["class id"]: d for d in dest_set}

    edit_set, test_set = [], []
    for item in pool:
        if item["class id"] in dest_by_cid:
            item = dict(item)
            d = dest_by_cid[item["class id"]]
            item["dest"] = d["dest"]
            item["dest id"] = d["dest id"]
            item["text prompt"] = item["text prompt"].lower().replace(
                item["class name"].lower(), "{}")
            edit_set.append(item)
        else:
            test_set.append(item)

    if is_writer():
        with open(base / edit_file, "w") as f:
            json.dump(edit_set, f, indent=4)
        with open(base / test_file, "w") as f:
            json.dump(test_set, f, indent=4)
    return {"edit": edit_set, "test": test_set, "dest_set": dest_set}
