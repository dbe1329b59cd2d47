"""ICEB (ImageNet Concept Editing Benchmark) request datasets.

Parsers for the reference's committed data files (``data/iceb_data/*`` —
drop the reference's ``data/`` directory into this repo's DATA_DIR, or point
``data_dir`` at it).  Request schemas and the deterministic seeding
(``random.seed(2023)`` + ``random.sample``) match the reference
(dsets/iceb_dataset.py:289-395, 22-210, 427-456) so request lists and
training seeds are identical given the same data files.
"""

from __future__ import annotations

import csv
import json
import random
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np

from emcid_torch.globals_cfg import DATA_DIR, EDITING_PROMPTS_CNT
from emcid_torch.parallel.distributed import is_writer

EDIT_PROMPT_TEMPLATES = ["An image of {}", "A photo of {}", "{}"]


class _ListDataset:
    """Minimal sequence protocol shared by all request datasets."""

    requests: List[Dict]

    def __len__(self):
        return len(self.requests)

    def __getitem__(self, idx):
        return self.requests[idx]

    def sample(self, num: int, seed: Optional[int] = None) -> List[Dict]:
        rng = random.Random(seed)
        idxs = list(range(len(self.requests)))
        rng.shuffle(idxs)
        return [self.requests[i] for i in idxs[:num]]


class ObjectPromptDataset(_ListDataset):
    """Raw per-prompt rows from an iceb json file
    ({class name, text prompt, random seed, idx, class id, ...})."""

    def __init__(self, data_dir=None, dataset_dir="iceb_data",
                 file_name="imgnet_prompts.json"):
        path = Path(data_dir or DATA_DIR) / dataset_dir / file_name
        with open(path) as f:
            self.requests = json.load(f)


class RequestDataset(_ListDataset):
    """Grouped per-class edit/val requests from ``imgnet_aug_edit.json``-style
    files (reference iceb_dataset.py:289-395).

    Rows are consecutive per class; each class becomes one request:
    {prompts, source, seeds, seed_train, indices, source id, dest, dest id,
    negative prompts, txt_img_align}.  ``type="edit"`` uses the 3 fixed
    templates; ``type="val"`` keeps the per-class free-form prompts.
    """

    def __init__(
        self,
        data_dir=None,
        dataset_dir: str = "iceb_data",
        file_name: str = "imgnet_aug_edit.json",
        type: str = "edit",
        num_negative_prompts: int = 0,
        txt_img_align: bool = False,
        ccs_sub_file: Optional[str] = None,
    ):
        path = Path(data_dir or DATA_DIR) / dataset_dir / file_name
        if not path.exists():
            raise FileNotFoundError(f"File {path} does not exist.")
        with open(path) as f:
            data = json.load(f)

        negative_prompts: List[str] = []
        if num_negative_prompts > 0:
            sub = ccs_sub_file or str(Path(data_dir or DATA_DIR) / "ccs_filtered_sub.json")
            with open(sub) as f:
                ccs = json.load(f)
            negative_prompts = [
                item["caption"] for item in random.sample(ccs, num_negative_prompts)
            ]

        if type == "edit":
            prompt_slice = slice(0, EDITING_PROMPTS_CNT)
        elif type == "val":
            prompt_slice = slice(None)
        else:
            raise ValueError(f"Invalid type {type}.")

        # deterministic training seeds (reference iceb_dataset.py:328-331)
        rng = random.Random()
        rng.seed(2023)
        training_seeds = rng.sample(range(10000), len(data) // 5)

        self.requests = []
        groups: List[List[Dict]] = []
        cur: List[Dict] = []
        for row in data:
            if cur and row["class name"] != cur[-1]["class name"]:
                groups.append(cur)
                cur = []
            cur.append(row)
        if cur:
            groups.append(cur)

        row_idx = 0
        for g_idx, group in enumerate(groups):
            row_idx += len(group)
            first = group[0]
            if type == "edit":
                prompts = EDIT_PROMPT_TEMPLATES[prompt_slice]
            else:
                prompts = [r["text prompt"] for r in group][prompt_slice]
            self.requests.append({
                "prompts": prompts,
                "source": first["class name"],
                "seeds": [r["random seed"] for r in group][prompt_slice],
                "seed_train": training_seeds[
                    min(row_idx // 5, len(training_seeds) - 1)
                ],
                "indices": [r["idx"] for r in group][prompt_slice],
                "source id": first["class id"],
                "dest": first["dest"],
                "dest id": first["dest id"],
                "negative prompts": negative_prompts,
                "txt_img_align": txt_img_align,
            })


class ImageNetMendRequestDataset(_ListDataset):
    """Concept-rectification requests: class names the model misgenerates
    (reference iceb_dataset.py:22-210).  Selection criteria: a name scores
    below ``name_score_threshold`` under the ViT classifier while its class
    has some name above ``class_score_threshold``; dest = the best-scoring
    alias; conflicting requests removed."""

    def __init__(
        self,
        data_dir=None,
        class_summary_file: str = "iceb_data/imgnet_prompts_cls.json",
        prompt_file: str = "iceb_data/imgnet_aug_full.json",
        type: str = "edit",
        no_extra_knowledge: bool = True,
        class_score_threshold: float = 0.5,
        name_score_threshold: float = 0.1,
        prompts_per_request: int = 3,
        use_simple_train_prompt: bool = True,
    ):
        base = Path(data_dir or DATA_DIR)
        with open(base / class_summary_file) as f:
            summary = json.load(f)
        with open(base / prompt_file) as f:
            prompt_data = json.load(f)

        wrong_classes, wrong_names = [], []
        for class_id, class_data in summary.items():
            highest = max(s["mean"] for s in class_data.values())
            for name, score in class_data.items():
                if score["mean"] < name_score_threshold:
                    wrong_names.append((class_id, name))
            if highest < class_score_threshold:
                wrong_classes.append(class_id)

        templates = (
            EDIT_PROMPT_TEMPLATES
            if use_simple_train_prompt
            else [
                "A visually captivating image, showcasing the detialsd of {}",
                "A photograph showcasing {}",
                "A remarkable image, presenting a detailed view of {}",
            ]
        )
        prompt_slice = (
            slice(0, EDITING_PROMPTS_CNT) if type == "edit" else slice(None)
        )

        rng = random.Random()
        rng.seed(2023)
        seeds_train = rng.sample(range(10000), len(wrong_names))

        by_class: Dict[int, List[Dict]] = {}
        for item in prompt_data:
            by_class.setdefault(int(item["class id"]), []).append(item)

        self.requests = []
        for idx, (class_id, wrong_name) in enumerate(wrong_names):
            if no_extra_knowledge and class_id in wrong_classes:
                continue
            rows = by_class.get(int(class_id), [])
            if not rows:
                continue
            best_name = max(summary[class_id].items(),
                            key=lambda kv: kv[1]["mean"])[0]
            request = {
                "source": wrong_name,
                "dest": best_name,
                "source id": class_id,
                "dest id": class_id,
                "txt_align": class_id not in wrong_classes,
                "use_real_noise": class_id in wrong_classes,
            }
            if type == "val":
                prompts, seeds, indices = [], [], []
                for item in rows:
                    prompt = item["text prompt"].lower().replace(
                        item["class name"].lower(), "{}"
                    )
                    prompts.append(prompt)
                    seeds.append(item["random seed"])
                    indices.append(item["idx"])
                request["prompts"] = prompts[prompt_slice]
                request["seeds"] = seeds[prompt_slice]
                request["indices"] = indices[prompt_slice]
            else:
                request["prompts"] = templates[:prompts_per_request]
                request["seed_train"] = seeds_train[idx]
                request["seeds"] = [r["random seed"] for r in rows][:prompts_per_request]
            self.requests.append(request)

        if type == "edit":
            for idx, request in enumerate(self.requests):
                request["indices"] = [
                    idx * prompts_per_request + i
                    for i in range(prompts_per_request)
                ]

        # conflict removal: same source→different dest, or dest == another's
        # source (reference iceb_dataset.py:186-200)
        to_remove = []
        for request in self.requests:
            for other in self.requests:
                if (request["source"] == other["source"]
                        and request["dest"] != other["dest"]):
                    to_remove.append(request)
                elif request["dest"] == other["source"]:
                    to_remove.append(other)
        for item in to_remove:
            if item in self.requests:
                self.requests.remove(item)


def compose_alias_test_requests(
    val_requests: Sequence[Dict],
    data_dir=None,
    vit_config_file: str = "iceb_data/vit_classifier_config.json",
) -> List[Dict]:
    """Multi-label generalization: for classes with several ImageNet labels,
    clone each val request once per alias (reference iceb_dataset.py:427-456)."""
    with open(Path(data_dir or DATA_DIR) / vit_config_file) as f:
        id2label = json.load(f)["id2label"]

    alias_idxs = []
    for request in val_requests:
        labels = id2label[str(request["source id"])].split(",")
        if len(labels) > 1:
            labels = [l.strip() for l in labels]
            if request["source"] in labels:
                labels.remove(request["source"])
            for label in labels:
                alias_idxs.append((label, request["source id"]))

    new_requests = []
    for label, source_id in alias_idxs:
        for request in val_requests:
            if request["source id"] == source_id:
                nr = dict(request)
                nr["source"] = label
                new_requests.append(nr)
    return new_requests


class CustomObjectRequestDataset(_ListDataset):
    """Custom-object (DreamBooth-style) requests from a directory of
    per-object image folders (reference iceb_dataset.py:213-265).

    Layout: ``{data_dir}/{dataset_dir}/{object_name}/*.jpg`` plus a
    ``prompts_and_classes.txt`` file with ``object_name, class name`` rows.
    Each folder becomes one request: source = the class name looked up in
    the txt file, dest = the folder name, first ``batch_size`` images as
    ``training_img_paths`` (the torch-free real-image Stage-1 mode), and
    the ``txt_img_align`` flag set (these edits use the image-side
    alignment objective, reference v1 path)."""

    def __init__(self, data_dir=None, dataset_dir="dream_booth_dataset",
                 batch_size: int = 3):
        root = Path(data_dir or DATA_DIR) / dataset_dir
        if not root.exists():
            raise FileNotFoundError(f"File {root} does not exist.")
        self.requests = []
        for name in sorted(p.name for p in root.iterdir() if p.is_dir()):
            files = sorted(p for p in (root / name).iterdir()
                           if p.is_file())[:batch_size]
            self.requests.append({
                "source": self._find_source_name(root, name),
                "dest": name,
                "prompts": ["an image of {}", "a photo of {}",
                            "{}, a picture"],
                "seed": 37,
                "seed_train": 37,
                "training_img_paths": [str(p) for p in files],
                "txt_img_align": True,
            })

    @staticmethod
    def _find_source_name(root: Path, dest_name: str) -> str:
        with open(root / "prompts_and_classes.txt") as f:
            for line in f:
                if dest_name in line:
                    return line.split(",")[1].strip()
        raise ValueError(f"Cannot find source name for dest {dest_name}.")


def get_filtered_dataset(
    data_file="imgnet_prompts_aug.json",
    out_file=None,
    data_dir=None,
    prompts_per_class: int = 5,
) -> List[Dict]:
    """Keep only classes whose ``prompts_per_class`` prompts are all
    ``checked`` (reference iceb_dataset.py:576-607; dataset-construction
    utility).  Writes ``out_file`` when given; returns the filtered rows."""
    ds = ObjectPromptDataset(data_dir=data_dir,
                             file_name=Path(data_file).name)
    n_classes = (len(ds) + prompts_per_class - 1) // prompts_per_class
    cnt = np.full((n_classes,), prompts_per_class)
    for idx, item in enumerate(ds):
        if not item.get("checked", False):
            cnt[idx // prompts_per_class] -= 1
    full = {i for i in range(n_classes) if cnt[i] == prompts_per_class}
    new_rows = [item for idx, item in enumerate(ds)
                if idx // prompts_per_class in full]
    assert len(new_rows) == len(full) * prompts_per_class
    if out_file is not None and is_writer():
        Path(out_file).parent.mkdir(parents=True, exist_ok=True)
        with open(out_file, "w") as f:
            json.dump(new_rows, f, indent=4)
    return new_rows


def requests_to_csv(requests: Sequence[Dict], out_file) -> None:
    """Persist requests as CSV with repr-encoded list columns (the
    arbitrary/rectification split files, reference iceb_dataset.py:398-424)."""
    fields = ["source", "dest", "prompts", "seed_train", "seeds",
              "source id", "dest id"]
    Path(out_file).parent.mkdir(parents=True, exist_ok=True)
    with open(out_file, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fields, extrasaction="ignore")
        w.writeheader()
        for r in requests:
            row = {k: r.get(k) for k in fields}
            for k in ("prompts", "seeds"):
                if isinstance(row.get(k), list):
                    row[k] = repr([str(x) for x in row[k]])
            w.writerow(row)


def requests_from_csv(path) -> List[Dict]:
    """Load requests persisted as CSV (the arbitrary/rectification split
    files, e.g. ``rectification_train.csv``: list-typed columns are
    repr-encoded)."""
    import ast

    out = []
    with open(path) as f:
        for row in csv.DictReader(f):
            req = dict(row)
            for key in ("prompts", "seeds", "indices"):
                if key in req and isinstance(req[key], str):
                    try:
                        req[key] = ast.literal_eval(req[key])
                    except (ValueError, SyntaxError):
                        pass
            for key in ("seed_train", "source id", "dest id"):
                if key in req and isinstance(req[key], str) and req[key].isdigit():
                    req[key] = int(req[key])
            if "seeds" in req and isinstance(req["seeds"], list):
                req["seeds"] = [int(s) for s in req["seeds"]]
            out.append(req)
    return out
