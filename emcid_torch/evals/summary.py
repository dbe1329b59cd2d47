"""Result summary JSON handling.

A copy of ``emcid_tpu/evals/summary.py`` (the port imports nothing of the
JAX package), so a summary written by either package reads in the other.
The reference keys results as ``edit{N}_weight{W}[_ew{E}]`` in
``results/emcid/{hparam}/{dataset}_summary.json``
(emcid_test.py:1114-1121, 1204-1214), re-reading before write so concurrent
benchmark processes don't clobber each other (SURVEY.md §5 race note).
The same codec and read-modify-write discipline are kept, plus an exclusive
lock (the reference's one unguarded race).
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, Optional

from emcid_torch.parallel.distributed import shared_writes


def summary_key(num_edit: int, mom2_weight, edit_weight=0.5,
                prefix: str = "edit") -> str:
    """``edit{N}_weight{W}`` + ``_ew{E}`` when edit_weight != 0.5."""
    key = f"{prefix}{num_edit}_weight{mom2_weight}"
    if edit_weight is not None and float(edit_weight) != 0.5:
        key += f"_ew{edit_weight}"
    return key


def summary_path(hparam_name: str, dataset_name: str, results_dir=None) -> Path:
    from emcid_torch.globals_cfg import RESULTS_DIR

    base = Path(results_dir) if results_dir else RESULTS_DIR
    return base / "emcid" / hparam_name / f"{dataset_name}_summary.json"


def read_summary(path) -> Dict[str, Any]:
    path = Path(path)
    if path.exists():
        with open(path) as f:
            return json.load(f)
    return {}


def lookup_summary(path, key: str) -> Optional[Dict[str, Any]]:
    """Idempotence check: return the stored record if present."""
    return read_summary(path).get(key)


def update_summary(path, key: str, record: Dict[str, Any]) -> Dict[str, Any]:
    """Locked read-modify-write of one summary key (under a process group
    every process merges, the first writes)."""
    with shared_writes() as write:
        return _update_summary(Path(path), key, record, write)


def _update_summary(path: Path, key: str, record: Dict[str, Any],
                    write: bool) -> Dict[str, Any]:
    path.parent.mkdir(parents=True, exist_ok=True)
    lock_path = str(path) + ".lock"
    lock_fd = None
    try:
        try:
            import fcntl

            lock_fd = open(lock_path, "w")
            fcntl.flock(lock_fd, fcntl.LOCK_EX)
        except (ImportError, OSError):  # pragma: no cover
            lock_fd = None
        summary = read_summary(path)
        existing = summary.get(key, {})
        if isinstance(existing, dict) and isinstance(record, dict):
            existing.update(record)
            summary[key] = existing
        else:
            summary[key] = record
        if write:
            tmp = str(path) + ".tmp"
            with open(tmp, "w") as f:
                json.dump(summary, f, indent=4)
            os.replace(tmp, path)
        return summary
    finally:
        if lock_fd is not None:
            lock_fd.close()
