"""The control of a cell's check: the reference in float8 put in the
program's place.  For each seed, one run of the cell (its own check
numbers), then the same numbers of the control on the same drawn block or
images.  Not part of a benchmark run; its readings set the limits.

    python3 portbench/control.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file.jsonl>]
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from portbench import run as bench  # noqa: E402


def readings(cell: str, seed: int, seconds: float, device="cuda",
             cfg=None, traffic=None) -> dict:
    """{"program": numbers, "control": numbers} of one seed."""
    import torch

    from portbench import harness

    _, _, c, tr, lim = bench.cell_files(cell)
    cfg, traffic = cfg or c, traffic or tr
    ctx = harness.Context(
        cell=cell, cfg=cfg, traffic=traffic, limits=lim, seed=seed,
        seconds=seconds, trace=False, device=torch.device(device),
        tmp=Path(bench.scratch(cell)), t_start=time.time(),
        dtype=getattr(torch, cfg["dtype"]))
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    res = driver.run(ctx)
    ctl = driver.control(ctx, res["window"])
    harness.free_cuda(ctx)
    return {"cell": cell, "seed": seed, "program": res["checks"],
            "control": ctl, "limits": lim}


def main() -> int:
    bench.environment()
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out")
    a = ap.parse_args()
    for seed in a.seeds:
        row = readings(a.workload, seed, a.seconds)
        print(json.dumps(row), flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
