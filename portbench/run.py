"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; the numbers compared with the reference come last, under
``checks``, and again as the last lines of standard error.  Exits with
another code than 0, printing no result, without enough CUDA devices, or
if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "emcid_tpu")


def environment() -> None:
    """The cell's files define the run: no ``EMCID_TPU_*`` setting from
    outside; caches at fixed places inside the checkout; one host thread
    for PyTorch's and BLAS's pools, so that the launching thread does not
    share its cores with idle workers."""
    for k in [k for k in os.environ if k.startswith("EMCID_TPU_")]:
        del os.environ[k]
    for k in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[k] = "1"
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["USE_FLAX"] = "0"
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def loaded_forbidden() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cell_files(cell: str):
    """(BENCHMARK.json, workload, configuration, traffic, limits)."""
    from portbench.harness import load_json

    bench = load_json(ROOT / "BENCHMARK.json")
    wl = next(w for w in bench["workloads"] if w["name"] == cell)
    conf = next(c for c in bench["configs"] if c["name"] == wl["config"])
    here = ROOT / "portbench"
    return (bench, wl, load_json(ROOT / conf["file"]),
            load_json(here / "traffic" / f"{wl['traffic']}.json"),
            load_json(here / "limits" / f"{cell}.json"))


def scratch(cell: str) -> Path:
    """This cell's scratch directory under ``TMPDIR`` (a fixed path)."""
    import tempfile

    tmp = Path(os.environ.get("TMPDIR") or tempfile.gettempdir())
    tmp = tmp / "portbench" / cell
    tmp.mkdir(parents=True, exist_ok=True)
    return tmp


def applies(metric: dict, cell: str) -> bool:
    wls = metric.get("workloads")
    return wls is None or cell in wls


def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             cfg=None, traffic=None, limits=None, bench=None) -> dict:
    """The result object of one run (``cfg``, ``traffic``, ``limits`` and
    ``bench`` replace the cell's files, for tests)."""
    import torch

    from portbench import harness

    b, wl, c, tr, lim = cell_files(cell)
    bench, cfg = bench or b, cfg or c
    traffic, limits = traffic or tr, limits or lim
    tmp = scratch(cell)
    ctx = harness.Context(
        cell=cell, cfg=cfg, traffic=traffic, limits=limits, seed=seed,
        seconds=seconds, trace=trace, device=torch.device(device),
        tmp=tmp, t_start=T_START,
        dtype=getattr(torch, cfg["dtype"]))
    driver = importlib.import_module(f"portbench.drivers.{traffic['driver']}")
    res = driver.run(ctx)
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in res["checks"].items()}
    correct = all(math.isfinite(x["value"]) and x["value"] <= x["limit"]
                  for x in checks.values())
    if trace:
        metrics = harness.per_layer(ctx, [
            m for m in bench["per_layer"] if applies(m, cell)])
    else:
        metrics = {m["name"]: {"value": float(res["metrics"][m["name"]]),
                               "unit": m["unit"]}
                   for m in bench["end_to_end"]
                   if applies(m, cell) and m["name"] in res["metrics"]}
    dev = ctx.device
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": res["peak"] or 0}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]),
           "failed": 0, "metrics": metrics, "device": device_info}
    tf = ctx.facts.get("trace") or {}
    if trace:
        device_info["busy_s"] = tf.get("busy_s", 0.0)
        device_info["window_s"] = tf.get("window_s", 0.0)
        out["breakdown"] = {"device_ops": tf.get("device_ops", []),
                            "idle_gaps": tf.get("idle_gaps", [])}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    import torch

    from portbench.harness import load_json

    wl = next((w for w in load_json(ROOT / "BENCHMARK.json")["workloads"]
               if w["name"] == a.workload), None)
    if wl is None:
        print(f"no workload {a.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{a.workload} needs {wl['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), "cuda")
    bad = loaded_forbidden()
    if bad:
        print(f"loaded in this process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
