"""The program's spans in one cell of the port's benchmark, read as the
benchmark reads its per-layer metrics: ``portbench/run.py``'s traced run
(``--trace 1``) with its untraced block or batch under
``emcid_torch.profiling.recording()`` (the span summary in
``facts["program"]``) and its traced one's device operations put down to
the spans (``portbench.spans``, in ``facts["trace"]["spans"]``), so that
the span readers under ``portbench/metrics/`` find their facts.

    python3 portbench/probe.py --workload sd14-edit-b1 --seed 2147483901 \
        [--cost 6] [--out probe.json]

Prints one JSON line: the card and its power limit, the per-layer
metrics with the span metrics beside the benchmark's own, ``correct``,
the idle gaps, the cross-checks of the spans against the phase seconds
(edit cells: the Stage-1 steps and the pool against ``stage1_s``;
generate cells: the sampler steps against ``denoise_s``) and, with
``--cost N`` (edit cells), N blocks with recording on against N with it
off in one process, in turns (off, on, on, off, ...), and the cost of one
span.  ``--out`` gets all of it with the result line, the span summary
and the traced spans.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

EDIT = ["sd14-edit-b8", "sd14-edit-b1"]
GEN = ["sdxl-gen-1024", "sd14-gen-512"]


def _m(name, unit, source, layer, moves, cells):
    return {"name": name, "unit": unit, "better": "lower", "source": source,
            "layer": layer, "moves": moves, "workloads": cells}


# the span metrics, as BENCHMARK.json's per-layer entries will name them
SPAN_METRICS = [
    _m("stage1_step_ms", "ms", "program_span", "Stage 1", "concepts_per_s",
       EDIT),
    _m("stage1_host_ms", "ms", "program_span", "Stage 1", "concepts_per_s",
       EDIT),
    _m("pool_s", "s/block", "program_span", "Stage 1", "concepts_per_s",
       EDIT),
    _m("launches_per_step.stage1", "launches", "device_trace", "Stage 1",
       "concepts_per_s", EDIT),
    _m("idle_share.stage1", "%", "device_trace", "Stage 1", "concepts_per_s",
       EDIT),
    _m("sampler_step_ms", "ms", "program_span", "sampler", "images_per_s",
       GEN),
    _m("launches_per_step.sampler", "launches", "device_trace", "sampler",
       "images_per_s", GEN),
]


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except OSError:
        return "unknown"


def recorded(ctx, orig, when):
    """``orig`` with the calls that ``when(kwargs)`` picks under a
    recording, its summary stored in ``ctx.facts["program"]``."""
    from emcid_torch import profiling

    def f(*a, **k):
        if not when(k) or "program" in ctx.facts:
            return orig(*a, **k)
        with profiling.recording(ctx.device) as rec:
            out = orig(*a, **k)
        ctx.sync()
        ctx.facts["program"] = rec.summary()
        return out
    return f


@contextlib.contextmanager
def probed(ctx_box, driver_name):
    """The benchmark's traced path with the spans recorded and reduced:
    ``trace.reduce`` also reduces by span, and the driver's untraced
    ``apply_emcid`` call (the one given ``timings=``) or first generate
    batch at the traffic's steps runs under a recording."""
    from portbench import spans, trace
    from portbench.harness import wrapped

    driver = importlib.import_module(f"portbench.drivers.{driver_name}")

    def reduce(orig):
        def f(events, launches):
            out = orig(events, launches)
            out["spans"] = spans.reduce_spans(events)
            return out
        return f

    def run(orig):
        def f(ctx):
            ctx_box.append(ctx)
            if driver_name == "edit":
                from emcid_torch.engine import editor

                site = (editor, "apply_emcid",
                        lambda k: k.get("timings") is not None)
            else:
                mod, name, _ = driver.entry(ctx)
                steps = ctx.traffic["steps"]
                site = (mod, name,
                        lambda k: k.get("num_inference_steps") == steps)
            target, attr, when = site
            with wrapped(target, attr,
                         lambda orig_: recorded(ctx, orig_, when)):
                return orig(ctx)
        return f

    with wrapped(trace, "reduce", reduce), wrapped(driver, "run", run):
        yield


def cross_checks(facts, metrics):
    prog = facts.get("program") or {}
    val = {k: v["value"] for k, v in metrics.items()}
    if facts.get("kind") == "edit":
        st = prog.get("stage1.step", {})
        pool = prog.get("stage1.pool", {})
        s1 = val.get("stage1_s")
        out = {"stage1_steps": st.get("n"), "stage1_s": s1}
        if st.get("device_s") and s1:
            n = st["n"]
            pool_s = val.get("pool_s") or 0.0
            out["steps_x_median_plus_pool_over_stage1"] = (
                n * val["stage1_step_ms"] * 1e-3 + pool_s) / s1
            out["steps_sum_plus_pool_over_stage1"] = (
                sum(st["device_s"]) + sum(pool.get("device_s") or [])) / s1
            out["host_steps_sum_plus_pool_over_stage1"] = (
                sum(st["host_s"]) + sum(pool.get("host_s") or [])) / s1
        return out
    st = prog.get("sampler.step", {})
    sample = (facts.get("spans") or {}).get("sample")
    out = {"sampler_evaluations": st.get("n"), "denoise_s_batch": sample}
    if st.get("device_s") and sample:
        out["evals_x_median_over_denoise"] = (
            st["n"] * val["sampler_step_ms"] * 1e-3 / sample)
        out["steps_sum_over_denoise"] = sum(st["device_s"]) / sample
    return out


def span_cost(device, n=20000):
    """Host microseconds of one empty span with recording off, and with
    it on (its two events and, after a synchronize, their reading)."""
    import torch

    from emcid_torch import profiling

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("probe"):
                pass
        return time.perf_counter() - t0

    off = loop()
    with profiling.recording(device) as rec:
        on = loop()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    rec.summary()
    read = time.perf_counter() - t0
    return {"off_us": 1e6 * off / n, "on_us": 1e6 * (on + read) / n}


def recording_cost(cell, seed, n):
    """Seconds of ``n`` edit blocks with recording on and ``n`` with it
    off, in turns, after the driver's own set-up."""
    import torch

    from emcid_torch import profiling
    from emcid_torch.engine import editor
    from portbench import harness, run
    from portbench.drivers import edit

    _, _, cfg, traffic, limits = run.cell_files(cell)
    ctx = harness.Context(
        cell=cell, cfg=cfg, traffic=traffic, limits=limits, seed=seed,
        seconds=0.0, trace=False, device=torch.device("cuda"),
        tmp=run.scratch(cell), t_start=time.time(),
        dtype=getattr(torch, cfg["dtype"]))
    st = edit.setup(ctx)
    rng = ctx.rng(3)
    C = traffic["concepts_per_block"]
    times = {False: [], True: []}
    order = ([False, True, True, False] * n)[:2 * n]
    for on in order:
        reqs = edit.requests(ctx, rng, C)
        kw = dict(stats_dir=st["stats"], cache_name=None,
                  rng_seed=int(rng.integers(0, 2 ** 31)), verbose=False,
                  **edit.product_args(ctx, traffic["edit"]["train_steps"]))
        t0 = time.perf_counter()
        with (profiling.recording(ctx.device) if on
              else contextlib.nullcontext()):
            editor.apply_emcid(st["comps"], reqs, st["hp"], **kw)
        ctx.sync()
        times[on].append(time.perf_counter() - t0)
    off, on = (statistics.median(times[k]) for k in (False, True))
    return {"span": span_cost(ctx.device), "order": order,
            "off_s": times[False], "on_s": times[True],
            "median_off_s": off, "median_on_s": on,
            "cost_pct": 100.0 * (on - off) / off}


def probe(cell, seed, seconds, device, cfg=None, traffic=None):
    """(result line, facts) of one traced run of ``cell`` with the spans
    recorded and reduced (``cfg`` and ``traffic`` replace the cell's
    files, for tests)."""
    from portbench import run

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["per_layer"] = bench["per_layer"] + SPAN_METRICS
    driver_name = (traffic or run.cell_files(cell)[3])["driver"]
    box = []
    with probed(box, driver_name):
        line = run.run_cell(cell, seed, seconds, True, device, cfg=cfg,
                            traffic=traffic, bench=bench)
    return line, box[0].facts


def main(argv=None) -> int:
    from portbench import run

    run.environment()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, choices=EDIT + GEN)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--cost", type=int, default=0,
                    help="edit blocks per side of the recording-cost run")
    ap.add_argument("--out", default=None)
    a = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    line, facts = probe(a.workload, a.seed, a.seconds, "cuda")
    out = {"workload": a.workload, "seed": a.seed, "card": card(),
           "torch": torch.__version__, "run_s": time.perf_counter() - t0,
           "line": line, "cross_checks": cross_checks(facts, line["metrics"]),
           "program": facts.get("program"),
           "trace_spans": (facts.get("trace") or {}).get("spans")}
    if a.cost and facts["kind"] == "edit":
        cost = recording_cost(a.workload, a.seed, a.cost)
        n_spans = sum(d["n"] for d in facts["program"].values())
        cost["span_ms_per_block"] = (
            n_spans * (cost["span"]["on_us"] - cost["span"]["off_us"]) * 1e-3)
        out["recording_cost"] = cost
    text = json.dumps(out)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text)
    print(json.dumps({k: out[k] for k in (
        "workload", "seed", "card", "run_s", "cross_checks")}
        | {"metrics": line["metrics"], "correct": line["correct"],
           "idle_gaps": line["breakdown"]["idle_gaps"],
           "cost": {k: v for k, v in out.get("recording_cost", {}).items()
                    if k.startswith(("median", "cost", "span"))}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
