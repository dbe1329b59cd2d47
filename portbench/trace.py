"""The traced window: ``torch.profiler`` over one block or batch, reduced to
device busy time, the window's length, the device operations that took
most time, the longest idle gaps by what the host was doing, and the
attention kernels' time beside their least time.

The window is the host range ``portbench.window``; busy time is the union
of the device's kernel, copy and set intervals inside it.  The attention
kernels' shapes come from wrappers around the program's kernel entries
(``emcid_torch.ops.flash_v2.flash_fwd``, ``flash_dq``, ``flash_dkv`` and
``emcid_torch.ops.attention.short_kv_fwd``), one record per launch.
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import torch

from portbench import yardstick
from portbench.harness import Context, wrapped

WINDOW = "portbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# the program's attention kernels (csrc/flash_v2.cu, csrc/short_kv.cu),
# every route
KERNEL_NAMES = {
    "K1": re.compile(r"(?<![\w])(fwd_kernel|fwd_mma_kernel|fwd_d512_kernel)\b"),
    "K2": re.compile(r"(?<![\w])(dq_kernel|dq_mma_kernel)\b"),
    "K3": re.compile(r"(?<![\w])(dkv_kernel|dkv_mma_kernel)\b"),
    "K4": re.compile(r"(?<![\w])(short_kv_kernel|short_kv_mma_kernel)\b"),
}


@contextlib.contextmanager
def attention_shapes(launches: List[Tuple]):
    """Record (kernel, B, N, M, H, D, itemsize) of every attention kernel
    launch inside the scope."""
    from emcid_torch.ops import attention, flash_v2

    def rec(kernel):
        def make(orig):
            def f(q, k, v, *a, **kw):
                B, N, H, D = q.shape
                launches.append((kernel, B, N, k.shape[1], H, D,
                                 q.element_size()))
                return orig(q, k, v, *a, **kw)
            return f
        return make

    with wrapped(flash_v2, "flash_fwd", rec("K1")), \
            wrapped(flash_v2, "flash_dq", rec("K2")), \
            wrapped(flash_v2, "flash_dkv", rec("K3")), \
            wrapped(attention, "short_kv_fwd", rec("K4")):
        yield launches


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def reduce(events: List[Dict], launches: List[Tuple]) -> Dict:
    """Facts of one chrome trace's events (times in microseconds)."""
    win = [e for e in events if e.get("ph") == "X" and e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = [e for e in events if e.get("ph") == "X"
           and e.get("cat") in DEVICE_CATS]
    spans = [(max(float(e["ts"]), w0), min(float(e["ts"]) + float(e["dur"]),
                                           w1)) for e in dev]
    busy = _union([s for s in spans if s[1] > s[0]])
    by_name: Dict[str, float] = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + float(e["dur"])
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    notes = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation" and e.get("name") != WINDOW]
    starts = sorted((float(e["ts"]), e["name"]) for e in dev)
    start_ts = [ts for ts, _ in starts]
    gaps = []
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        phase = [n["name"] for n in notes
                 if float(n["ts"]) <= mid <= float(n["ts"]) + float(n["dur"])]
        k = bisect.bisect_left(start_ts, b)
        nxt = starts[k][1] if k < len(starts) else "window end"
        gaps.append(((phase[-1] if phase else "host") + " -> "
                     + nxt[:80], (b - a) * 1e-6))
    gaps.sort(key=lambda g: -g[1])
    attn_s, n_attn = 0.0, 0
    for e in dev:
        if e.get("cat") == "kernel" and any(
                p.search(e["name"]) for p in KERNEL_NAMES.values()):
            attn_s += float(e["dur"]) * 1e-6
            n_attn += 1
    bound = sum(yardstick.attn_bound_s(*l) for l in launches)
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "device_ops": [[n, d * 1e-6] for n, d in top],
        "idle_gaps": [list(g) for g in gaps[:10]],
        "attn_kernel_s": attn_s, "attn_kernel_events": n_attn,
        "attn_bound_s": bound, "attn_launches": len(launches),
    }


def traced(ctx: Context, fn: Callable[[], None]) -> Dict:
    """Run ``fn`` once under the profiler as the traced window; its facts
    (empty without a card)."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if ctx.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    launches: List[Tuple] = []
    with attention_shapes(launches), profile(activities=acts) as prof:
        with record_function(WINDOW):
            fn()
            ctx.sync()
    path = Path(ctx.tmp) / "trace.json"
    prof.export_chrome_trace(str(path))
    try:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return reduce(events, launches)
