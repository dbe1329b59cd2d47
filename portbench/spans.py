"""Device operations of a ``torch.profiler`` chrome trace put down to the
program spans that launched them.

The program opens ``record_function(name)`` for each of its spans while a
profiler runs (``emcid_torch.profiling.span``), so a span is a host range
(``user_annotation``) on the profiler's own clock.  Each device operation
(kernel, copy, set) carries the ``correlation`` id of the runtime or driver
call that launched it; that call's host time places the launch inside the
innermost range that holds it, whichever host thread made the call (the
autograd engine launches the backward from its own thread while the
caller's thread waits inside the span).
"""

from __future__ import annotations

import bisect
from typing import Dict, List, Tuple

from portbench.trace import DEVICE_CATS, _union

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _complete(events: List[Dict], cats) -> List[Dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats]


def reduce_spans(events: List[Dict]) -> Dict[str, Dict]:
    """Per range name: ``spans`` (how many ranges of that name),
    ``launches`` (device operations launched inside them, each put down to
    the innermost range only), ``busy_s`` (the union of those operations'
    device intervals) and ``extent_s`` (first start to last end of those
    operations).  Times of the chrome trace are in microseconds."""
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                     e["name"])
                    for e in _complete(events, ("user_annotation",)))
    starts = [r[0] for r in ranges]
    launch_ts = {e["args"]["correlation"]: float(e["ts"])
                 for e in _complete(events, LAUNCH_CATS)
                 if "correlation" in e.get("args", {})}
    out: Dict[str, Dict] = {}
    for _, _, name in ranges:
        d = out.setdefault(name, {"spans": 0, "launches": 0, "busy_s": 0.0,
                                  "extent_s": 0.0})
        d["spans"] += 1
    intervals: Dict[str, List[Tuple[float, float]]] = {}
    for e in _complete(events, DEVICE_CATS):
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        if ts is None:
            continue
        i = bisect.bisect_right(starts, ts) - 1
        while i >= 0 and ranges[i][1] < ts:
            i -= 1
        if i < 0:
            continue
        name = ranges[i][2]
        out[name]["launches"] += 1
        t0 = float(e["ts"])
        intervals.setdefault(name, []).append((t0, t0 + float(e["dur"])))
    for name, iv in intervals.items():
        busy = _union(iv)
        out[name]["busy_s"] = sum(b - a for a, b in busy) * 1e-6
        out[name]["extent_s"] = (max(b for _, b in iv)
                                 - min(a for a, _ in iv)) * 1e-6
    return out
