"""What the readers of the program's spans share: ``facts["program"]``,
the span summary (``emcid_torch.profiling.Recorder.summary``) of the
untraced block or batch, and ``facts["trace"]["spans"]``, the traced
block's or batch's device operations by span (``portbench.spans``)."""

from __future__ import annotations

import statistics
from typing import Dict, Optional


def lengths(facts: Dict, kind: str, name: str, clock: str):
    """The ``clock`` ("host_s" or "device_s") seconds of each span
    ``name`` of the untraced block or batch; None where there are none."""
    if facts.get("kind") != kind:
        return None
    v = (facts.get("program") or {}).get(name, {}).get(clock)
    return v or None


def median_ms(facts: Dict, kind: str, name: str,
              clock: str) -> Optional[float]:
    v = lengths(facts, kind, name, clock)
    return None if v is None else 1e3 * statistics.median(v)


def traced(facts: Dict, kind: str, name: str) -> Optional[Dict]:
    """The traced device operations of the spans ``name``, where there
    were any."""
    if facts.get("kind") != kind:
        return None
    d = ((facts.get("trace") or {}).get("spans") or {}).get(name)
    return d if d and d["spans"] and d["launches"] else None
