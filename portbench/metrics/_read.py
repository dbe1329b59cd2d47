"""What the per-layer readers share."""

from __future__ import annotations

from typing import Dict, Optional

from portbench.yardstick import PEAK_FLOPS


def phase_per_block(facts: Dict, phase: str) -> Optional[float]:
    """Seconds of one ``apply_emcid`` phase per edit block."""
    v = facts.get("phases", {}).get(phase)
    return None if v is None or facts.get("kind") != "edit" else v


def mfu(flops: Optional[float], seconds: Optional[float]) -> Optional[float]:
    """Percent of the bf16 peak."""
    if not flops or not seconds:
        return None
    return 100.0 * flops / seconds / PEAK_FLOPS


def idle(facts: Dict, kind: str) -> Optional[float]:
    t = facts.get("trace") or {}
    if facts.get("kind") != kind or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])


def roofline(facts: Dict, kind: str) -> Optional[float]:
    """Summed least time of the attention kernels' launches over their
    summed device time, where every launch was matched to a device event."""
    t = facts.get("trace") or {}
    if (facts.get("kind") != kind or not t.get("attn_kernel_s")
            or t["attn_launches"] != t["attn_kernel_events"]):
        return None
    return 100.0 * t["attn_bound_s"] / t["attn_kernel_s"]


def peak_gib(facts: Dict, kind: str) -> Optional[float]:
    b = facts.get("peak_mem_bytes")
    return None if facts.get("kind") != kind or not b else b / 2 ** 30
