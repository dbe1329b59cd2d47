"""Percent of the traced edit block's device busy time in the attention
kernels K1-K4 (``trace`` facts ``attn_kernel_s`` over ``busy_s``)."""


def read(facts):
    t = facts.get("trace") or {}
    if facts.get("kind") != "edit" or not t.get("busy_s") or not t.get(
            "attn_kernel_events"):
        return None
    return 100.0 * t["attn_kernel_s"] / t["busy_s"]
