"""Shared debias metric helpers."""


def ratio_delta(female_ratio: float) -> float:
    """delta = |P(female) − 0.5| / 0.5 (reference eval_debias.py:275-367)."""
    return abs(female_ratio - 0.5) / 0.5
