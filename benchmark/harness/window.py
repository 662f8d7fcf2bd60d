"""The window's arithmetic: a rate over all the work and all the time of
the window, and a tail over every frame in it."""

from __future__ import annotations

import math


def per_frame_ms(window_s: float, frames: int) -> float:
    """Wall time of the whole window over the frames completed in it."""
    if frames <= 0:
        raise ValueError("the window completed no frame")
    return 1e3 * window_s / frames


def intervals_ms(stamps_ms: list[float]) -> list[float]:
    """The gaps between consecutive time stamps (ms)."""
    return [b - a for a, b in zip(stamps_ms, stamps_ms[1:])]


def percentile(values: list[float], q: float) -> float:
    """The nearest-rank ``q``-th percentile of all ``values``: the least
    value with at least q% of them at or below it."""
    if not values:
        raise ValueError("no values")
    xs = sorted(values)
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]
