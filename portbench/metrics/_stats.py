"""Shared arithmetic of the metric readers."""
from __future__ import annotations

import numpy as np


def pct(values, q: float):
    """The ``q``-th percentile (0-100) by linear interpolation between
    the closest ranks; None for no values."""
    v = np.asarray(list(values), dtype=float)
    return float(np.percentile(v, q)) if len(v) else None


def in_window(stamps) -> list:
    """The stamps of the window: those a driver's warm-up made before it
    opened read below 0."""
    return [s for s in stamps if s >= 0]


def itl_gaps_ms(run) -> np.ndarray:
    """Every gap between two consecutive output tokens of one request
    that were both emitted in the window (ms)."""
    gaps = [np.diff(s) for s in (in_window(t.stamps)
                                 for t in run.tracks.values())
            if len(s) > 1]
    return np.concatenate(gaps) * 1e3 if gaps else np.zeros(0)
