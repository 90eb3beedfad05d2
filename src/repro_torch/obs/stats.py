"""Exact latency percentiles, the port's twin of the sample-list half of
``repro/obs/stats.py`` (numpy linear interpolation, as
``numpy.percentile``).  The streaming histogram belongs to the registry
(ROADMAP A8)."""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


def percentile(xs: Sequence[float], q: float) -> float:
    """Exact q-th percentile (numpy linear interpolation)."""
    arr = np.asarray(xs, dtype=np.float64)
    assert arr.size > 0, "percentile of an empty sample"
    return float(np.percentile(arr, q))


def latency_summary(xs: Sequence[float]) -> Dict[str, float]:
    """Exact p50 / p90 / p99 and mean over a sample list, under the ``*_s``
    key names the simulator and the benchmarks read."""
    arr = np.asarray(xs, dtype=np.float64)
    if arr.size == 0:
        return {"p50_s": 0.0, "p90_s": 0.0, "p99_s": 0.0, "mean_s": 0.0}
    return {
        "p50_s": float(np.percentile(arr, 50)),
        "p90_s": float(np.percentile(arr, 90)),
        "p99_s": float(np.percentile(arr, 99)),
        "mean_s": float(arr.mean()),
    }
