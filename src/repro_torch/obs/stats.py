"""Shared latency statistics, the port's twin of ``repro/obs/stats.py``:
exact percentiles and streaming histograms (numpy and host Python only).

* ``percentile`` / ``latency_summary``: exact order statistics over a
  sample list (numpy linear interpolation, as ``numpy.percentile``), what
  the simulator and the engines report from.
* ``StreamingHistogram``: p50 / p90 / p99 without storing samples, over a
  fixed set of log-spaced buckets on [1e-9, 1e6] (33 a decade); quantiles
  by a cumulative-count walk with log-linear interpolation inside the hit
  bucket, clamped to the exact observed min and max.  O(1) memory and
  O(1) observe, what the registry needs.
"""

from __future__ import annotations

import bisect
import math
from typing import Dict, Sequence

import numpy as np

# Log-spaced bucket edges shared by every StreamingHistogram: worst-case
# relative quantile error is half the bucket ratio (~3.5%).
_EDGE_LO, _EDGE_HI = 1e-9, 1e6
_EDGES_PER_DECADE = 33
_N_EDGES = int(math.log10(_EDGE_HI / _EDGE_LO) * _EDGES_PER_DECADE) + 1
_EDGES = np.geomspace(_EDGE_LO, _EDGE_HI, _N_EDGES)
_LOG_EDGES = np.log(_EDGES)


def percentile(xs: Sequence[float], q: float) -> float:
    """Exact q-th percentile (numpy linear interpolation)."""
    arr = np.asarray(xs, dtype=np.float64)
    assert arr.size > 0, "percentile of an empty sample"
    return float(np.percentile(arr, q))


def latency_summary(xs: Sequence[float]) -> Dict[str, float]:
    """The benchmark/simulator reporting contract: exact p50/p90/p99 and
    mean over a sample list, with the ``*_s`` key names every
    ``BENCH_*.json`` consumer already reads."""
    arr = np.asarray(xs, dtype=np.float64)
    if arr.size == 0:
        return {"p50_s": 0.0, "p90_s": 0.0, "p99_s": 0.0, "mean_s": 0.0}
    return {
        "p50_s": float(np.percentile(arr, 50)),
        "p90_s": float(np.percentile(arr, 90)),
        "p99_s": float(np.percentile(arr, 99)),
        "mean_s": float(arr.mean()),
    }


class StreamingHistogram:
    """Fixed-memory quantile sketch over positive reals.

    ``observe`` increments one bucket; ``quantile(q)`` walks the
    cumulative counts to the target rank and interpolates log-linearly
    within the landing bucket, clamped to the exact observed [min, max].
    Values outside [1e-9, 1e6] clamp into the end buckets (latencies and
    byte counts both live comfortably inside).
    """

    __slots__ = ("counts", "count", "total", "min", "max")

    def __init__(self) -> None:
        self.counts = np.zeros(_N_EDGES - 1, dtype=np.int64)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v
        c = min(max(v, _EDGE_LO), _EDGE_HI)
        # bisect on the module-level edge list: index of the bucket whose
        # [edge[i], edge[i+1]) interval contains c.
        i = bisect.bisect_right(_EDGES, c) - 1
        self.counts[min(max(i, 0), _N_EDGES - 2)] += 1

    def quantile(self, q: float) -> float:
        assert 0.0 <= q <= 100.0, q
        if self.count == 0:
            return 0.0
        rank = q / 100.0 * (self.count - 1)
        cum = np.cumsum(self.counts)
        i = int(np.searchsorted(cum, rank + 1.0 - 1e-9))
        i = min(i, _N_EDGES - 2)
        # Log-linear interpolation inside bucket i by fractional rank.
        lo_rank = cum[i - 1] if i > 0 else 0
        in_bucket = max(int(self.counts[i]), 1)
        frac = min(max((rank - lo_rank + 1.0) / in_bucket, 0.0), 1.0)
        lo, hi = _LOG_EDGES[i], _LOG_EDGES[i + 1]
        v = math.exp(lo + frac * (hi - lo))
        return float(min(max(v, self.min), self.max))

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def summary(self) -> Dict[str, float]:
        return {
            "count": float(self.count),
            "sum": self.total,
            "mean": self.mean,
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
            "p50": self.quantile(50),
            "p90": self.quantile(90),
            "p99": self.quantile(99),
        }
