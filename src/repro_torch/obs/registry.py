"""Process-global metrics + tracing registry (twin of
``repro/obs/registry.py``; host Python only, no torch).

One ``Registry`` per process (``obs.registry()``), disabled by default
(enable with ``obs.enable()`` or ``REPRO_OBS=1``).  Disabled, every API is
a true no-op: ``counter()``/``gauge()``/``histogram()`` return shared null
singletons whose methods do nothing, ``span()`` returns a reusable null
context manager, and no events are stored — the hot-path cost is one
attribute load and one branch.

Enabled, it holds:

* **counters / gauges** — plain floats keyed by name;
* **histograms** — ``obs.stats.StreamingHistogram`` (p50/p90/p99 without
  storing samples);
* **events** — a bounded list of dicts: instant events and completed
  spans.  Spans nest via a thread-local stack (``span()``) or explicit
  timestamps (``record_span`` — how the engine reconstructs a request's
  submit→retire chain from stamps taken at sync points).  All timestamps
  are ``time.perf_counter()`` seconds; ``epoch0``/``perf0`` in
  ``snapshot()`` anchor them to wall time.

Exporters (JSONL / Prometheus text / chrome://tracing) live in
``obs.exporters`` and read only ``snapshot()`` + ``events``.
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.obs.stats import StreamingHistogram


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def inc(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class _NullCounter:
    __slots__ = ()
    value = 0.0

    def inc(self, n: float = 1.0) -> None:
        pass


class _NullGauge:
    __slots__ = ()
    value = 0.0

    def set(self, v: float) -> None:
        pass


class _NullHistogram:
    __slots__ = ()
    count = 0

    def observe(self, v: float) -> None:
        pass

    def quantile(self, q: float) -> float:
        return 0.0

    def summary(self) -> Dict[str, float]:
        return {}


class _NullSpan:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()
_NULL_SPAN = _NullSpan()


class Registry:
    """Counters + gauges + streaming histograms + span/event log."""

    def __init__(self, enabled: bool = False, max_events: int = 200_000):
        self.enabled = enabled
        self.max_events = max_events
        self.perf0 = time.perf_counter()
        self.epoch0 = time.time()
        self.events: List[Dict[str, Any]] = []
        self.events_dropped = 0
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, StreamingHistogram] = {}
        self._ids = itertools.count(1)
        self._local = threading.local()

    # -- lifecycle ---------------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Drop all metrics and events (keeps the enabled flag)."""
        self.events.clear()
        self.events_dropped = 0
        self._counters.clear()
        self._gauges.clear()
        self._histograms.clear()
        self.perf0 = time.perf_counter()
        self.epoch0 = time.time()

    # -- metrics -----------------------------------------------------------

    def counter(self, name: str) -> Counter:
        if not self.enabled:
            return _NULL_COUNTER
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        if not self.enabled:
            return _NULL_GAUGE
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> StreamingHistogram:
        if not self.enabled:
            return _NULL_HISTOGRAM
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = StreamingHistogram()
        return h

    # -- events / spans ----------------------------------------------------

    def _append(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.events_dropped += 1
            return
        self.events.append(ev)

    def event(self, name: str, **attrs) -> None:
        """One instant event at now."""
        if not self.enabled:
            return
        ev = {"name": name, "kind": "instant", "t": time.perf_counter()}
        if attrs:
            ev["attrs"] = attrs
        self._append(ev)

    def _span_stack(self) -> list:
        st = getattr(self._local, "spans", None)
        if st is None:
            st = self._local.spans = []
        return st

    @contextlib.contextmanager
    def _live_span(self, name: str, attrs):
        sid = next(self._ids)
        stack = self._span_stack()
        parent = stack[-1] if stack else None
        stack.append(sid)
        t0 = time.perf_counter()
        try:
            yield sid
        finally:
            t1 = time.perf_counter()
            stack.pop()
            ev = {
                "name": name, "kind": "span", "t": t0, "dur": t1 - t0,
                "id": sid,
            }
            if parent is not None:
                ev["parent"] = parent
            if attrs:
                ev["attrs"] = attrs
            self._append(ev)

    def span(self, name: str, **attrs):
        """Context manager: a nested span with monotonic start/stop.  The
        disabled path returns a shared null manager (no allocation)."""
        if not self.enabled:
            return _NULL_SPAN
        return self._live_span(name, attrs)

    def record_span(
        self, name: str, t0: float, t1: float,
        parent: Optional[int] = None, **attrs,
    ) -> Optional[int]:
        """A completed span from explicit ``perf_counter`` stamps — how
        phases measured at sync points (TTFT, decode tail) enter the
        trace after the fact.  Returns the span id (usable as ``parent``
        for its children), or None when disabled."""
        if not self.enabled:
            return None
        sid = next(self._ids)
        ev = {
            "name": name, "kind": "span", "t": t0, "dur": max(t1 - t0, 0.0),
            "id": sid,
        }
        if parent is not None:
            ev["parent"] = parent
        if attrs:
            ev["attrs"] = attrs
        self._append(ev)
        return sid

    # -- reporting ---------------------------------------------------------

    def snapshot(self) -> Dict[str, Any]:
        return {
            "enabled": self.enabled,
            "perf0": self.perf0,
            "epoch0": self.epoch0,
            "counters": {k: c.value for k, c in sorted(self._counters.items())},
            "gauges": {k: g.value for k, g in sorted(self._gauges.items())},
            "histograms": {
                k: h.summary() for k, h in sorted(self._histograms.items())
            },
            "num_events": len(self.events),
            "events_dropped": self.events_dropped,
        }


_GLOBAL = Registry(enabled=os.environ.get("REPRO_OBS", "") == "1")


def registry() -> Registry:
    """THE process-global registry."""
    return _GLOBAL


def enable() -> None:
    _GLOBAL.enable()


def disable() -> None:
    _GLOBAL.disable()
