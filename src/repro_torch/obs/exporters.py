"""Registry exporters: JSONL events, Prometheus text, chrome://tracing
(twin of ``repro/obs/exporters.py``).

All three read only ``Registry.snapshot()`` and ``Registry.events``:

* ``write_jsonl`` — one JSON object per line: a header record (wall-clock
  anchor + metric snapshot) followed by every event in emission order.
* ``write_prometheus`` — the text exposition format: counters, gauges,
  and histogram quantiles as ``name{quantile="0.5"}`` summary series.
* ``write_chrome_trace`` — a ``chrome://tracing`` / Perfetto JSON file:
  spans become complete ("ph": "X") events with microsecond timestamps,
  instants become "ph": "i"; load it at chrome://tracing or ui.perfetto.dev.
* ``torch_profile`` — optional ``torch.profiler`` wrapper (the
  ``--profile-dir`` flag) writing a Chrome trace into the directory: a
  no-op context when the directory is None.

``request_chain_rids`` is the span-chain checker the CI obs smoke asserts
with: the rids whose submit→retire lifecycle is fully covered.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
from typing import Dict, List, Set

from repro_torch.obs.registry import Registry

# The per-request span taxonomy ContinuousEngine emits at harvest time.
REQUEST_PHASES = (
    "request/queue",      # submit -> admit (scheduler wait)
    "request/prefill",    # admit -> first token (the bucketed prefill)
    "request/decode",     # first token -> last token (decode rounds)
    "request/retire",     # last token -> harvested output
)


def write_jsonl(reg: Registry, path: str) -> None:
    with open(path, "w") as f:
        f.write(json.dumps({"kind": "snapshot", **reg.snapshot()}) + "\n")
        for ev in reg.events:
            f.write(json.dumps(ev) + "\n")


_PROM_BAD = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str) -> str:
    return _PROM_BAD.sub("_", name)


def prometheus_text(reg: Registry) -> str:
    snap = reg.snapshot()
    lines: List[str] = []
    for name, v in snap["counters"].items():
        n = _prom_name(name)
        lines.append(f"# TYPE {n} counter")
        lines.append(f"{n} {v}")
    for name, v in snap["gauges"].items():
        n = _prom_name(name)
        lines.append(f"# TYPE {n} gauge")
        lines.append(f"{n} {v}")
    for name, s in snap["histograms"].items():
        if not s:
            continue
        n = _prom_name(name)
        lines.append(f"# TYPE {n} summary")
        for q in (50, 90, 99):
            lines.append(f'{n}{{quantile="0.{q}"}} {s[f"p{q}"]}')
        lines.append(f"{n}_sum {s['sum']}")
        lines.append(f"{n}_count {int(s['count'])}")
    return "\n".join(lines) + "\n"


def write_prometheus(reg: Registry, path: str) -> None:
    with open(path, "w") as f:
        f.write(prometheus_text(reg))


def chrome_trace(reg: Registry) -> Dict:
    """Trace-event JSON: one process, spans on thread 0 with µs stamps
    relative to the registry's perf epoch."""
    t0 = reg.perf0
    trace_events = []
    for ev in reg.events:
        base = {
            "name": ev["name"],
            "pid": 1,
            "tid": 0,
            "ts": (ev["t"] - t0) * 1e6,
            "args": ev.get("attrs", {}),
        }
        if ev["kind"] == "span":
            base["ph"] = "X"
            base["dur"] = ev["dur"] * 1e6
        else:
            base["ph"] = "i"
            base["s"] = "g"
        trace_events.append(base)
    return {"traceEvents": trace_events, "displayTimeUnit": "ms"}


def write_chrome_trace(reg: Registry, path: str) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(reg), f)


def request_chain_rids(reg: Registry) -> Set[int]:
    """rids with a COMPLETE submit→retire chain: a parent ``request``
    span plus all four lifecycle phases pointing at it."""
    phases_by_rid: Dict[int, Set[str]] = {}
    for ev in reg.events:
        if ev.get("kind") != "span":
            continue
        rid = ev.get("attrs", {}).get("rid")
        if rid is None:
            continue
        if ev["name"] == "request" or ev["name"] in REQUEST_PHASES:
            phases_by_rid.setdefault(int(rid), set()).add(ev["name"])
    want = {"request", *REQUEST_PHASES}
    return {rid for rid, names in phases_by_rid.items() if names >= want}


TRACE_FILE = "torch_trace.json"


@contextlib.contextmanager
def torch_profile(profile_dir=None, device="cpu"):
    """``torch.profiler`` around the block when a directory is given (the
    ``--profile-dir`` flag), its Chrome trace written to
    ``profile_dir/torch_trace.json`` at the end; identity otherwise.  The
    CPU's activity is recorded always, the card's only when ``device`` is
    a CUDA device: a CPU run never asks for CUDA."""
    if not profile_dir:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(str(profile_dir), TRACE_FILE))
