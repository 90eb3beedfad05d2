"""On-device link and decode counters: the link taps and the counter dict
(twin of ``repro/obs/device.py``).

The link layers (``core.link.apply_channel``, ``core.comtune``'s dropout,
channel, streamed and egress paths, ``net.fec``) tap: whenever a collector
is installed on the module-level stack, each mask draw records its element
count, its dropped count and its FEC recoveries into the collector, and
the caller that installed it turns the totals into the engine state's
``obs`` counters or the train step's metrics.

The reference records while a program is traced; the port runs eagerly,
so a record call runs when the link runs.  The totals are 0-d float32
tensors on the masks' device, summed there: nothing here calls ``.item()``
or copies to the host until ``counters_to_host``.  With no collector
installed (the reference loop, the whole-generation engine, training
without the tap) every record call returns at once and adds no work.

Whether the registry is enabled never decides whether a tap is installed:
the engines install theirs unconditionally, as the reference does, so the
registry's toggle changes no mask and no token.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

# Collector stack, LIFO, so nested taps (the engine's tap around a forward
# whose slot-wise link taps each row) compose.
_STACK: List["LinkTap"] = []

# The counter dict's keys: "decode_steps" is int32, the rest float32.
COUNTER_KEYS = (
    "decode_steps",
    "valid_tokens",
    "decode_read_bytes",
    "link_elems",
    "link_dropped",
    "fec_recovered_packets",
)


def _sum(items, device) -> torch.Tensor:
    """f32 sum of 0-d tensors and Python numbers on ``device``: the host
    numbers are summed on the host and added once (a fill when there is no
    tensor), so a frame of host counts costs one launch."""
    host = sum(v for v in items if not torch.is_tensor(v))
    tensors = [v for v in items if torch.is_tensor(v)]
    if not tensors:
        return torch.full((), float(host), dtype=torch.float32, device=device)
    total = tensors[0] if len(tensors) == 1 else torch.stack(tensors).sum()
    return total + float(host) if host else total


class LinkTap:
    """One collector frame: accumulates the link statistics drawn under it.
    Element counts are host numbers (a shape's size); dropped counts and
    FEC recoveries are 0-d device tensors."""

    __slots__ = ("elems", "dropped", "fec_recovered")

    def __init__(self) -> None:
        self.elems: list = []
        self.dropped: list = []
        self.fec_recovered: list = []

    def totals(self, device="cpu") -> Dict[str, torch.Tensor]:
        """The summed statistics as 0-d float32 tensors (zeros when nothing
        was drawn, e.g. ``link_mode="off"``), on the device of the recorded
        tensors, or ``device`` when none was recorded."""
        dev = next((v.device for v in self.dropped + self.fec_recovered if torch.is_tensor(v)),
                   torch.device(device))
        return {
            "elems": _sum(self.elems, dev),
            "dropped": _sum(self.dropped, dev),
            "fec_recovered": _sum(self.fec_recovered, dev),
        }


def tapping() -> bool:
    """True while a collector is installed."""
    return bool(_STACK)


@contextlib.contextmanager
def tap_link_stats():
    """Install a collector for the block; every link mask drawn inside
    records into it.  Read ``tap.totals()`` inside or after the block."""
    tap = LinkTap()
    _STACK.append(tap)
    try:
        yield tap
    finally:
        popped = _STACK.pop()
        assert popped is tap, "unbalanced obs.device collector stack"


def record_mask(mask: torch.Tensor) -> None:
    """Record one keep-mask draw (0/1 or bool, any shape): its element
    count and its dropped (zero) count.  No-op without a collector."""
    if not _STACK:
        return
    tap = _STACK[-1]
    n = float(mask.numel())
    tap.elems.append(n)
    tap.dropped.append(n - mask.sum(dtype=torch.float32))


def record_full_keep(num_elements: int) -> None:
    """Record a zero-loss shortcut (a mask of all ones, never drawn)."""
    if not _STACK:
        return
    _STACK[-1].elems.append(float(num_elements))


def record_fec_recovered(n_packets: torch.Tensor) -> None:
    """Record the data packets FEC decoding recovered (lost on the raw
    channel, rebuilt from parity)."""
    if not _STACK:
        return
    _STACK[-1].fec_recovered.append(n_packets.to(torch.float32))


def emit(totals: Dict[str, torch.Tensor]) -> None:
    """Re-publish summed statistics (a ``LinkTap.totals()`` dict, e.g. the
    live-weighted sum of per-slot taps) to the ambient collector."""
    if not _STACK:
        return
    tap = _STACK[-1]
    tap.elems.append(totals["elems"])
    tap.dropped.append(totals["dropped"])
    tap.fec_recovered.append(totals["fec_recovered"])


def emit_rows(taps: List[LinkTap], live=None, device="cpu") -> None:
    """``emit`` the taps of a batched step's rows (one a slot, each row's
    link drawn under its own frame), row ``i`` weighted by ``live[i]``
    ((B,) bool; every row when None): dead slots compute, but never count,
    as in the reference.  One stack and one weighted sum a statistic on
    ``device``, whatever the number of rows."""
    if not _STACK:
        return
    elems = {sum(t.elems) for t in taps}
    assert len(elems) == 1, f"rows of one step recorded different element counts: {sorted(elems)}"
    w = None if live is None else live.to(device=device, dtype=torch.float32)

    def rows(field: str) -> torch.Tensor:
        vals = [v for t in taps for v in getattr(t, field)]
        if not vals:
            return torch.zeros((), dtype=torch.float32, device=device)
        per_row = torch.stack(vals).view(len(taps), -1).sum(dim=1)
        return per_row.sum() if w is None else torch.dot(w, per_row)

    n = float(elems.pop())
    emit({"elems": n * len(taps) if w is None else n * w.sum(), "dropped": rows("dropped"),
          "fec_recovered": rows("fec_recovered")})


# ---------------------------------------------------------------------------
# DeviceCounters: the dict the engine state carries
# ---------------------------------------------------------------------------

def counter_zeros(device="cpu") -> Dict[str, torch.Tensor]:
    """A fresh ``obs.DeviceCounters`` dict (all zeros) on ``device``."""
    return {k: torch.zeros((), dtype=torch.int32 if k == "decode_steps" else torch.float32, device=device)
            for k in COUNTER_KEYS}


def counters_to_host(counters) -> Dict[str, float]:
    """The counter dict as host floats (one copy, at an existing sync
    point) plus the derived realized drop rate."""
    vals = torch.stack([counters[k].to(torch.float64) for k in COUNTER_KEYS]).cpu().tolist()
    host = dict(zip(COUNTER_KEYS, vals))
    host["realized_drop_rate"] = host["link_dropped"] / max(host["link_elems"], 1.0)
    return host
