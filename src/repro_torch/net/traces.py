"""Loss-trace recording and replay for ``TraceChannel``, the port's twin of
``repro/net/traces.py``.

A trace is a flat 0/1 int array (1 = packet delivered).  It can be recorded
from any ``Channel`` (a Gilbert–Elliott run frozen and replayed), loaded from
disk (``.npy`` or whitespace-separated text), or synthesised with a given
burst structure.
"""

from __future__ import annotations

import os
from typing import Union

import numpy as np

from repro_torch.net.channels import Channel, TraceChannel


def record_trace(channel: Channel, n_packets: int, seed: int = 0) -> np.ndarray:
    """Run ``channel`` statefully for ``n_packets`` and return its 0/1 keep
    trace."""
    rng = np.random.RandomState(seed)
    state = channel.init_state(rng)
    keep, _ = channel.step(rng, state, n_packets)
    return np.asarray(keep, dtype=np.int32)


def save_trace(path: str, trace: np.ndarray) -> None:
    trace = np.asarray(trace, dtype=np.int32).reshape(-1)
    if path.endswith(".npy"):
        np.save(path, trace)
    else:
        np.savetxt(path, trace[None], fmt="%d")


def load_trace(path: str) -> np.ndarray:
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    if path.endswith(".npy"):
        trace = np.load(path)
    else:
        trace = np.loadtxt(path)
    return np.asarray(trace, dtype=np.int32).reshape(-1)


def trace_channel(source: Union[str, np.ndarray]) -> TraceChannel:
    """A TraceChannel from a file path or an array."""
    trace = load_trace(source) if isinstance(source, str) else source
    return TraceChannel.from_array(trace)


def synthetic_burst_trace(n_packets: int, loss_rate: float, mean_burst: float = 5.0,
                          seed: int = 0) -> np.ndarray:
    """Alternating-renewal trace: geometric loss bursts of mean length
    ``mean_burst`` between geometric good runs sized to hit the target
    overall loss rate."""
    assert 0.0 <= loss_rate < 1.0
    rng = np.random.RandomState(seed)
    mean_good = mean_burst * (1.0 - loss_rate) / max(loss_rate, 1e-9)
    out = np.empty(n_packets, dtype=np.int32)
    i = 0
    good = rng.rand() >= loss_rate
    while i < n_packets:
        mean_len = mean_good if good else mean_burst
        run = 1 + rng.geometric(1.0 / max(mean_len, 1.0)) - 1
        run = max(1, int(run))
        j = min(n_packets, i + run)
        out[i:j] = 1 if good else 0
        i = j
        good = not good
    return out
