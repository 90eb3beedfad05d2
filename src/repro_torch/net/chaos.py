"""Chaos fault injection, the port's twin of ``repro/net/chaos.py``.

Scripted faults that compose with any channel, protocol and engine:

* ``channel_collapse(t0, t1, loss_rate=1.0)``: the uplink loss rate is
  overridden inside the window; the simulator draws the window's masks from
  an i.i.d. overlay and leaves the client's real channel state where it was;
* ``server_stall(t, dur)``: a batch started inside the window pays the rest
  of the stall on top of its compute;
* ``burst_storm(t0, t1, rate_multiplier)``: every client's Poisson arrival
  rate is multiplied inside the window;
* ``block_pool_squeeze(t0, t1, fraction)``: that fraction of the paged
  engine's allocatable KV blocks is taken from the host allocator for the
  window (free blocks only, as they appear), and given back after.

``ChaosSchedule`` answers point-in-time queries; ``run_sim(chaos=...)``
injects collapse, stall and storm into the event flow
(``net/simulator.py``); ``EngineChaos`` applies the squeeze to a live
``serve.continuous.ContinuousEngine`` between steps, moving blocks between
its ``_free_blocks`` and a hold list (the host allocator only).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

FAULT_KINDS = (
    "channel_collapse", "server_stall", "burst_storm", "block_pool_squeeze",
)


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault: ``kind`` active over ``[t0, t1)``."""

    kind: str
    t0: float
    t1: float
    loss_rate: float = 1.0        # channel_collapse
    rate_multiplier: float = 1.0  # burst_storm
    fraction: float = 0.5         # block_pool_squeeze

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r}; one of {FAULT_KINDS}"
            )
        if not self.t1 > self.t0:
            raise ValueError(f"empty fault window [{self.t0}, {self.t1})")

    def active(self, t: float) -> bool:
        return self.t0 <= t < self.t1


def channel_collapse(t0: float, t1: float, loss_rate: float = 1.0) -> Fault:
    return Fault("channel_collapse", t0, t1,
                 loss_rate=min(max(float(loss_rate), 0.0), 1.0))


def server_stall(t: float, duration_s: float) -> Fault:
    return Fault("server_stall", t, t + duration_s)


def burst_storm(t0: float, t1: float, rate_multiplier: float = 5.0) -> Fault:
    if rate_multiplier < 1.0:
        raise ValueError("burst_storm multiplies the arrival rate (>= 1)")
    return Fault("burst_storm", t0, t1, rate_multiplier=rate_multiplier)


def block_pool_squeeze(t0: float, t1: float, fraction: float = 0.5) -> Fault:
    if not 0.0 < fraction <= 1.0:
        raise ValueError("squeeze fraction must be in (0, 1]")
    return Fault("block_pool_squeeze", t0, t1, fraction=fraction)


class ChaosSchedule:
    """Immutable set of scheduled faults with point-in-time queries."""

    def __init__(self, faults: Sequence[Fault] = ()):
        self.faults: Tuple[Fault, ...] = tuple(
            sorted(faults, key=lambda f: (f.t0, f.t1))
        )

    def __bool__(self) -> bool:
        return bool(self.faults)

    def active(self, t: float, kind: Optional[str] = None) -> List[Fault]:
        return [f for f in self.faults
                if f.active(t) and (kind is None or f.kind == kind)]

    def loss_override(self, t: float) -> Optional[float]:
        """Collapse loss rate at ``t`` (worst active window), else None."""
        rates = [f.loss_rate for f in self.active(t, "channel_collapse")]
        return max(rates) if rates else None

    def stall_until(self, t: float) -> float:
        """End of the latest server-stall window covering ``t`` (<= ``t``
        when no stall is active)."""
        ends = [f.t1 for f in self.active(t, "server_stall")]
        return max(ends) if ends else t

    def storm_multiplier(self, t: float) -> float:
        mults = [f.rate_multiplier for f in self.active(t, "burst_storm")]
        return max(mults) if mults else 1.0

    def squeeze_fraction(self, t: float) -> float:
        fracs = [f.fraction for f in self.active(t, "block_pool_squeeze")]
        return max(fracs) if fracs else 0.0

    def storms(self) -> List[Fault]:
        return [f for f in self.faults if f.kind == "burst_storm"]


class _OverrideChannel:
    """Memoryless overlay channel a collapse window substitutes for the
    client's real channel: i.i.d. drops at the override rate, state is a
    pass-through (the real channel's burst state must not advance)."""

    def __init__(self, loss_rate: float):
        self.loss_rate = float(loss_rate)

    @property
    def stationary_loss_rate(self) -> float:
        return self.loss_rate

    def init_state(self, rng: np.random.RandomState):
        return None

    def step(self, rng: np.random.RandomState, state, n_packets: int):
        keep = rng.random_sample(n_packets) >= self.loss_rate
        return keep, state


class EngineChaos:
    """Applies pool-level faults to a live ``ContinuousEngine``, or to a
    sharded ``serve.router.ShardedEngine`` (any engine with a ``shards``
    list), where the squeeze hits every shard's allocator at the scheduled
    fraction and the router's placement steers admissions to the shards
    with free blocks left.

    Call ``apply(now)`` between engine steps.  Only the host-side block
    allocator is touched: blocks move between ``engine._free_blocks`` and
    the hold list, like a co-tenant request that never completes.
    """

    def __init__(self, engine, schedule: ChaosSchedule):
        self.engine = engine
        self.schedule = schedule
        # A router is a fleet: one sub-harness per shard so each shard's
        # hold list tracks its own allocator.
        shards = getattr(engine, "shards", None)
        self._sub: List["EngineChaos"] = [
            EngineChaos(sh, schedule) for sh in shards
        ] if shards is not None else []
        self._held: List[int] = []

    @property
    def held_blocks(self) -> int:
        if self._sub:
            return sum(s.held_blocks for s in self._sub)
        return len(self._held)

    def apply(self, now: float) -> None:
        if self._sub:
            for s in self._sub:
                s.apply(now)
            return
        eng = self.engine
        if not eng.pool.paged:
            return
        frac = self.schedule.squeeze_fraction(now)
        allocatable = eng.pool.total_blocks - 1      # minus the trash block
        target = int(round(frac * allocatable))
        if target > len(self._held):
            # Build pressure: steal FREE blocks only (live slots keep
            # theirs), up to the target as retirements release them.
            take = min(target - len(self._held), len(eng._free_blocks))
            for _ in range(take):
                self._held.append(eng._free_blocks.pop())
        elif target < len(self._held):
            # Window over (or easing): give blocks back, LIFO like a
            # retiring request so the allocator's reuse order is preserved.
            while len(self._held) > target:
                eng._free_blocks.append(self._held.pop())

    def release_all(self) -> None:
        for s in self._sub:
            s.release_all()
        while self._held:
            self.engine._free_blocks.append(self._held.pop())
