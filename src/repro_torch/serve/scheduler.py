"""SLA-aware scheduling over the ContinuousEngine slot/block pool (twin of
``repro/serve/scheduler.py``; host Python only).

The paper's setting is deadline-bounded inference over unreliable links.
Without a scheduler the engine serves every request best-effort FIFO, and
a full block pool blocks admission at the head of the line.  This module
puts a scheduler in front of the pool:

* **SLA classes** — each request may carry ``SLA(deadline_s, priority,
  class_name)``.  Higher ``priority`` wins; within a priority the earliest
  absolute deadline goes first (EDF-within-priority).
* **Preemption by recompute** — when a high-priority request cannot be
  admitted (no slot / not enough KV blocks), the scheduler evicts
  lower-priority in-flight slots: the victim's host-side record (rid,
  prompt, key, budget) is frozen, its slot is deadened on device and its
  blocks returned to the allocator, and it re-enters the ready queue to be
  re-admitted later through the normal bucketed-prefill path.  The whole
  keyed computation is deterministic in the request key, so a resumed run
  is token-identical to an uninterrupted one (tested under iid, GE and
  int8).  No KV snapshotting.
* **Early expiry** — a queued request that can no longer meet its deadline
  (deadline already passed, the per-token service-time EMA says the decode
  cannot fit, or a pluggable ``feasibility`` oracle — e.g.
  ``protocol_feasibility`` over the analytic latency PMFs — returns a
  probability at or below ``feasibility_floor``) is terminally ``expired``
  instead of burning decode steps.
* **Bounded retry with backoff** — a request that cannot be admitted and
  cannot preempt re-queues with exponential backoff; after ``max_retries``
  attempts it is terminally ``rejected`` (admission control: shed load
  instead of letting the queue grow without bound).

The scheduler is a pure **host** layer: it reads the engine's host
mirrors through the public API (``try_admit`` / ``preempt_slot`` /
``running_slots`` / ``free_block_count``) and never touches device state
or forces a sync (the reference's lint rule RPA007 holds its copy to
that; its suffix match does not reach this path, so review keeps this
one to it).  Because that surface is all it probes, the sharded router
(``serve.router.ShardedEngine``) fronts it unchanged: ``tick()``
sees one logical pool with globally-numbered slots, preemption forwards
to the owning shard, and a preempted request may resume on a different
shard (token-identical — the keyed math is placement-invariant).
All obs counters/gauges (``sched.preemptions``, ``sched.expired``,
``sched.resumes``, per-class ``sched.deadline_hit_rate.*``) are stamped
at the engine's existing sync points.

Time is pluggable: ``clock`` is any zero-arg callable.  The default is
``time.perf_counter``; benchmarks and CI use a ``VirtualClock`` advanced
deterministically by the workload driver (one fixed ``dt`` per engine
step), which makes deadline-hit-rate gating reproducible.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import math
import time
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch import obs


@dataclasses.dataclass(frozen=True)
class SLA:
    """Per-request service-level agreement.

    ``deadline_s`` is relative to submission (``math.inf`` = best effort);
    ``priority`` is an integer, larger wins; ``class_name`` buckets the
    per-class deadline-hit accounting ("interactive" / "batch" / ...).
    """

    deadline_s: float = math.inf
    priority: int = 0
    class_name: str = "default"


class VirtualClock:
    """Deterministic clock for virtual-time scheduling runs: the driver
    advances it explicitly (e.g. a fixed dt per engine step)."""

    def __init__(self, t0: float = 0.0):
        self.now = float(t0)

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> float:
        self.now += float(dt)
        return self.now


def protocol_feasibility(
    protocol, n_packets: int, channel_cfg, loss_rate=None,
) -> Callable[[object, float], float]:
    """Uplink-aware feasibility oracle for ``SLAScheduler(feasibility=...)``.

    Maps ``(request, remaining_s) -> P(the uplink could deliver the full
    message within the remaining deadline budget)`` via
    ``net.protocol.deadline_feasible``.  ``loss_rate`` may be a float or a
    zero-arg callable (e.g. chaos-schedule-driven, so a channel collapse
    makes queued requests exactly infeasible and the scheduler sheds them
    early instead of burning pool space on doomed work).
    """
    from repro_torch.net.protocol import deadline_feasible

    def fn(req, remaining_s: float) -> float:
        p = loss_rate() if callable(loss_rate) else loss_rate
        return deadline_feasible(
            protocol, n_packets, channel_cfg, remaining_s, loss_rate=p
        )

    return fn


_TERMINAL = ("completed", "expired", "rejected")


class SLAScheduler:
    """EDF-within-priority admission with preemption, expiry, and bounded
    retry over one ``ContinuousEngine``.  Attach with
    ``engine.attach_scheduler(sched)``; the engine then routes
    ``submit()`` into the scheduler's ready queue and calls ``tick()``
    once per step in place of FIFO admission.  ``tick`` hands the engine
    whatever the engine's ``step`` was given (the model).
    """

    def __init__(
        self,
        *,
        clock: Optional[Callable[[], float]] = None,
        preemption: bool = True,
        max_retries: int = 32,
        backoff_s: float = 0.05,
        backoff_mult: float = 2.0,
        backoff_cap_s: float = 2.0,
        feasibility: Optional[Callable[[object, float], float]] = None,
        feasibility_floor: float = 0.0,
        ema_alpha: float = 0.3,
    ):
        self.clock = clock or time.perf_counter
        self.preemption = preemption
        self.max_retries = max_retries
        self.backoff_s = backoff_s
        self.backoff_mult = backoff_mult
        self.backoff_cap_s = backoff_cap_s
        self.feasibility = feasibility
        self.feasibility_floor = feasibility_floor
        self.ema_alpha = ema_alpha
        self._ready: List = []
        self._retry: List[Tuple[float, int, object]] = []   # heap
        self._seq = itertools.count()
        self._admit_t: Dict[int, float] = {}
        self._tpot_ema = 0.0          # clock-units per generated token
        self.stats: Dict[str, int] = {
            "submitted": 0, "admitted": 0, "completed": 0,
            "preemptions": 0, "resumes": 0, "expired": 0,
            "rejected": 0, "retries": 0,
        }
        self._classes: Dict[str, Dict[str, int]] = {}

    # -- request intake ----------------------------------------------------

    def enqueue(self, req) -> None:
        """Called by ``engine.submit``: stamp the absolute deadline on the
        scheduler clock, shed immediately-hopeless requests, queue the
        rest for the next tick."""
        now = self.clock()
        sla = req.sla or SLA()
        req.t_deadline = now + sla.deadline_s
        self.stats["submitted"] += 1
        self._cls(req)["submitted"] += 1
        if self._hopeless(req, now):
            self._expire(req, now)
            return
        self._ready.append(req)

    @property
    def pending(self) -> bool:
        return bool(self._ready or self._retry)

    @property
    def queue_depth(self) -> int:
        return len(self._ready) + len(self._retry)

    # -- the admission tick ------------------------------------------------

    def tick(self, engine, params) -> None:
        """One admission pass: requeue due retries, expire the hopeless,
        admit EDF-within-priority, preempting lower-priority slots when
        that makes an admission possible, backing off the rest."""
        now = self.clock()
        while self._retry and self._retry[0][0] <= now:
            _, _, req = heapq.heappop(self._retry)
            self._ready.append(req)
        if not self._ready:
            return
        ready = sorted(self._ready, key=self._order)
        # Preemption victims land back in self._ready during the loop and
        # wait for the next tick (their resources just went to the
        # preemptor — re-admitting them now would thrash).
        self._ready = []
        for req in ready:
            if self._hopeless(req, now):
                self._expire(req, now)
                continue
            if engine.try_admit(params, req):
                self._note_admit(req, now)
                continue
            if (
                self.preemption
                and self._preempt_for(engine, req)
                and engine.try_admit(params, req)
            ):
                self._note_admit(req, now)
                continue
            # Resource-blocked and not worth a preemption: retry later.
            # The loop continues — a smaller or lower-priority request
            # behind this one may still fit (no head-of-line blocking).
            self._backoff(req, now)

    def on_complete(self, engine, req) -> None:
        """Called by the engine at its completion sync point (after its
        device synchronize): deadline-hit accounting and the
        service-time EMA the early-expiry estimate uses."""
        now = self.clock()
        t_admit = self._admit_t.pop(req.rid, None)
        if t_admit is not None:
            per_tok = max(now - t_admit, 0.0) / max(1, req.max_tokens)
            self._tpot_ema = (
                per_tok if self._tpot_ema == 0.0
                else (1.0 - self.ema_alpha) * self._tpot_ema
                + self.ema_alpha * per_tok
            )
        self.stats["completed"] += 1
        cls = self._cls(req)
        cls["completed"] += 1
        hit = now <= req.t_deadline
        if hit:
            cls["hits"] += 1
        reg = obs.registry()
        if reg.enabled:
            name = self._class_name(req)
            reg.counter("sched.completed").inc()
            if req.t_deadline != math.inf:
                reg.histogram(f"sched.deadline_slack_s.{name}").observe(
                    req.t_deadline - now
                )
            reg.gauge(f"sched.deadline_hit_rate.{name}").set(
                self._hit_rate(cls)
            )

    # -- reports -----------------------------------------------------------

    def class_report(self) -> Dict[str, Dict[str, float]]:
        """Per-class terminal accounting: ``deadline_hit_rate`` counts a
        hit only for on-time completions, over ALL terminally-resolved
        requests of the class (expired/rejected count as misses)."""
        out: Dict[str, Dict[str, float]] = {}
        for name, c in self._classes.items():
            row = dict(c)
            row["terminal"] = (
                c["completed"] + c["expired"] + c["rejected"]
            )
            row["deadline_hit_rate"] = self._hit_rate(c)
            out[name] = row
        return out

    # -- internals ---------------------------------------------------------

    @staticmethod
    def _sla(req) -> SLA:
        return req.sla or SLA()

    def _class_name(self, req) -> str:
        return self._sla(req).class_name

    def _cls(self, req) -> Dict[str, int]:
        name = self._class_name(req)
        if name not in self._classes:
            self._classes[name] = {
                "submitted": 0, "completed": 0, "hits": 0,
                "expired": 0, "rejected": 0, "preempted": 0,
            }
        return self._classes[name]

    @staticmethod
    def _hit_rate(c: Dict[str, int]) -> float:
        term = c["completed"] + c["expired"] + c["rejected"]
        return c["hits"] / term if term else 0.0

    def _order(self, req):
        return (-self._sla(req).priority, req.t_deadline, req.rid)

    def _hopeless(self, req, now: float) -> bool:
        if req.t_deadline == math.inf:
            return False
        remaining = req.t_deadline - now
        if remaining <= 0.0:
            return True
        if self._tpot_ema > 0.0 and \
                self._tpot_ema * req.max_tokens > remaining:
            return True
        if self.feasibility is not None and \
                self.feasibility(req, remaining) <= self.feasibility_floor:
            return True
        return False

    def _note_admit(self, req, now: float) -> None:
        self._admit_t[req.rid] = now
        self.stats["admitted"] += 1
        if req.n_preempts > 0:
            self.stats["resumes"] += 1
            obs.registry().counter("sched.resumes").inc()

    def _preempt_for(self, engine, req) -> bool:
        """Evict enough strictly-lower-priority running slots to make
        ``req`` admissible.  All-or-nothing: if even preempting every
        eligible victim could not free enough, nothing is evicted."""
        pool = engine.pool
        pri = self._sla(req).priority
        victims = [
            (slot, vr) for slot, vr in engine.running_slots()
            if self._sla(vr).priority < pri
        ]
        if not victims:
            return False
        need_blocks = (
            engine.blocks_needed(req.prompt.size, req.max_tokens)
            if pool.paged else 0
        )
        have_slot = engine.free_slot_count > 0
        have_blocks = engine.free_block_count() if pool.paged else 0

        def satisfied() -> bool:
            return have_slot and (
                not pool.paged or have_blocks >= need_blocks
            )

        if pool.paged:
            attainable = have_blocks + sum(
                engine.blocks_held(s) for s, _ in victims
            )
            if attainable < need_blocks:
                return False
        # Cheapest victims first: lowest priority, and within a priority
        # the latest deadline (best-effort requests before tight ones).
        victims.sort(
            key=lambda sv: (self._sla(sv[1]).priority, -sv[1].t_deadline)
        )
        took = False
        for slot, vr in victims:
            if satisfied():
                break
            if pool.paged:
                have_blocks += engine.blocks_held(slot)
            engine.preempt_slot(slot)
            have_slot = True
            took = True
            self._ready.append(vr)
            self.stats["preemptions"] += 1
            self._cls(vr)["preempted"] += 1
            obs.registry().counter("sched.preemptions").inc()
        return took

    def _backoff(self, req, now: float) -> None:
        req.retries += 1
        self.stats["retries"] += 1
        if req.retries > self.max_retries:
            self._reject(req, now)
            return
        delay = min(
            self.backoff_s * self.backoff_mult ** (req.retries - 1),
            self.backoff_cap_s,
        )
        heapq.heappush(self._retry, (now + delay, next(self._seq), req))

    def _expire(self, req, now: float) -> None:
        req.state = "expired"
        self.stats["expired"] += 1
        self._cls(req)["expired"] += 1
        reg = obs.registry()
        reg.counter("sched.expired").inc()
        if reg.enabled and req.t_deadline != math.inf:
            name = self._class_name(req)
            reg.histogram(f"sched.deadline_slack_s.{name}").observe(
                req.t_deadline - now
            )
            reg.gauge(f"sched.deadline_hit_rate.{name}").set(
                self._hit_rate(self._cls(req))
            )

    def _reject(self, req, now: float) -> None:
        req.state = "rejected"
        self.stats["rejected"] += 1
        self._cls(req)["rejected"] += 1
        reg = obs.registry()
        reg.counter("sched.rejected").inc()
        if reg.enabled:
            reg.gauge(
                f"sched.deadline_hit_rate.{self._class_name(req)}"
            ).set(self._hit_rate(self._cls(req)))
