"""Sharded serving: one logical slot pool over several engine shards (twin
of ``repro/serve/router.py``).

* one ``ContinuousEngine(device=dev)`` a shard, each with its own slot or
  block pool, placed from a list of torch devices.  ``sharded_engine``
  wraps ``num_shards`` around the visible cards, so on one H100 every shard
  sits on ``cuda:0``; the tests repeat ``"cpu"``.  A shard on the model's
  own device uses the caller's model as it is; a shard on another device
  takes one cached copy, made again when the caller passes another model
  or updates its weights in place (``ShardedEngine.model_on``);
* a host-side **occupancy-aware router** that places each admission on
  the shard with the most free capacity: among the shards that can admit
  the request at all (a free slot and, paged, enough free blocks), the one
  maximizing ``(free_slots, free_blocks, -shard_idx)``, so placement is
  deterministic;
* the **engine surface** of one pool (``submit`` / ``try_admit`` /
  ``preempt_slot`` / ``running_slots`` / ``free_slot_count`` /
  ``free_block_count`` / ``blocks_held`` / ``blocks_needed`` / ``step`` /
  ``run``), slots numbered globally (``gslot = shard_idx * max_slots +
  local_slot``), so an ``SLAScheduler`` probes the router as it probes one
  engine: preemption picks a global slot, the router forwards it to the
  owning shard, and the freed request may resume on another shard,
  token-identical, since every request runs the same keyed batch-1 math
  whichever shard admits it.

Aggregates where one pool's scalar has no exact multi-pool meaning:
``free_slot_count`` sums over shards (a request needs one slot on any
shard); ``free_block_count()`` is the best single shard's (one admission
lands on one shard); ``PoolExhausted``'s fields sum over shards.

A pure host layer over the engines: host mirrors and the public engine
API only, no device read (the reference's lint rule RPA007 holds its copy
to that; review keeps this one to it).  ``mesh=`` (a ``launch.mesh.Mesh``)
places one shard a device of its data axis (``sharding.rules.
pool_shard_devices``), and refuses a ``model`` axis wider than 1, as the
reference does.
"""

from __future__ import annotations

import collections
import copy
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import canonical_device
from repro_torch.serve.continuous import ContinuousEngine, PoolConfig, PoolExhausted, Request, build_request
from repro_torch.serve.scheduler import SLA
from repro_torch.sharding.rules import pool_shard_devices


def _same_device(a, b) -> bool:
    return canonical_device(a) == canonical_device(b)


def shard_devices(num_shards: int = 0, device="cuda") -> List[torch.device]:
    """``num_shards`` devices wrapped around the visible cards (one shard a
    card when 0); on the CPU, ``num_shards`` (at least 1) times ``cpu``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return [dev] * max(num_shards, 1)
    cards = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if not cards:
        raise RuntimeError("no CUDA device: pass device='cpu' to shard on the CPU")
    return [cards[i % len(cards)] for i in range(num_shards or len(cards))]


class ShardedEngine:
    """Occupancy-routed fleet of ``ContinuousEngine`` shards, one a device
    of ``devices`` (which may repeat a device; None: one a device of
    ``mesh``'s data axis, else one a card)."""

    def __init__(self, cfg: ModelConfig, pool: Optional[PoolConfig] = None, *,
                 devices: Optional[Sequence] = None, mesh=None):
        if devices is None and mesh is not None:
            devices = pool_shard_devices(mesh)
        devices = [torch.device(d) for d in (shard_devices() if devices is None else devices)]
        if not devices:
            raise ValueError("ShardedEngine: empty device list")
        self.pool = pool or PoolConfig()
        self.shards: List[ContinuousEngine] = [ContinuousEngine(cfg, self.pool, device=d) for d in devices]
        self.cfg = cfg
        self.devices = devices
        self.num_shards = len(devices)
        # The router's FIFO queue and rid namespace (the shards' queues stay
        # empty: the router admits through try_admit, so placement is its).
        self._queue: collections.deque = collections.deque()
        self._rid = 0
        self.scheduler = None
        self._stalled_steps = 0
        # Admissions a shard, and each rid's placement history (a resumed
        # request appends again).
        self.placement_counts: List[int] = [0] * self.num_shards
        self.placements: Dict[int, List[int]] = {}
        # Copies of the caller's model for shards off its device: the source
        # (held weakly, compared by identity), its weights' versions, and
        # one copy a device.
        self._copy_src = None
        self._copy_versions: Optional[tuple] = None
        self._copies: Dict[str, object] = {}
        for sh in self.shards:
            # Each shard's completions reach the router's scheduler (and
            # gauges) at the shard's completion sync, without the shard
            # ticking a scheduler itself.
            sh.completion_sink = self

    def model_on(self, model, device):
        """``model`` as a shard on ``device`` runs it: the caller's own on its
        own device; elsewhere one copy a device, made on first use and made
        again when the caller passes another model or changes a weight in
        place (a parameter's version counter moves)."""
        if _same_device(model.embed.device, device):
            return model
        versions = tuple(t._version for t in model.state_dict(keep_vars=True).values())
        if self._copy_src is None or self._copy_src() is not model or versions != self._copy_versions:
            self._copy_src, self._copy_versions, self._copies = weakref.ref(model), versions, {}
        key = str(canonical_device(device))
        if key not in self._copies:
            self._copies[key] = copy.deepcopy(model).to(device)
        return self._copies[key]

    # -- aggregate occupancy (the scheduler's probes) ----------------------

    @property
    def active(self) -> int:
        return sum(sh.active for sh in self.shards)

    @property
    def free_slot_count(self) -> int:
        """Free slots over all shards (one is enough to admit)."""
        return sum(sh.free_slot_count for sh in self.shards)

    def free_block_count(self) -> int:
        """Free blocks on the best single shard: one admission lands on one
        shard.  The scheduler's all-or-nothing preemption estimate adds
        victims' blocks across shards to this, which can overestimate what
        one shard can reach; the result is a wasted preemption round and a
        backoff, never a wrong admission (``try_admit`` checks the shard's
        own allocator)."""
        return max(sh.free_block_count() for sh in self.shards)

    @property
    def queue_depth(self) -> int:
        if self.scheduler is not None:
            return self.scheduler.queue_depth
        return len(self._queue)

    @property
    def num_buckets(self) -> int:
        return max(sh.num_buckets for sh in self.shards)

    # -- global slot numbering ---------------------------------------------

    def _locate(self, gslot: int) -> Tuple[int, int]:
        shard_idx, local = divmod(int(gslot), self.pool.max_slots)
        if not 0 <= shard_idx < self.num_shards:
            raise IndexError(f"global slot {gslot} out of range for {self.num_shards} shard(s) x "
                             f"{self.pool.max_slots} slots")
        return shard_idx, local

    def running_slots(self) -> List[Tuple[int, Request]]:
        """(global slot, request) over every shard: the preemption
        candidates, ``gslot = shard_idx * max_slots + local_slot``."""
        out: List[Tuple[int, Request]] = []
        for i, sh in enumerate(self.shards):
            base = i * self.pool.max_slots
            out.extend((base + slot, req) for slot, req in sh.running_slots())
        return out

    def blocks_held(self, gslot: int) -> int:
        shard_idx, local = self._locate(gslot)
        return self.shards[shard_idx].blocks_held(local)

    def blocks_needed(self, prompt_len: int, max_tokens: int) -> int:
        return self.shards[0].blocks_needed(prompt_len, max_tokens)     # every shard has the same pool

    def preempt_slot(self, gslot: int) -> Request:
        """Evict the request on a global slot; its re-admission goes through
        placement again, so it may resume on another shard."""
        shard_idx, local = self._locate(gslot)
        req = self.shards[shard_idx].preempt_slot(local)
        self._publish_router_gauges()
        return req

    # -- intake and placement ------------------------------------------------

    def attach_scheduler(self, sched) -> None:
        """Install an SLA scheduler in front of the router (it probes the
        router, never a shard); before any traffic."""
        if self._queue or self.active:
            raise RuntimeError("attach the scheduler before submitting traffic")
        self.scheduler = sched

    def submit(self, prompt, max_tokens: int, key: Optional[torch.Tensor] = None,
               sla: Optional[SLA] = None) -> Request:
        """Queue one request; returns its handle (filled in by ``run``)."""
        req = build_request(self, self._rid, prompt, max_tokens, key, sla)
        self._rid += 1
        if self.scheduler is not None:
            self.scheduler.enqueue(req)
        else:
            self._queue.append(req)
        obs.registry().counter("serve.requests_submitted").inc()
        return req

    def _place(self, req: Request) -> Optional[int]:
        """Among the shards that can admit ``req`` now, the one maximizing
        ``(free_slots, free_blocks, -idx)``; None when none can."""
        need = self.blocks_needed(req.prompt.size, req.max_tokens) if self.pool.paged else 0
        best = best_key = None
        for i, sh in enumerate(self.shards):
            if sh.free_slot_count <= 0:
                continue
            blocks = sh.free_block_count() if self.pool.paged else 0
            if self.pool.paged and blocks < need:
                continue
            k = (sh.free_slot_count, blocks, -i)
            if best_key is None or k > best_key:
                best, best_key = i, k
        return best

    def try_admit(self, model, req: Request) -> bool:
        """Place and admit one request; False (no side effects) when no
        shard has the capacity."""
        idx = self._place(req)
        if idx is None:
            return False
        sh = self.shards[idx]
        if not sh.try_admit(self.model_on(model, sh.device), req):
            # _place read the same occupancy try_admit checks, with no
            # admission in between.
            raise AssertionError(f"shard {idx} refused an admission its occupancy allowed")
        self.placement_counts[idx] += 1
        self.placements.setdefault(req.rid, []).append(idx)
        reg = obs.registry()
        reg.counter("router.placements").inc()
        reg.counter(f"router.placements.shard{idx}").inc()
        self._publish_router_gauges()
        return True

    def shard_of(self, req: Request) -> Optional[int]:
        """The shard hosting (or last hosting) ``req``; None before its
        first admission."""
        hist = self.placements.get(req.rid)
        return hist[-1] if hist else None

    # -- driving ------------------------------------------------------------

    def _admit(self, model) -> None:
        # FIFO: strict arrival order, the head probing every shard.
        while self._queue and self.try_admit(model, self._queue[0]):
            self._queue.popleft()

    def step(self, model) -> None:
        """One router tick: admission (the scheduler's tick when attached,
        FIFO otherwise), then one step of every shard with live slots."""
        if self.scheduler is not None:
            self.scheduler.tick(self, model)
        else:
            self._admit(model)
        if self.active:
            self._stalled_steps = 0
            for sh in self.shards:
                if sh.active:
                    sh.step(self.model_on(model, sh.device))
        elif self.scheduler is None and self._queue:
            self._stalled_steps += 1
            if self._stalled_steps > self.pool.exhaust_wait_steps:
                waited, self._stalled_steps = self._stalled_steps, 0
                head = self._queue[0]
                raise PoolExhausted(
                    waited_steps=waited, queued=len(self._queue), free_slots=self.free_slot_count,
                    free_blocks=sum(sh.free_block_count() for sh in self.shards),
                    need_blocks=self.blocks_needed(head.prompt.size, head.max_tokens) if self.pool.paged else 0)
        else:
            self._stalled_steps = 0

    def run(self, model) -> List[Request]:
        """Drive until the queue and every shard are empty; returns every
        request finished since the last run, merged over the shards in
        completion order (ties by rid)."""
        reg = obs.registry()
        with reg.span("router.run", queued=len(self._queue), shards=self.num_shards):
            while self._queue or self.active or (self.scheduler is not None and self.scheduler.pending):
                self.step(model)
            done: List[Request] = []
            for sh in self.shards:
                done.extend(sh.take_finished())
            done.sort(key=lambda r: (r.t_done, r.rid))
        if reg.enabled:
            self._publish_router_gauges()
            self.publish_device_counters(reg)
        return done

    def harvest(self) -> None:
        """Read every shard's finished outputs to the host."""
        for sh in self.shards:
            sh.harvest()

    def on_complete(self, engine, req: Request) -> None:
        """A shard's completion sink: the scheduler's accounting, then the
        occupancy gauges (the shard just freed capacity)."""
        if self.scheduler is not None:
            self.scheduler.on_complete(engine, req)
        self._publish_router_gauges()

    # -- observability ------------------------------------------------------

    def _publish_router_gauges(self) -> None:
        """Each shard's occupancy and the router's queue depth, from the
        host mirrors."""
        reg = obs.registry()
        if not reg.enabled:
            return
        reg.gauge("router.queue_depth").set(float(self.queue_depth))
        for i, sh in enumerate(self.shards):
            reg.gauge(f"serve.shard_free_slots.{i}").set(float(sh.free_slot_count))
            reg.gauge(f"serve.shard_free_blocks.{i}").set(float(sh.free_block_count()))

    def device_counters(self) -> Dict[str, float]:
        """The shards' device counters summed, the realized drop rate
        derived again from the summed link totals (rates do not sum).  One
        sync a shard: call at run boundaries."""
        total: Dict[str, float] = {}
        for sh in self.shards:
            for k, v in sh.device_counters().items():
                total[k] = total.get(k, 0.0) + v
        total["realized_drop_rate"] = total.get("link_dropped", 0.0) / max(total.get("link_elems", 0.0), 1.0)
        return total

    def publish_device_counters(self, reg=None) -> Dict[str, float]:
        reg = reg or obs.registry()
        host = self.device_counters()
        for k, v in host.items():
            reg.gauge(f"serve.device.{k}").set(v)
        return host

    def stats(self) -> Dict[str, float]:
        """Aggregate and per-shard counters, flat (``shard{i}.*``)."""
        out: Dict[str, float] = {
            "num_shards": float(self.num_shards),
            "num_buckets": float(self.num_buckets),
            "tokens_generated": float(sum(sh.tokens_generated for sh in self.shards)),
            "steps": float(sum(sh.steps for sh in self.shards)),
        }
        for i, sh in enumerate(self.shards):
            out[f"shard{i}.num_buckets"] = float(sh.num_buckets)
            out[f"shard{i}.tokens_generated"] = float(sh.tokens_generated)
            out[f"shard{i}.placements"] = float(self.placement_counts[i])
        return out

    # -- one-shot batch API ---------------------------------------------------

    def generate_batch(self, model, prompts, num_tokens: int, *, key: Optional[torch.Tensor] = None):
        """Serve a same-length batch as B independent requests keyed
        ``fold_in(key, i)``: per request, the tokens equal
        ``generate_reference(prompts[i:i+1], key=fold_in(key, i))`` whichever
        shard serves it.  Returns ((B, num_tokens) int32 on the first
        shard's device, timings)."""
        key = key if key is not None else prng.PRNGKey(0)
        prompts = prompts.cpu().numpy() if torch.is_tensor(prompts) else np.asarray(prompts)
        reqs = [self.submit(prompts[i], num_tokens, key=prng.fold_in(key, i)) for i in range(prompts.shape[0])]
        t0 = time.perf_counter()
        self.run(model)
        t_total = max(time.perf_counter() - t0, 1e-9)
        tokens = torch.from_numpy(np.stack([r.tokens for r in reqs]).astype(np.int32)).to(self.devices[0])
        timings = {
            "generate_s": t_total,
            "decode_s_per_token": t_total / max(1, num_tokens),
            "tokens_per_s": (len(reqs) * num_tokens) / t_total,
            "num_shards": float(self.num_shards),
        }
        return tokens, timings


# ---------------------------------------------------------------------------
# Process-wide router registry
# ---------------------------------------------------------------------------

_ROUTERS: Dict[Tuple, ShardedEngine] = {}
_MAX_ROUTERS = 2      # each router holds num_shards device pools


def sharded_engine(cfg: ModelConfig, pool: Optional[PoolConfig] = None, *, num_shards: int = 0,
                   device="cuda") -> ShardedEngine:
    """Router per (cfg, pool, num_shards, device), kept in a small LRU so the
    pools survive across callers.  ``num_shards=0`` puts one shard on each
    visible card; more shards than cards wrap around them (several pools a
    card)."""
    pool = pool or PoolConfig()
    k = (cfg, pool, num_shards, str(torch.device(device)))
    if k in _ROUTERS:
        _ROUTERS[k] = _ROUTERS.pop(k)          # refresh the LRU position
        return _ROUTERS[k]
    while len(_ROUTERS) >= _MAX_ROUTERS:
        _ROUTERS.pop(next(iter(_ROUTERS)))
    _ROUTERS[k] = ShardedEngine(cfg, pool, devices=shard_devices(num_shards, device))
    return _ROUTERS[k]


def clear_routers() -> None:
    _ROUTERS.clear()
