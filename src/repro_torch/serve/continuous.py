"""Continuous-batching serve engine: slot pool + bucketed prefill (twin of
``repro/serve/continuous.py``).

* A persistent **slot pool**: ``max_slots`` independent batch-1 decode
  states (``models.cache.init_slot_pool``) plus per-slot tensors (current
  token, cache length, RNG key chain, generated-token count, budget, output
  row), all on the device across requests.
* A **bucketed prefill** per admission: the prompt padded to a power-of-two
  bucket runs through the device -> link -> server stack into a fresh
  batch-1 cache, the first token is taken at the request's *true* last
  position, and the cache is copied into a free slot.
* ONE **decode step** over all slots: one batched forward with per-slot
  lengths (so per-slot ``n_valid`` in the flash-decode kernel), per-slot
  keys and per-slot link rounds (``lm.make_slotwise_link_fn``).  The
  reference vmaps a batch-1 step; the port writes the slot axis out as the
  batch, since in-place cache writes and a ctypes kernel do not vmap.  So
  that an MoE layer's capacity couples no slots, as under the vmap, the
  contiguous step routes each slot as its own group; the reference's paged
  step is one batched forward over all slots, dead ones included, and the
  port's routes them jointly as it does.  Requests join and retire
  between steps; only slot *data* changes.

Paged mode (``PoolConfig(paged=True)``) swaps the per-slot caches for a
shared block pool (``models.cache.init_block_pool``) with per-slot block
tables: admission reserves only the blocks a request can touch, copies
just the prompt's blocks, and decode runs the paged flash-decode kernel
through a ``PagedIndex``.  A host-side LIFO allocator owns the blocks;
block 0 is the trash block dead slots write to.

Exactness.  Each slot runs the math of a batch-1 ``generate_reference``
run: the prefill's link is the streamed per-position round (invariant to
right padding), causal attention hides padded positions, and the per-slot
key chain reproduces the reference's ``key, sub = split(key)`` sequence.
Greedy outputs equal ``generate_reference(prompt[None], key=request_key)``
token for token (``tests/test_torch_continuous_serve.py``).

Retired slots keep stepping: their scalar state is live-masked, and their
cache writes land where nothing reads before the next admission rewrites
the slot (contiguous) or in the trash block (paged).

Models with recurrent layers (Mamba, xLSTM), and models whose sliding
windows are shorter than the largest bucket, use exact-length buckets:
right padding would run through the recurrent state or evict real rows
from the rotating cache.  A one-token prompt then prefills through the
recurrent layers' decode step, as the reference's does.

Sampling (``PoolConfig(greedy=False)``) follows the reference: the prefill
splits the request key once more for its first token, and each decode
round splits a slot's key in three (the third samples), so per request the
tokens equal the reference engine's.  An attached ``SLAScheduler``
(``serve.scheduler``) takes over admission; a ``completion_sink`` hears
every completion.

Observability.  The state carries ``obs`` device counters
(``obs.DeviceCounters``: decode steps, valid tokens, analytic decode read
bytes, link elements, drops and FEC recoveries), added on the device in
every prefill and step under link taps installed whether or not the
registry is enabled; ``device_counters()`` reads them at a sync point.
With the registry enabled, each harvested request emits its
submit -> retire span chain and TTFT / TPOT / e2e histograms, and the paged
pool publishes its occupancy gauges.
"""

from __future__ import annotations

import collections
import dataclasses
import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import obs, prng
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.runtime import resolve_device, synchronize
from repro_torch.launch.steps import temperature_scale
from repro_torch.models import cache as cache_lib, lm, rope as rope_lib
from repro_torch.models.attention import PagedIndex
from repro_torch.obs import device as obs_device
from repro_torch.obs.stats import latency_summary
from repro_torch.serve.scheduler import SLA


def pow2_bucket(n: int, floor: int = 8) -> int:
    b = max(floor, 1)
    while b < n:
        b *= 2
    return b


def padding_safe(cfg: ModelConfig, max_bucket: int) -> bool:
    """True when right-padding a prompt to ``max_bucket`` cannot change the
    real positions' outputs or decode state: attention-only stacks whose
    sliding windows, if any, are at least as long as the largest bucket."""
    for s in cfg.all_layers():
        if s.kind != "attn":
            return False
        if s.window and s.window < max_bucket:
            return False
    return True


# Consecutive no-progress steps (queue non-empty, nothing live, nothing
# admissible) tolerated by default before PoolExhausted is raised.
EXHAUST_WAIT_STEPS = 1000


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Static shape of one slot pool.

    ``paged=True`` switches the decode state from ``max_slots`` contiguous
    ``max_seq``-row caches to a shared pool of ``num_blocks`` x
    ``block_size`` KV rows with per-slot block tables; admission reserves
    ``ceil(min(max(bucket, prompt + max_tokens), max_seq) / block_size)``
    blocks.  ``num_blocks=0`` derives the worst-case-equivalent pool
    (``max_slots * blocks_per_slot`` + the trash block).  With no
    scheduler attached, ``exhaust_wait_steps`` consecutive no-progress
    steps raise ``PoolExhausted``.
    """

    max_slots: int = 8
    max_new: int = 64            # per-request generation budget ceiling
    max_prompt: int = 128        # longest admissible prompt
    min_bucket: int = 8          # smallest prefill bucket (power-of-two grid)
    greedy: bool = True
    temperature: float = 1.0     # sampling only (greedy=False)
    paged: bool = False
    block_size: int = 16         # KV rows per pool block (paged only)
    num_blocks: int = 0          # physical blocks incl. trash; 0 = derive
    exhaust_wait_steps: int = EXHAUST_WAIT_STEPS

    @property
    def max_bucket(self) -> int:
        return pow2_bucket(self.max_prompt, self.min_bucket)

    @property
    def max_seq(self) -> int:
        return self.max_bucket + self.max_new

    @property
    def blocks_per_slot(self) -> int:
        """Block-table row width: blocks a worst-case request reserves."""
        return -(-self.max_seq // self.block_size)

    @property
    def total_blocks(self) -> int:
        if self.num_blocks:
            return self.num_blocks
        return self.max_slots * self.blocks_per_slot + 1


@dataclasses.dataclass
class Request:
    """One generation request and its timestamps (host clock; the
    admission and completion stamps follow a device synchronize)."""

    rid: int
    prompt: np.ndarray            # (S,) int32
    max_tokens: int
    key: torch.Tensor             # (2,) -- the per-request key chain
    tokens: Optional[np.ndarray] = None   # (max_tokens,) int32 when done
    bucket: int = 0               # prefill bucket the prompt was padded to
    t_submit: float = 0.0
    t_admit: float = 0.0          # a slot was picked (before prefill)
    t_first_token: float = 0.0    # the prefill produced the first token
    t_done: float = 0.0           # the last decode round completed
    t_retire: float = 0.0         # output harvested to the host
    # SLA scheduling (serve.scheduler); the defaults are best effort.
    sla: Optional[SLA] = None
    state: str = "queued"         # queued | running | completed | expired | rejected
    n_preempts: int = 0           # times evicted mid-flight (recompute on resume)
    retries: int = 0              # admission attempts that hit backoff
    t_deadline: float = math.inf  # absolute, on the scheduler's clock

    @property
    def done(self) -> bool:
        return self.tokens is not None

    @property
    def terminal(self) -> bool:
        """Resolved for good: the scheduler never touches it again."""
        return self.state in ("completed", "expired", "rejected")

    @property
    def ttft_s(self) -> float:
        """Time to first token, from submission (includes queue wait)."""
        return self.t_first_token - self.t_submit

    @property
    def tpot_s(self) -> float:
        """Mean time per output token after the first (which comes from
        the prefill)."""
        return (self.t_done - self.t_first_token) / max(1, self.max_tokens - 1)

    @property
    def e2e_s(self) -> float:
        return self.t_done - self.t_submit


class PoolExhausted(RuntimeError):
    """With no scheduler attached, the engine waited
    ``PoolConfig.exhaust_wait_steps`` steps with queued work, no live slot
    and nothing admissible; the caller must shed load or free capacity.
    The wait budget re-arms after the raise."""

    def __init__(self, *, waited_steps: int, queued: int, free_slots: int, free_blocks: int,
                 need_blocks: int):
        self.waited_steps = waited_steps
        self.queued = queued
        self.free_slots = free_slots
        self.free_blocks = free_blocks
        self.need_blocks = need_blocks
        super().__init__(
            f"admission stalled for {waited_steps} steps: {queued} queued, {free_slots} free slots, "
            f"{free_blocks} free blocks (head needs {need_blocks}); install an SLAScheduler for "
            "preemption and shedding, or free pool capacity")


def build_request(eng, rid: int, prompt, max_tokens: int, key: Optional[torch.Tensor] = None,
                  sla: Optional[SLA] = None) -> Request:
    """Validate and build one request against ``eng``'s pool limits (an
    engine or the sharded router: ``eng`` needs ``.pool`` and
    ``.blocks_needed``); a paged request that needs more blocks than the
    pool has is rejected here, since it would block the queue forever."""
    prompt = np.asarray(prompt, np.int32).reshape(-1)
    pool = eng.pool
    if not 1 <= prompt.size <= pool.max_prompt:
        raise ValueError(f"prompt length {prompt.size} outside [1, {pool.max_prompt}]")
    if not 1 <= max_tokens <= pool.max_new:
        raise ValueError(f"max_tokens {max_tokens} outside [1, {pool.max_new}]")
    if pool.paged:
        need = eng.blocks_needed(prompt.size, int(max_tokens))
        cap = pool.total_blocks - 1
        if need > cap:
            raise ValueError(
                f"request needs {need} pool blocks (prompt {prompt.size}, max_tokens {max_tokens}, "
                f"block_size {pool.block_size}) but the pool only has {cap} allocatable blocks; "
                "it could never be admitted")
    if key is None:
        key = prng.PRNGKey(rid)
    return Request(rid=rid, prompt=prompt, max_tokens=int(max_tokens), key=key, t_submit=time.perf_counter(),
                   sla=sla)


class ContinuousEngine:
    """Slot-pooled continuous-batching engine for one model config, on one
    device (the card unless ``device="cpu"``).  The methods that drive it
    take the ``lm.LM`` whose weights serve the requests; the model must
    live on the engine's device.  The contiguous pool decodes with
    ``cfg.attn_impl`` (``naive`` is the oracle); the paged pool always runs
    the paged flash decode."""

    def __init__(self, cfg: ModelConfig, pool: Optional[PoolConfig] = None, device="cuda"):
        if cfg.frontend:
            raise ValueError("frontend (VLM/audio) configs are not supported by the slot-pool engine yet -- use "
                             "the whole-generation DecodeEngine")
        self.cfg = cfg
        self.pool = pool or PoolConfig()
        self.device = resolve_device(device)
        if self.pool.paged:
            bad = sorted({s.kind for s in cfg.all_layers() if s.kind != "attn"})
            if bad:
                raise ValueError(f"paged slot pools support attention-only stacks; {cfg.name!r} has {bad} layers "
                                 "(O(1) recurrent state — nothing to page)")
            if self.pool.total_blocks < 2:
                raise ValueError("paged pool needs >= 2 blocks (block 0 is the trash block)")
        self._padded = padding_safe(cfg, self.pool.max_bucket)
        self._state: Optional[Dict[str, object]] = None
        self._buckets: set = set()
        # Host-side mirrors: scheduling never reads device memory.
        self._queue: collections.deque = collections.deque()
        self._slot_req: List[Optional[Request]] = [None] * self.pool.max_slots
        self._remaining: List[int] = [0] * self.pool.max_slots
        self._free: List[int] = list(range(self.pool.max_slots))
        self._pending_harvest: List[Tuple[int, Request]] = []
        self._finished: List[Request] = []
        self._req_metrics: collections.deque = collections.deque(maxlen=4096)
        self._rid = 0
        self._stalled_steps = 0
        # An attached SLA scheduler takes submit() into its ready queue and
        # replaces FIFO admission with its tick(); a completion sink (the
        # router) hears each completion without ticking anything.
        self.scheduler = None
        self.completion_sink = None
        # Paged host allocator: block 0 is never handed out; the free list
        # is LIFO, so a freed request's blocks are reused first.
        self._free_blocks: List[int] = list(range(self.pool.total_blocks - 1, 0, -1)) if self.pool.paged else []
        self._slot_blocks: List[List[int]] = [[] for _ in range(self.pool.max_slots)]
        self.steps = 0
        self.busy_slot_steps = 0
        self.tokens_generated = 0
        self.blocks_written = 0
        self.peak_blocks_used = 0
        self.active_per_step: collections.deque = collections.deque(maxlen=65536)

    # -- device state -------------------------------------------------------

    def _init_state(self) -> Dict[str, object]:
        p, dev = self.pool, self.device
        if p.paged:
            cache = cache_lib.init_block_pool(self.cfg, p.total_blocks, p.block_size, device=dev)
        else:
            cache = cache_lib.init_slot_pool(self.cfg, p.max_slots, p.max_seq, device=dev)
        zeros = lambda *shape, dtype=torch.int32: torch.zeros(shape, dtype=dtype, device=dev)
        state = {
            "cache": cache,
            "token": zeros(p.max_slots, 1),
            "length": zeros(p.max_slots),
            "key": zeros(p.max_slots, 2, dtype=torch.int64),
            "n_gen": zeros(p.max_slots),
            "budget": zeros(p.max_slots),
            "out": zeros(p.max_slots, p.max_new),
            # The device counters, carried and added whether or not the
            # registry is enabled (it only decides whether anyone reads them).
            "obs": obs_device.counter_zeros(dev),
        }
        if p.paged:
            # Per-slot table rows, zero-padded: unreserved entries are the
            # trash block.
            state["block_table"] = zeros(p.max_slots, p.blocks_per_slot)
        return state

    def _ensure(self) -> None:
        if self._state is None:
            self._state = self._init_state()

    def _add_link_counters(self, link: Dict[str, torch.Tensor]) -> None:
        c = self._state["obs"]
        c["link_elems"] = c["link_elems"] + link["elems"]
        c["link_dropped"] = c["link_dropped"] + link["dropped"]
        c["fec_recovered_packets"] = c["fec_recovered_packets"] + link["fec_recovered"]

    def _decode_step(self, model: lm.LM) -> None:
        """One DI round for every slot, in place: emit the token fed into
        the round (the reference loop's order), split each slot's key, run
        the batched forward, pick the next tokens; live slots advance.  The
        device counters count live slots only."""
        cfg, p, st = self.cfg, self.pool, self._state
        live = st["n_gen"] < st["budget"]
        if p.greedy:
            keys = prng.split(st["key"])                         # (S, 2, 2)
        else:
            keys = prng.split(st["key"], 3)                      # (S, 3, 2)
        key2, sub = keys[:, 0], keys[:, 1]
        if p.paged:
            index = PagedIndex(lengths=st["length"], block_table=st["block_table"], live=live,
                               max_seq=p.max_seq, block_size=p.block_size)
        else:
            index = st["length"]
        with obs_device.tap_link_stats() as tap:
            logits = model(st["token"], cfg, positions=rope_lib.row_positions(st["length"], bool(cfg.mrope_sections)),
                           cache=st["cache"], cache_index=index, route_rows=not p.paged,
                           link_fn=lm.make_slotwise_link_fn(cfg, model, sub, "serve", live=live))
        if p.greedy:
            nxt = torch.argmax(logits[:, 0], dim=-1).to(torch.int32)
        else:
            nxt = prng.categorical(keys[:, 2], temperature_scale(logits[:, 0], p.temperature)).to(torch.int32)
        livef = live.to(torch.float32)
        valid = (st["length"] + 1).to(torch.float32)
        read_b = cache_lib.decode_read_bytes_jnp(cfg, p.max_seq, valid, masked=cfg.attn_impl != "naive",
                                                 paged=p.paged, block_size=p.block_size)
        c = st["obs"]
        c["decode_steps"] = c["decode_steps"] + 1
        c["valid_tokens"] = c["valid_tokens"] + torch.sum(livef * valid)
        c["decode_read_bytes"] = c["decode_read_bytes"] + torch.sum(livef * read_b)
        self._add_link_counters(tap.totals(self.device))
        rows = torch.arange(p.max_slots, device=self.device)
        col = torch.clamp(st["n_gen"], max=p.max_new - 1).to(torch.int64)
        st["out"][rows, col] = torch.where(live, st["token"][:, 0], st["out"][rows, col])
        st["token"] = torch.where(live[:, None], nxt[:, None], st["token"])
        st["length"] = torch.where(live, st["length"] + 1, st["length"])
        st["key"] = torch.where(live[:, None], key2, st["key"])
        st["n_gen"] = torch.where(live, st["n_gen"] + 1, st["n_gen"])

    def _prefill(self, model: lm.LM, req: Request, slot: int, bucket: int, bt_row: Optional[torch.Tensor]) -> None:
        """Admission: the reference chain ``key, sub = split(request_key)``,
        the padded prompt through a fresh batch-1 cache under ``sub``, the
        first token at the true last position (sampled under one more
        ``split`` of the key when sampling), and the copy into the pool.
        The link counters include the padded positions' rounds, as the
        reference's do."""
        cfg, p, st, dev = self.cfg, self.pool, self._state, self.device
        key, sub = prng.split(req.key.to(dev))
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :req.prompt.size] = req.prompt
        fresh = cache_lib.init_cache(cfg, 1, p.max_seq, device=dev)
        with obs_device.tap_link_stats() as tap:
            logits, _, _ = lm.forward(model, torch.from_numpy(padded).to(dev), cfg, cache=fresh, cache_index=0,
                                      link_key=sub, link_mode="serve")
        self._add_link_counters(tap.totals(dev))
        last = logits[:, req.prompt.size - 1]                   # (1, V)
        if p.greedy:
            tok0 = torch.argmax(last[0], dim=-1).to(torch.int32)
        else:
            key, ks = prng.split(key)
            tok0 = prng.categorical(ks, temperature_scale(last, p.temperature))[0].to(torch.int32)
        if p.paged:
            nb = min(cache_lib.blocks_for(bucket, p.block_size), p.blocks_per_slot)
            cache_lib.write_prompt_blocks(st["cache"], fresh, bt_row, nb, p.block_size)
            st["block_table"][slot] = bt_row
        else:
            cache_lib.write_slot(st["cache"], fresh, slot)
        st["token"][slot, 0] = tok0
        st["length"][slot] = req.prompt.size
        st["key"][slot] = key
        st["n_gen"][slot] = 0
        st["budget"][slot] = req.max_tokens
        st["out"][slot] = 0

    # -- scheduling -----------------------------------------------------------

    def bucket_for(self, length: int) -> int:
        if self._padded:
            return pow2_bucket(length, self.pool.min_bucket)
        return length

    @property
    def num_buckets(self) -> int:
        """Distinct prefill buckets seen (the reference compiles one program
        each; the port runs eagerly and only counts them)."""
        return len(self._buckets)

    @property
    def active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    @property
    def free_slot_count(self) -> int:
        return len(self._free)

    def free_block_count(self) -> int:
        """Blocks the host allocator could hand out right now (paged)."""
        return len(self._free_blocks)

    def running_slots(self) -> List[Tuple[int, Request]]:
        """(slot, request) of every in-flight slot: the scheduler's
        preemption candidates (host mirrors only, no device read)."""
        return [(slot, req) for slot, req in enumerate(self._slot_req) if req is not None]

    def blocks_held(self, slot: int) -> int:
        return len(self._slot_blocks[slot])

    def blocks_needed(self, prompt_len: int, max_tokens: int) -> int:
        """Blocks one request reserves for its lifetime: the padded prefill
        rows plus every decode write, capped by the rotation at ``max_seq``."""
        p = self.pool
        rows = min(max(self.bucket_for(prompt_len), prompt_len + max_tokens), p.max_seq)
        return min(cache_lib.blocks_for(rows, p.block_size), p.blocks_per_slot)

    def attach_scheduler(self, sched) -> None:
        """Install an SLA scheduler; before any traffic (a half-FIFO,
        half-scheduled queue has no coherent order)."""
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

    def harvest(self) -> None:
        """Read every finished-but-unread output row to the host (one device
        sync for all of them)."""
        if not self._pending_harvest:
            return
        out = self._state["out"].cpu().numpy()
        now = time.perf_counter()
        reg = obs.registry()
        for slot, req in self._pending_harvest:
            req.tokens = out[slot, :req.max_tokens].copy()
            req.t_retire = now
            self._req_metrics.append({"ttft_s": req.ttft_s, "tpot_s": req.tpot_s, "e2e_s": req.e2e_s})
            if reg.enabled:
                self._emit_request_spans(reg, req, slot)
        self._pending_harvest.clear()

    def _emit_request_spans(self, reg, req: Request, slot: int) -> None:
        """The submit -> retire span chain, rebuilt from the stamps taken at
        sync points (a parent span and the four phases), and the TTFT /
        TPOT / e2e histograms."""
        parent = reg.record_span("request", req.t_submit, req.t_retire, rid=req.rid, slot=slot, bucket=req.bucket,
                                 prompt_len=int(req.prompt.size), max_tokens=req.max_tokens, ttft_s=req.ttft_s,
                                 tpot_s=req.tpot_s)
        reg.record_span("request/queue", req.t_submit, req.t_admit, parent=parent, rid=req.rid)
        reg.record_span("request/prefill", req.t_admit, req.t_first_token, parent=parent, rid=req.rid,
                        bucket=req.bucket)
        reg.record_span("request/decode", req.t_first_token, req.t_done, parent=parent, rid=req.rid,
                        tokens=req.max_tokens)
        reg.record_span("request/retire", req.t_done, req.t_retire, parent=parent, rid=req.rid)
        reg.histogram("serve.ttft_s").observe(req.ttft_s)
        reg.histogram("serve.tpot_s").observe(req.tpot_s)
        reg.histogram("serve.e2e_s").observe(req.e2e_s)
        reg.counter("serve.requests_retired").inc()
        reg.counter("serve.tokens_generated").inc(req.max_tokens)

    def take_finished(self) -> List[Request]:
        """Harvest, then hand over (and clear) the finished-request list."""
        self.harvest()
        done, self._finished = self._finished, []
        return done

    @torch.inference_mode()
    def try_admit(self, model: lm.LM, req: Request) -> bool:
        """Admit one request into a free slot if resources allow; returns
        False, with no side effects, when there is no free slot or (paged)
        not enough free blocks.  The scheduler's tick (and the router)
        probe candidates in their order through this."""
        p = self.pool
        self._ensure()
        if not self._free:
            return False
        need = self.blocks_needed(req.prompt.size, req.max_tokens) if p.paged else 0
        if need > len(self._free_blocks):
            return False
        if self._pending_harvest:
            # A freed slot's output row is about to be zeroed: read the
            # finished requests first.
            self.harvest()
        slot = self._free.pop()
        bucket = self.bucket_for(req.prompt.size)
        self._buckets.add(bucket)
        req.bucket = bucket
        bt_row = None
        if p.paged:
            blocks = [self._free_blocks.pop() for _ in range(need)]
            self._slot_blocks[slot] = blocks
            row = np.zeros((p.blocks_per_slot,), np.int32)
            row[:len(blocks)] = blocks
            bt_row = torch.from_numpy(row).to(self.device)
        req.t_admit = time.perf_counter()
        self._prefill(model, req, slot, bucket, bt_row)
        self._slot_req[slot] = req
        self._remaining[slot] = req.max_tokens
        req.state = "running"
        if p.paged:
            nb = min(cache_lib.blocks_for(bucket, p.block_size), p.blocks_per_slot)
            self.blocks_written += nb
            self.peak_blocks_used = max(self.peak_blocks_used, sum(len(b) for b in self._slot_blocks))
            obs.registry().counter("serve.blocks_written").inc(nb)
            self._publish_pool_gauges()
        synchronize(self.device)
        req.t_first_token = time.perf_counter()
        return True

    def _admit(self, model: lm.LM) -> None:
        # FIFO: a head that does not fit blocks everyone behind it; progress
        # comes from retirements, and step() turns a permanent stall into
        # PoolExhausted.
        while self._queue and self.try_admit(model, self._queue[0]):
            self._queue.popleft()

    def _release(self, slot: int) -> None:
        self._slot_req[slot] = None
        self._remaining[slot] = 0
        self._free.append(slot)
        if self.pool.paged:
            # LIFO: the next admission reuses these blocks first.
            self._free_blocks.extend(reversed(self._slot_blocks[slot]))
            self._slot_blocks[slot] = []

    @torch.inference_mode()
    def preempt_slot(self, slot: int) -> Request:
        """Evict the slot's request (recompute on resume).  The slot is
        deadened on the device first (budget 0: its scalar state freezes
        and, paged, its writes go to the trash block), since its blocks may
        be handed to the very next admission; re-admission replays the
        request under the same key, token-identical to an uninterrupted run."""
        req = self._slot_req[slot]
        if req is None:
            raise ValueError(f"slot {slot} has no in-flight request")
        self._state["budget"][slot] = 0
        self._release(slot)
        if self.pool.paged:
            self._publish_pool_gauges()
        req.state = "queued"
        req.n_preempts += 1
        obs.registry().counter("serve.preemptions").inc()
        return req

    def _pool_fragmentation(self) -> float:
        """Internal fragmentation of the live reservations: 1 - (rows
        holding real tokens) / (rows reserved), over live slots; 0.0 with
        nothing live."""
        bs = self.pool.block_size
        reserved = valid = 0
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            nres = len(self._slot_blocks[slot]) * bs
            valid += min(int(req.prompt.size) + req.max_tokens - self._remaining[slot], nres)
            reserved += nres
        return 1.0 - valid / reserved if reserved else 0.0

    def _publish_pool_gauges(self) -> None:
        """The paged pool's occupancy gauges, set at admission, preemption
        and retirement from the host mirrors (no device sync)."""
        reg = obs.registry()
        reg.gauge("serve.pool_blocks_total").set(float(self.pool.total_blocks - 1))
        reg.gauge("serve.pool_blocks_used").set(float(sum(len(b) for b in self._slot_blocks)))
        reg.gauge("serve.pool_fragmentation").set(self._pool_fragmentation())

    def _decode_once(self, model: lm.LM) -> None:
        self.active_per_step.append(self.active)
        self._decode_step(model)
        self.steps += 1
        completed = []
        for slot, req in enumerate(self._slot_req):
            if req is None:
                continue
            self.busy_slot_steps += 1
            self.tokens_generated += 1
            self._remaining[slot] -= 1
            if self._remaining[slot] == 0:
                completed.append((slot, req))
                self._release(slot)
        if completed and self.pool.paged:
            self._publish_pool_gauges()
        if completed:
            # Completion steps only: steady steps keep the host ahead of
            # the device.
            synchronize(self.device)
            now = time.perf_counter()
            for slot, req in completed:
                req.t_done = now
                req.state = "completed"
                self._pending_harvest.append((slot, req))
                self._finished.append(req)
                sched = self.scheduler or self.completion_sink
                if sched is not None:
                    # Deadline accounting rides the completion sync above.
                    sched.on_complete(self, req)

    @torch.inference_mode()
    def step(self, model: lm.LM) -> None:
        """One engine tick: admission (the scheduler's tick when one is
        attached, FIFO otherwise), then one decode step over the pool if
        anything is live.  Without a scheduler, a stall with queued work and
        nothing live raises PoolExhausted after
        ``PoolConfig.exhaust_wait_steps`` ticks."""
        self._ensure()
        if self.scheduler is not None:
            self.scheduler.tick(self, model)
        else:
            self._admit(model)
        if self.active:
            self._stalled_steps = 0
            self._decode_once(model)
        elif self.scheduler is None and self._queue:
            self._stalled_steps += 1
            if self._stalled_steps > self.pool.exhaust_wait_steps:
                waited, self._stalled_steps = self._stalled_steps, 0
                head = self._queue[0]
                raise PoolExhausted(
                    waited_steps=waited, queued=len(self._queue), free_slots=len(self._free),
                    free_blocks=len(self._free_blocks),
                    need_blocks=self.blocks_needed(head.prompt.size, head.max_tokens) if self.pool.paged else 0)
        else:
            self._stalled_steps = 0

    def run(self, model: lm.LM) -> List[Request]:
        """Drive until the queue, the pool and an attached scheduler's
        queues are empty; returns every request finished since the last run,
        ``tokens`` filled (a request the scheduler expires or rejects ends
        without tokens: check ``req.state``).  A scheduler on a
        ``VirtualClock`` must be driven by ``step`` and ``advance`` instead:
        ``run`` never advances virtual time."""
        reg = obs.registry()
        with reg.span("engine.run", queued=len(self._queue)):
            self._ensure()
            while self._queue or self.active or (self.scheduler is not None and self.scheduler.pending):
                self.step(model)
            done = self.take_finished()
        if reg.enabled:
            self.publish_device_counters(reg)
        return done

    def device_counters(self) -> Dict[str, float]:
        """The device counters as host floats, with the realized drop rate.
        One sync: call at run boundaries, not each step."""
        if self._state is None:
            host = {k: 0.0 for k in obs_device.COUNTER_KEYS}
            host["realized_drop_rate"] = 0.0
            return host
        return obs_device.counters_to_host(self._state["obs"])

    def publish_device_counters(self, reg=None) -> Dict[str, float]:
        """The device counters into the registry's ``serve.device.*`` gauges."""
        reg = reg or obs.registry()
        host = self.device_counters()
        for k, v in host.items():
            reg.gauge(f"serve.device.{k}").set(v)
        return host

    def request_stats(self) -> Dict[str, float]:
        """TTFT / TPOT / e2e summaries over the retained request window."""
        out: Dict[str, float] = {"requests": float(len(self._req_metrics))}
        for field in ("ttft_s", "tpot_s", "e2e_s"):
            for k, v in latency_summary([m[field] for m in self._req_metrics]).items():
                out[f"{field[:-2]}_{k}"] = v
        return out

    def stats(self) -> Dict[str, float]:
        active = sorted(self.active_per_step)
        out = {
            "num_buckets": self.num_buckets,
            "steps": self.steps,
            "tokens_generated": self.tokens_generated,
            "slot_occupancy": self.busy_slot_steps / max(1, self.steps * self.pool.max_slots),
            "active_median": float(active[len(active) // 2]) if active else 0.0,
            "active_peak": float(active[-1]) if active else 0.0,
            "active_mean": float(sum(active)) / len(active) if active else 0.0,
            **self.request_stats(),
        }
        if self.pool.paged:
            out.update(pool_blocks_total=float(self.pool.total_blocks - 1),
                       peak_blocks_used=float(self.peak_blocks_used), blocks_written=float(self.blocks_written))
        return out

    def generate_batch(self, model: lm.LM, prompts, num_tokens: int, *,
                       key: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, Dict[str, float]]:
        """Serve a same-length batch as B independent requests with keys
        ``fold_in(key, i)``; per request, greedy output equals
        ``generate_reference(prompts[i:i+1], key=fold_in(key, i))``.
        Returns ((B, num_tokens) int32 on the engine's device, timings)."""
        key = key if key is not None else prng.PRNGKey(0)
        prompts = prompts.cpu().numpy() if torch.is_tensor(prompts) else np.asarray(prompts)
        reqs = [self.submit(prompts[i], num_tokens, key=prng.fold_in(key, i)) for i in range(prompts.shape[0])]
        t0 = time.perf_counter()
        self.run(model)
        t_total = max(time.perf_counter() - t0, 1e-9)
        tokens = torch.from_numpy(np.stack([r.tokens for r in reqs]).astype(np.int32)).to(self.device)
        timings = {
            "generate_s": t_total,
            "decode_s_per_token": t_total / max(1, num_tokens),
            "tokens_per_s": (len(reqs) * num_tokens) / t_total,
            "slot_occupancy": self.stats()["slot_occupancy"],
        }
        return tokens, timings


# ---------------------------------------------------------------------------
# Process-wide engine registry
# ---------------------------------------------------------------------------

_ENGINES: Dict[Tuple, ContinuousEngine] = {}
_MAX_ENGINES = 4      # each engine holds a device pool; bound the set


def pool_engine(cfg: ModelConfig, pool: Optional[PoolConfig] = None, device="cuda") -> ContinuousEngine:
    """Engine per (cfg, pool, device), kept in a small LRU so the pool
    survives across callers without a loss-rate sweep piling up pools."""
    pool = pool or PoolConfig()
    k = (cfg, pool, str(resolve_device(device)))
    if k in _ENGINES:
        _ENGINES[k] = _ENGINES.pop(k)          # refresh the LRU position
        return _ENGINES[k]
    while len(_ENGINES) >= _MAX_ENGINES:
        _ENGINES.pop(next(iter(_ENGINES)))
    _ENGINES[k] = ContinuousEngine(cfg, pool, device=device)
    return _ENGINES[k]


def engine_for(cfg: ModelConfig, prompt_len: int, num_tokens: int, device="cuda") -> ContinuousEngine:
    """Engine whose pool covers (prompt_len, num_tokens), both rounded up to
    powers of two so nearby one-shot ``generate()`` calls share a pool."""
    return pool_engine(cfg, PoolConfig(max_prompt=pow2_bucket(prompt_len), max_new=pow2_bucket(num_tokens, 16)),
                       device=device)


def clear_engines() -> None:
    _ENGINES.clear()


# ---------------------------------------------------------------------------
# Simulator bridge: serve a simulator batch through the live engine
# ---------------------------------------------------------------------------

def make_sim_server(engine, model: lm.LM, *, prompt_lens: Sequence[int] = (8, 16, 32), num_tokens: int = 8,
                    seed: int = 0, chaos=None, sla_for=None):
    """Adapter for ``net.simulator.run_sim(engine=...)``: maps each
    simulated request (by rid, deterministically) to a synthetic prompt
    whose length cycles through ``prompt_lens``, keyed ``fold_in(PRNGKey(
    seed), rid)``, serves the batch through the live engine (a
    ``ContinuousEngine`` or the sharded router) and returns the measured
    wall seconds, so the simulator's latencies include what the card did.

    ``chaos`` (a ``net.chaos.ChaosSchedule``) applies the pool-level faults
    (the block squeeze) to the engine at each batch's simulated start
    (``now=``).  ``sla_for`` maps a simulated rid to an ``SLA`` when the
    engine has a scheduler attached (None: best effort)."""
    vocab = engine.cfg.vocab_size
    base = prng.PRNGKey(seed)
    echaos = None
    if chaos:
        from repro_torch.net.chaos import EngineChaos

        echaos = EngineChaos(engine, chaos)

    def serve_batch(reqs, now: float = 0.0) -> float:
        if echaos is not None:
            echaos.apply(now)
        t0 = time.perf_counter()
        for r in reqs:
            rid = int(r.rid)
            length = int(prompt_lens[rid % len(prompt_lens)])
            prompt = np.random.RandomState(seed + rid).randint(0, vocab, size=(length,)).astype(np.int32)
            engine.submit(prompt, num_tokens, key=prng.fold_in(base, rid),
                          sla=sla_for(rid) if sla_for is not None else None)
        engine.run(model)
        return time.perf_counter() - t0

    return serve_batch
