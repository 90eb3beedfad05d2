"""Event-driven multi-client serving simulator, the port's twin of
``repro/net/simulator.py`` (numpy, the reference's code and draw order).

N device clients share one edge server over per-client lossy links.  Each
client sends split-inference requests as a Poisson process (or an explicit
hand-scheduled arrival list); a request's uplink (the split activation,
``n_packets`` packets) runs through the client's protocol over its stateful
channel (burst state carries across requests), then queues at the server,
which serves in batches under a compute-time model.  A future-event list
(heapq), no wall clock: deterministic given the seed.

* The protocol round (and so the channel draw) happens when the client's
  half-duplex radio frees up (``_UPLINK_START``), not at arrival, so
  stateful channels advance in on-air order.
* ``duration_s`` covers every finished request, served or dropped.

Outputs: throughput, p50 / p99 end-to-end latency, delivered fraction, and
accuracy under load through ``accuracy_fn(delivered_fraction)`` (the curve,
``accuracy_curve_fn``) or ``model_in_the_loop=True``: each served request's
realized packet mask goes through the server half of a real COMtune model
(``net.evalhook``), in chunks of ``_EVAL_CHUNK`` requests.

Every arrived request ends served or dropped (dropped when its round
delivers less than ``min_delivered_fraction`` of the message).

With the ``obs`` registry enabled, each run is published to it
(``_publish_obs``: the run's span, the ``sim.*`` counters, gauges and
histograms, and a span chain a request on the simulated clock).  The live
engine (``serve.continuous.make_sim_server``) can stand in for the server
model.
"""

from __future__ import annotations

import collections
import dataclasses
import heapq
import inspect
import itertools
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch import obs
from repro_torch.core import link as link_lib
from repro_torch.net.channels import Channel, IIDChannel
from repro_torch.net.chaos import ChaosSchedule, _OverrideChannel
from repro_torch.net.protocol import UnreliableProtocol, _ProtocolBase
from repro_torch.obs.stats import latency_summary


@dataclasses.dataclass(frozen=True)
class SimConfig:
    n_clients: int = 16
    arrival_rate_hz: float = 2.0       # Poisson rate per client
    duration_s: float = 10.0           # arrival window; sim drains afterwards
    n_packets: int = 41                # uplink packets per request (~4 kB/100 B)
    server_batch_max: int = 8          # server batches up to this many requests
    server_base_s: float = 2e-3        # per-batch fixed compute time
    server_per_item_s: float = 5e-4    # incremental compute per batched item
    min_delivered_fraction: float = 0.2  # below this the request is dropped
    seed: int = 0


@dataclasses.dataclass
class _Request:
    rid: int
    client: int
    t_arrival: float
    t_uplink_start: float = 0.0
    t_uplink_done: float = 0.0
    delivered_fraction: float = 0.0
    t_done: float = 0.0
    pkt_mask: Optional[np.ndarray] = None   # bool (n_packets,) realized delivery


@dataclasses.dataclass(frozen=True)
class SimReport:
    arrived: int
    served: int
    dropped: int
    duration_s: float
    throughput_rps: float
    latency_p50_s: float
    latency_p99_s: float
    latency_mean_s: float
    mean_delivered_fraction: float
    mean_batch_size: float
    accuracy_under_load: Optional[float] = None
    accuracy_mode: Optional[str] = None   # "curve" | "model" | None

    def row(self) -> Dict[str, float]:
        return dataclasses.asdict(self)


# Event kinds, ordered so simultaneous events resolve deterministically:
# arrivals enqueue before radios start, radios finish before the server.
_ARRIVAL, _UPLINK_START, _UPLINK_DONE, _SERVER_DONE = 0, 1, 2, 3


def run_sim(
    cfg: SimConfig,
    channels: Optional[Sequence[Channel]] = None,
    protocol: Optional[_ProtocolBase] = None,
    channel_cfg: Optional[link_lib.ChannelConfig] = None,
    accuracy_fn: Optional[Callable[[float], float]] = None,
    arrivals: Optional[Sequence[Tuple[float, int]]] = None,
    model_in_the_loop: bool = False,
    model=None,
    request_eval_fn: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
    engine: Optional[Callable[[Sequence["_Request"]], float]] = None,
    chaos: Optional[ChaosSchedule] = None,
    device="cuda",
) -> SimReport:
    """Run one simulation.

    ``channels`` gives one stateful channel per client (default: IID at 10%
    for all); ``protocol`` is shared (default: unreliable); ``channel_cfg``
    sets packet slot time (default: paper's 100 B @ 9 Mbit/s).

    ``arrivals`` optionally replaces the Poisson processes with an explicit
    ``[(t, client), ...]`` schedule (trace-driven workloads; also how the
    ordering tests hand-schedule contention).

    ``model_in_the_loop=True`` evaluates accuracy under load from the
    realized per-request packet masks through the real model:
    ``request_eval_fn(pkt_masks (R, n_packets) bool, rids (R,)) -> correct
    (R,) bool`` is used if given, else built from ``model`` (default: the
    eval hook's tiny COMtune CNN, trained on ``device``, the card unless
    the caller asks for the CPU; request rid -> test sample rid mod
    n_test).

    ``engine`` replaces the analytic server compute-time model with the
    live serve engine: each served batch goes to ``engine(batch_requests)
    -> wall_seconds`` (``serve.continuous.make_sim_server``), and the
    measured wall time becomes the server's busy time.  A callable with a
    ``now`` keyword receives the simulated batch start time (what drives
    chaos squeezes and scheduler deadlines on the simulated clock).
    Composes with ``model_in_the_loop=True``.

    ``chaos`` injects scheduled faults (``net.chaos``) into the event flow:
    ``channel_collapse`` windows draw uplink masks from an i.i.d. overlay at
    the override loss rate (the real channel's burst state is not
    advanced), ``server_stall`` windows extend the busy time of batches
    started inside them, and ``burst_storm`` windows multiply the Poisson
    arrival rate (explicit ``arrivals`` schedules are taken as-is).
    """
    t_wall0 = time.perf_counter()
    rng = np.random.RandomState(cfg.seed)
    channel_cfg = channel_cfg or link_lib.ChannelConfig()
    protocol = protocol or UnreliableProtocol()
    chaos = chaos if chaos else None          # empty schedule -> no-op path
    engine_takes_now = False
    if engine is not None:
        try:
            engine_takes_now = "now" in inspect.signature(engine).parameters
        except (TypeError, ValueError):
            pass
    if channels is None:
        channels = [IIDChannel(0.1) for _ in range(cfg.n_clients)]
    assert len(channels) == cfg.n_clients
    ch_state = [ch.init_state(rng) for ch in channels]
    slot_t = channel_cfg.slot_time_s()
    collect_masks = model_in_the_loop

    events: List[Tuple[float, int, int, object]] = []  # (t, kind, seq, payload)
    seq = itertools.count()

    def push(t: float, kind: int, payload) -> None:
        heapq.heappush(events, (t, kind, next(seq), payload))

    # Storm windows multiply the Poisson rate; the multiplier is evaluated
    # at scheduling time (rate-modulated, not exactly thinned — fine for a
    # fault injector).
    def arrival_rate(t: float) -> float:
        mult = chaos.storm_multiplier(t) if chaos is not None else 1.0
        return cfg.arrival_rate_hz * mult

    if arrivals is not None:
        for t, c in arrivals:
            assert 0 <= c < cfg.n_clients, (t, c)
            push(float(t), _ARRIVAL, c)
    else:
        # Seed one arrival per client; each arrival schedules the next.  The
        # window check matches the one applied to subsequent arrivals.
        for c in range(cfg.n_clients):
            t0 = rng.exponential(1.0 / arrival_rate(0.0))
            if t0 < cfg.duration_s:
                push(t0, _ARRIVAL, c)

    # Per-client uplink is half-duplex: requests on one client serialize
    # through a FIFO; the channel is drawn when transmission starts, not
    # at arrival, so burst state advances in on-air order.
    client_pending = [collections.deque() for _ in range(cfg.n_clients)]
    client_busy = [False] * cfg.n_clients
    server_queue: List[_Request] = []
    server_busy = False

    arrived = served = dropped = 0
    done: List[_Request] = []
    served_batches: List[List[_Request]] = []
    batch_sizes: List[int] = []
    t_finish = 0.0          # last served-or-dropped completion time
    rid = itertools.count()

    def start_batch(now: float) -> None:
        nonlocal server_busy
        take = server_queue[: cfg.server_batch_max]
        del server_queue[: len(take)]
        batch_sizes.append(len(take))
        if engine is not None:
            busy = float(engine(take, now=now) if engine_takes_now
                         else engine(take))
        else:
            busy = cfg.server_base_s + cfg.server_per_item_s * len(take)
        if chaos is not None:
            # A batch started inside a stall window pays the remaining
            # stall before its compute runs (frozen server, work queued).
            busy += max(0.0, chaos.stall_until(now) - now)
        server_busy = True
        push(now + busy, _SERVER_DONE, take)

    while events:
        now, kind, _, payload = heapq.heappop(events)
        if kind == _ARRIVAL:
            c = payload
            arrived += 1
            req = _Request(rid=next(rid), client=c, t_arrival=now)
            client_pending[c].append(req)
            # Kick the radio only on the empty->nonempty transition: with
            # the radio idle there is exactly one outstanding _UPLINK_START
            # per client, even for simultaneous arrivals (the busy flag
            # flips when that event is *processed*, not when scheduled).
            if not client_busy[c] and len(client_pending[c]) == 1:
                push(now, _UPLINK_START, c)
            if arrivals is None:
                # Next arrival for this client (within the arrival window).
                t_next = now + rng.exponential(1.0 / arrival_rate(now))
                if t_next < cfg.duration_s:
                    push(t_next, _ARRIVAL, c)
        elif kind == _UPLINK_START:
            c = payload
            req = client_pending[c].popleft()
            client_busy[c] = True
            req.t_uplink_start = now
            override = (chaos.loss_override(now) if chaos is not None
                        else None)
            if override is not None:
                # Collapse window: draw from the overlay process at the
                # override rate; the real channel's burst state stays put.
                result, _ = protocol.run_round(
                    rng, _OverrideChannel(override), None, cfg.n_packets
                )
            else:
                result, ch_state[c] = protocol.run_round(
                    rng, channels[c], ch_state[c], cfg.n_packets
                )
            t_up = now + result.slots * slot_t
            req.t_uplink_done = t_up
            req.delivered_fraction = result.delivered_fraction
            if collect_masks:
                req.pkt_mask = np.asarray(result.delivered, dtype=bool).copy()
            push(t_up, _UPLINK_DONE, req)
        elif kind == _UPLINK_DONE:
            req = payload
            c = req.client
            client_busy[c] = False
            if client_pending[c]:
                push(now, _UPLINK_START, c)
            if req.delivered_fraction < cfg.min_delivered_fraction:
                dropped += 1
                req.t_done = now
                t_finish = max(t_finish, now)
                continue
            server_queue.append(req)
            if not server_busy:
                start_batch(now)
        elif kind == _SERVER_DONE:
            batch = payload
            for req in batch:
                req.t_done = now
                served += 1
                done.append(req)
            t_finish = max(t_finish, now)
            if collect_masks and batch:
                served_batches.append(list(batch))
            server_busy = False
            if server_queue:
                start_batch(now)

    assert arrived == served + dropped, (arrived, served, dropped)

    # The horizon covers every finished request, served OR dropped — a
    # tail of deadline drops extends duration and dilutes throughput.
    horizon = max(t_finish, cfg.duration_s)

    acc: Optional[float] = None
    acc_mode: Optional[str] = None
    if done:
        lat = np.array([r.t_done - r.t_arrival for r in done])
        frac = np.array([r.delivered_fraction for r in done])
        summ = latency_summary(lat)
        p50, p99, mean = summ["p50_s"], summ["p99_s"], summ["mean_s"]
        mfrac = float(frac.mean())
        if model_in_the_loop:
            acc = _model_in_the_loop_accuracy(
                served_batches, cfg.n_packets, model, request_eval_fn, device
            )
            acc_mode = "model"
        elif accuracy_fn is not None:
            acc = float(np.mean([accuracy_fn(f) for f in frac]))
            acc_mode = "curve"
    else:
        p50 = p99 = mean = mfrac = 0.0
    report = SimReport(
        arrived=arrived,
        served=served,
        dropped=dropped,
        duration_s=float(horizon),
        throughput_rps=served / max(horizon, 1e-9),
        latency_p50_s=p50,
        latency_p99_s=p99,
        latency_mean_s=mean,
        mean_delivered_fraction=mfrac,
        mean_batch_size=float(np.mean(batch_sizes)) if batch_sizes else 0.0,
        accuracy_under_load=acc,
        accuracy_mode=acc_mode,
    )
    reg = obs.registry()
    if reg.enabled:
        _publish_obs(reg, report, done, t_wall0)
    return report


# Per-request simulated-time spans that go into the event log (the
# counters and histograms always cover every request).
_OBS_SPAN_CAP = 1024


def _publish_obs(reg, report: SimReport, done: Sequence[_Request], t_wall0: float) -> None:
    """Registry export of one simulation.  Per-request spans are on the
    simulated clock, rebased onto the registry's epoch (``reg.perf0 +
    sim_time``), so a chrome trace shows the simulated timeline from 0;
    wall time stamps only the ``sim.run`` span."""
    reg.record_span("sim.run", t_wall0, time.perf_counter(), arrived=report.arrived, served=report.served,
                    dropped=report.dropped, throughput_rps=report.throughput_rps)
    reg.counter("sim.requests_arrived").inc(report.arrived)
    reg.counter("sim.requests_served").inc(report.served)
    reg.counter("sim.requests_dropped").inc(report.dropped)
    reg.gauge("sim.throughput_rps").set(report.throughput_rps)
    reg.gauge("sim.mean_batch_size").set(report.mean_batch_size)
    lat_h = reg.histogram("sim.latency_s")
    frac_h = reg.histogram("sim.delivered_fraction")
    for r in done:
        lat_h.observe(r.t_done - r.t_arrival)
        frac_h.observe(r.delivered_fraction)
    for r in done[:_OBS_SPAN_CAP]:
        parent = reg.record_span("sim.request", reg.perf0 + r.t_arrival, reg.perf0 + r.t_done, rid=r.rid,
                                 client=r.client, delivered_fraction=r.delivered_fraction)
        reg.record_span("sim.uplink", reg.perf0 + r.t_uplink_start, reg.perf0 + r.t_uplink_done, parent=parent,
                        rid=r.rid)
        reg.record_span("sim.server", reg.perf0 + r.t_uplink_done, reg.perf0 + r.t_done, parent=parent, rid=r.rid)


_EVAL_CHUNK = 256   # requests per model call when flushing collected masks


def _model_in_the_loop_accuracy(
    served_batches: Sequence[Sequence[_Request]],
    n_packets: int,
    model,
    request_eval_fn,
    device="cuda",
) -> float:
    """Mean per-request correctness over the served batches' realized
    packet masks.  Masks are collected batch-by-batch as the server
    completes them and flushed through the model in bounded chunks."""
    reqs = [r for batch in served_batches for r in batch]
    if not reqs:
        return 0.0
    if request_eval_fn is None:
        # Lazy import: the simulator core stays numpy-only unless the
        # model-in-the-loop path is actually requested.
        from repro_torch.net import evalhook

        model = (model if model is not None
                 else evalhook.train_tiny_model(device=device))
        request_eval_fn = evalhook.make_request_eval_fn(model, n_packets)
    masks = np.stack([r.pkt_mask for r in reqs])
    rids = np.array([r.rid for r in reqs], dtype=np.int64)
    correct: List[np.ndarray] = []
    for i in range(0, len(reqs), _EVAL_CHUNK):
        correct.append(
            np.asarray(
                request_eval_fn(masks[i : i + _EVAL_CHUNK],
                                rids[i : i + _EVAL_CHUNK])
            )
        )
    return float(np.concatenate(correct).mean())


def accuracy_curve_fn(
    fractions: Sequence[float], accuracies: Sequence[float]
) -> Callable[[float], float]:
    """Linear interpolation of a measured accuracy-vs-delivered-fraction
    curve (clamped at the endpoints) — the bridge from the simulator's
    per-request delivery to model accuracy under load."""
    f = np.asarray(fractions, dtype=np.float64)
    a = np.asarray(accuracies, dtype=np.float64)
    order = np.argsort(f)
    f, a = f[order], a[order]

    def fn(delivered_fraction: float) -> float:
        return float(np.interp(delivered_fraction, f, a))

    return fn
