"""The port's chaos fault injection (``repro_torch.net.chaos``) against
``repro.net.chaos`` on the CPU, and the twins of ``tests/test_chaos.py``.

Bars: schedule queries and the overlay channel's draws equal to the
reference's; ``run_sim(chaos=...)`` reports equal field for field; the
block squeeze on a ledger double as the reference's test holds it, and on
the port's own paged ``ContinuousEngine``: the squeeze steals free blocks
only, hands them back LIFO, and the squeezed run's tokens equal an
unsqueezed run's.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.net import chaos as j_chaos  # noqa: E402
from repro.net import channels as j_channels  # noqa: E402
from repro.net import simulator as j_sim  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.net import chaos as t_chaos  # noqa: E402
from repro_torch.net import channels as t_channels  # noqa: E402
from repro_torch.net import simulator as t_sim  # noqa: E402
from repro_torch.serve.continuous import ContinuousEngine, PoolConfig  # noqa: E402

FAULTS = [("channel_collapse", (1.0, 2.0, 0.9)), ("channel_collapse", (0.0, 10.0, 0.5)),
          ("server_stall", (2.5, 0.5)), ("server_stall", (1.0, 2.0)), ("burst_storm", (3.0, 4.0, 4.0)),
          ("burst_storm", (0.0, 10.0, 2.0)), ("block_pool_squeeze", (4.0, 5.0, 0.8)),
          ("block_pool_squeeze", (0.0, 10.0, 0.3))]


def _schedules(faults=FAULTS):
    return (j_chaos.ChaosSchedule([getattr(j_chaos, k)(*a) for k, a in faults]),
            t_chaos.ChaosSchedule([getattr(t_chaos, k)(*a) for k, a in faults]))


def test_schedule_queries_are_the_reference():
    js, ts = _schedules()
    assert [(f.kind, f.t0, f.t1) for f in ts.faults] == [(f.kind, f.t0, f.t1) for f in js.faults]
    for t in np.linspace(-0.5, 11.0, 47):
        assert ts.loss_override(t) == js.loss_override(t)
        assert ts.stall_until(t) == js.stall_until(t)
        assert ts.storm_multiplier(t) == js.storm_multiplier(t)
        assert ts.squeeze_fraction(t) == js.squeeze_fraction(t)
        assert len(ts.active(t)) == len(js.active(t))
    assert len(ts.storms()) == len(js.storms()) == 2


@pytest.mark.parametrize("rate", [0.0, 0.3, 1.0])
def test_override_channel_is_the_reference(rate):
    jr, tr = np.random.RandomState(4), np.random.RandomState(4)
    for n in (1, 41, 200):
        jk, js = j_chaos._OverrideChannel(rate).step(jr, "state", n)
        tk, ts = t_chaos._OverrideChannel(rate).step(tr, "state", n)
        assert np.array_equal(tk, jk) and ts == js == "state"
    assert t_chaos._OverrideChannel(rate).stationary_loss_rate == rate


@pytest.mark.parametrize("channel", ["iid", "ge", "fading"])
def test_sim_under_chaos_is_the_reference(channel):
    """Poisson arrivals through a collapse, a stall and a storm: the same
    report, field for field."""
    faults = [("channel_collapse", (1.0, 2.0, 1.0)), ("server_stall", (2.5, 0.5)), ("burst_storm", (3.0, 4.0, 4.0)),
              ("channel_collapse", (4.2, 4.6, 0.6))]
    js, ts = _schedules(faults)
    kw = {"iid": dict(loss_rate=0.1), "ge": dict(loss_rate=0.4), "fading": dict(distance_m=80.0)}[channel]
    cfg = dict(n_clients=3, arrival_rate_hz=2.0, duration_s=5.0, n_packets=8, seed=2)
    want = j_sim.run_sim(j_sim.SimConfig(**cfg), channels=[j_channels.make_channel(channel, **kw)] * 3, chaos=js)
    got = t_sim.run_sim(t_sim.SimConfig(**cfg), channels=[t_channels.make_channel(channel, **kw)] * 3, chaos=ts)
    assert got.row() == want.row()
    assert got.arrived == got.served + got.dropped > 0


# ---------------------------------------------------------------------------
# tests/test_chaos.py
# ---------------------------------------------------------------------------

class TestFaultValidation:
    def test_unknown_kind_raises(self):
        with pytest.raises(ValueError, match="unknown fault kind"):
            t_chaos.Fault("power_cut", 0.0, 1.0)

    def test_empty_window_raises(self):
        with pytest.raises(ValueError, match="empty fault window"):
            t_chaos.Fault("server_stall", 2.0, 2.0)

    def test_storm_below_one_raises(self):
        with pytest.raises(ValueError, match="arrival rate"):
            t_chaos.burst_storm(0.0, 1.0, rate_multiplier=0.5)

    @pytest.mark.parametrize("fraction", [0.0, 1.5])
    def test_squeeze_fraction_out_of_range_raises(self, fraction):
        with pytest.raises(ValueError, match="fraction"):
            t_chaos.block_pool_squeeze(0.0, 1.0, fraction=fraction)

    def test_collapse_clamps_loss_rate(self):
        assert t_chaos.channel_collapse(0.0, 1.0, loss_rate=7.0).loss_rate == 1.0
        assert t_chaos.channel_collapse(0.0, 1.0, loss_rate=-1.0).loss_rate == 0.0


class TestChaosSchedule:
    def test_empty_schedule_is_falsy_noop(self):
        sched = t_chaos.ChaosSchedule()
        assert not sched
        assert sched.loss_override(0.0) is None
        assert sched.stall_until(3.0) == 3.0
        assert sched.storm_multiplier(0.0) == 1.0
        assert sched.squeeze_fraction(0.0) == 0.0

    def test_window_is_half_open(self):
        sched = t_chaos.ChaosSchedule([t_chaos.channel_collapse(1.0, 2.0, 0.9)])
        assert sched.loss_override(0.999) is None
        assert sched.loss_override(1.0) == 0.9
        assert sched.loss_override(2.0) is None

    def test_overlapping_windows_take_the_worst(self):
        _, sched = _schedules([("channel_collapse", (0.0, 10.0, 0.5)), ("channel_collapse", (3.0, 5.0, 1.0)),
                               ("burst_storm", (0.0, 10.0, 2.0)), ("burst_storm", (4.0, 6.0, 5.0)),
                               ("block_pool_squeeze", (0.0, 10.0, 0.3)), ("block_pool_squeeze", (4.0, 5.0, 0.8))])
        assert sched.loss_override(1.0) == 0.5
        assert sched.loss_override(4.0) == 1.0
        assert sched.storm_multiplier(4.5) == 5.0
        assert sched.storm_multiplier(7.0) == 2.0
        assert sched.squeeze_fraction(4.5) == 0.8
        assert sched.squeeze_fraction(8.0) == 0.3

    def test_stall_until_latest_covering_window(self):
        sched = t_chaos.ChaosSchedule([t_chaos.server_stall(1.0, 2.0), t_chaos.server_stall(2.0, 3.0)])
        assert sched.stall_until(2.5) == 5.0
        assert sched.stall_until(0.5) == 0.5


class TestOverrideChannel:
    def test_total_collapse_drops_everything(self):
        keep, state = t_chaos._OverrideChannel(1.0).step(np.random.RandomState(0), "burst-state", 64)
        assert not keep.any() and state == "burst-state"

    def test_zero_rate_keeps_everything(self):
        keep, _ = t_chaos._OverrideChannel(0.0).step(np.random.RandomState(0), None, 64)
        assert keep.all()

    def test_stationary_loss_rate_reports_override(self):
        assert t_chaos._OverrideChannel(0.7).stationary_loss_rate == 0.7


class TestSimulatorChaos:
    def _cfg(self, **kw):
        kw.setdefault("n_clients", 2)
        kw.setdefault("n_packets", 8)
        kw.setdefault("duration_s", 4.0)
        return t_sim.SimConfig(**kw)

    def test_collapse_window_drops_covered_uplinks(self):
        rep = t_sim.run_sim(self._cfg(), channels=[t_channels.IIDChannel(0.0)] * 2,
                            arrivals=[(0.5, 0), (1.0, 1), (3.0, 0)],
                            chaos=t_chaos.ChaosSchedule([t_chaos.channel_collapse(0.0, 2.0, 1.0)]))
        assert (rep.arrived, rep.dropped, rep.served) == (3, 2, 1)

    def test_stall_inflates_latency_by_remaining_stall(self):
        cfg = self._cfg(n_clients=1)
        base = t_sim.run_sim(cfg, channels=[t_channels.IIDChannel(0.0)], arrivals=[(0.0, 0)])
        stalled = t_sim.run_sim(cfg, channels=[t_channels.IIDChannel(0.0)], arrivals=[(0.0, 0)],
                                chaos=t_chaos.ChaosSchedule([t_chaos.server_stall(0.0, 2.0)]))
        assert base.served == stalled.served == 1
        assert base.latency_p50_s + 1.5 < stalled.latency_p50_s < base.latency_p50_s + 2.0 + 1e-6

    def test_storm_multiplies_poisson_arrivals(self):
        cfg = self._cfg(n_clients=4, arrival_rate_hz=1.0, duration_s=6.0, seed=3)
        base = t_sim.run_sim(cfg, channels=[t_channels.IIDChannel(0.0)] * 4)
        storm = t_sim.run_sim(cfg, channels=[t_channels.IIDChannel(0.0)] * 4,
                              chaos=t_chaos.ChaosSchedule([t_chaos.burst_storm(0.0, 6.0, 6.0)]))
        assert storm.arrived > 2 * base.arrived

    def test_conservation_holds_under_chaos(self):
        chaos = t_chaos.ChaosSchedule([t_chaos.channel_collapse(1.0, 2.0, 1.0), t_chaos.server_stall(2.5, 0.5),
                                       t_chaos.burst_storm(3.0, 4.0, 4.0)])
        rep = t_sim.run_sim(self._cfg(n_clients=3, arrival_rate_hz=2.0, duration_s=5.0),
                            channels=[t_channels.IIDChannel(0.1)] * 3, chaos=chaos)
        assert rep.arrived == rep.served + rep.dropped > 0


def _ledger_engine(allocatable=8, paged=True):
    """A host-allocator double with the two members EngineChaos touches."""
    return types.SimpleNamespace(pool=types.SimpleNamespace(paged=paged, total_blocks=allocatable + 1),
                                 _free_blocks=list(range(1, allocatable + 1)))


def _squeeze(frac, t0=0.0, t1=10.0):
    return t_chaos.ChaosSchedule([t_chaos.block_pool_squeeze(t0, t1, frac)])


class TestEngineChaosSqueeze:
    def test_steals_free_blocks_only_up_to_target(self):
        eng = _ledger_engine(allocatable=8)
        eng._free_blocks = eng._free_blocks[:3]
        chaos = t_chaos.EngineChaos(eng, _squeeze(0.75))
        chaos.apply(1.0)
        assert chaos.held_blocks == 3 and eng._free_blocks == []

    def test_pressure_builds_as_blocks_free(self):
        eng = _ledger_engine(allocatable=8)
        eng._free_blocks = [1, 2]
        chaos = t_chaos.EngineChaos(eng, _squeeze(0.5))
        chaos.apply(1.0)
        assert chaos.held_blocks == 2
        eng._free_blocks.extend([7, 8])
        chaos.apply(2.0)
        assert chaos.held_blocks == 4 and len(eng._free_blocks) == 0

    def test_window_close_returns_blocks_lifo(self):
        eng = _ledger_engine(allocatable=4)
        before = list(eng._free_blocks)
        chaos = t_chaos.EngineChaos(eng, _squeeze(1.0, 0.0, 5.0))
        chaos.apply(0.0)
        assert eng._free_blocks == [] and chaos.held_blocks == 4
        chaos.apply(5.0)
        assert chaos.held_blocks == 0 and eng._free_blocks == before

    def test_release_all_and_contiguous_noop(self):
        eng = _ledger_engine(allocatable=4)
        chaos = t_chaos.EngineChaos(eng, _squeeze(1.0, 0.0, 5.0))
        chaos.apply(1.0)
        chaos.release_all()
        assert chaos.held_blocks == 0 and sorted(eng._free_blocks) == [1, 2, 3, 4]
        flat = _ledger_engine(allocatable=4, paged=False)
        chaos2 = t_chaos.EngineChaos(flat, _squeeze(1.0, 0.0, 5.0))
        chaos2.apply(1.0)
        assert chaos2.held_blocks == 0 and len(flat._free_blocks) == 4

    def test_router_squeezes_every_shard(self):
        shards = [_ledger_engine(allocatable=4), _ledger_engine(allocatable=4)]
        chaos = t_chaos.EngineChaos(types.SimpleNamespace(shards=shards), _squeeze(0.5))
        chaos.apply(1.0)
        assert chaos.held_blocks == 4 and [len(s._free_blocks) for s in shards] == [2, 2]
        chaos.release_all()
        assert chaos.held_blocks == 0 and all(len(s._free_blocks) == 4 for s in shards)


def _tiny_model():
    cfg = get_config("qwen1.5-0.5b").reduced(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                                             vocab_size=64, attn_impl="flash_decode")
    return cfg, lm.init_lm(cfg, seed=0, device="cpu")


def test_squeeze_on_the_port_paged_engine():
    """The port's paged engine under a squeeze of half its blocks for the
    first steps: the squeeze takes free blocks only, gives them back LIFO
    when the window closes, and the requests' tokens equal an unsqueezed
    run's."""
    cfg, model = _tiny_model()
    pool = PoolConfig(max_slots=2, max_new=4, max_prompt=8, min_bucket=8, paged=True, block_size=4)
    prompts = [np.random.default_rng(i).integers(0, cfg.vocab_size, 3 + i).astype(np.int32) for i in range(3)]

    def serve(schedule):
        eng = ContinuousEngine(cfg, pool, device="cpu")
        free0 = list(eng._free_blocks)
        reqs = [eng.submit(p, 4) for p in prompts]
        chaos = t_chaos.EngineChaos(eng, schedule)
        held, t = [], 0
        while eng._queue or eng.active:
            chaos.apply(float(t))
            held.append(chaos.held_blocks)
            eng.step(model)
            t += 1
        eng.take_finished()
        chaos.release_all()
        assert sorted(eng._free_blocks) == sorted(free0)
        return [list(r.tokens) for r in reqs], held

    want, _ = serve(t_chaos.ChaosSchedule())
    got, held = serve(t_chaos.ChaosSchedule([t_chaos.block_pool_squeeze(0.0, 3.0, 0.5)]))
    allocatable = pool.total_blocks - 1
    assert held[0] == round(0.5 * allocatable) and held[3] == 0
    assert got == want
