"""The simulator's observability and live engine, and the train step's link
counters, against the reference's:

* ``_publish_obs``: with the registry enabled, the port's ``run_sim``
  publishes the reference's snapshot (the ``sim.*`` counters, gauges and
  histograms) and its span events on the simulated clock, for the same
  run; disabled, it publishes nothing;
* ``make_sim_server`` (the twin of ``TestSimulatorEngineHook``): the
  engine's busy time drives the latency; the live engine (a pool, or the
  router with a chaos squeeze and an SLA scheduler) serves the simulator's
  requests with the reference engine's tokens;
* the train step's ``link_elems`` / ``link_dropped`` /
  ``fec_recovered_packets`` equal the reference ``make_train_step``'s on
  the same weights and key (dropout, Gilbert–Elliott, GE behind FEC, the
  link off), and an epoch's per-step counters too.
"""

import dataclasses
import functools
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import obs as j_obs  # noqa: E402
from repro.configs import ARCHITECTURES as J_ARCHS  # noqa: E402
from repro.launch import steps as j_steps, train as j_train  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.net import channels as j_channels, simulator as j_sim  # noqa: E402
from repro.optim import AdamConfig as JAdamConfig, init_adam as j_init_adam  # noqa: E402
from repro.serve import ContinuousEngine as JEngine, PoolConfig as JPool, make_sim_server as j_make_sim_server  # noqa
from repro_torch import obs, prng  # noqa: E402
from repro_torch.configs import ARCHITECTURES as T_ARCHS  # noqa: E402
from repro_torch.launch import steps as t_steps, train as t_train  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.net import ChaosSchedule, block_pool_squeeze  # noqa: E402
from repro_torch.net import channels as t_channels, simulator as t_sim  # noqa: E402
from repro_torch.optim import AdamConfig, init_adam  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402
from repro_torch.serve import SLA, ContinuousEngine, PoolConfig, ShardedEngine, SLAScheduler, make_sim_server  # noqa


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _enabled(reg):
    """Reset, enable and restart the span ids: ``reset`` keeps a registry's
    id counter, which a test of either package run earlier in the same
    process (tests/test_obs.py, say) may have advanced in one registry and
    not the other."""
    reg.reset()
    reg.enable()
    reg.perf0 = 1000.0
    reg._ids = itertools.count(1)


@pytest.fixture
def both_registries():
    regs = (obs.registry(), j_obs.registry())
    was = [r.enabled for r in regs]
    for r in regs:
        _enabled(r)
    yield regs
    for r, w in zip(regs, was):
        r.reset()
        r.enabled = w


def _events(reg):
    """The span events minus the wall-clock ``sim.run`` span's stamps."""
    out = []
    for e in reg.events:
        e = dict(e)
        if e["name"] == "sim.run":
            e.pop("t"), e.pop("dur")
        out.append(e)
    return out


@pytest.mark.parametrize("channel", ["iid", "ge"])
def test_publish_obs_equals_the_reference(channel, both_registries):
    mine, ref = both_registries
    cfg_kw = dict(n_clients=4, duration_s=1.5, seed=2)
    if channel == "ge":
        chans = ([t_channels.GilbertElliottChannel.from_target(0.3) for _ in range(4)],
                 [j_channels.GilbertElliottChannel.from_target(0.3) for _ in range(4)])
    else:
        chans = (None, None)
    rep = t_sim.run_sim(t_sim.SimConfig(**cfg_kw), channels=chans[0])
    want = j_sim.run_sim(j_sim.SimConfig(**cfg_kw), channels=chans[1])
    assert dataclasses.asdict(rep) == dataclasses.asdict(want) and rep.served > 0
    s_mine, s_ref = mine.snapshot(), ref.snapshot()
    for part in ("counters", "gauges", "histograms", "num_events", "events_dropped"):
        assert s_mine[part] == s_ref[part], part
    assert _events(mine) == _events(ref)
    names = [e["name"] for e in mine.events]
    assert names.count("sim.request") == names.count("sim.uplink") == names.count("sim.server") == rep.served
    assert s_mine["counters"]["sim.requests_arrived"] == rep.arrived


def test_sim_disabled_stays_silent():
    reg = obs.registry()
    assert not reg.enabled
    before = len(reg.events)
    rep = t_sim.run_sim(t_sim.SimConfig(n_clients=2, duration_s=1.0, seed=0))
    assert rep.latency_p50_s >= 0.0 and len(reg.events) == before


def test_engine_busy_time_drives_latency():
    calls = []

    def fake_engine(batch):
        calls.append(len(batch))
        return 0.05

    rep = t_sim.run_sim(t_sim.SimConfig(n_clients=2, n_packets=4, duration_s=1.0, min_delivered_fraction=0.0),
                        arrivals=[(0.0, 0), (0.0, 1)], engine=fake_engine)
    assert rep.served == 2 and calls and rep.latency_p50_s >= 0.05


def _cfgs(loss_rate=0.3, channel="iid"):
    out = []
    for archs in (J_ARCHS, T_ARCHS):
        cfg = archs["qwen1.5-0.5b"].reduced(attn_impl="flash_decode")
        out.append(cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=loss_rate, channel=channel)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _weights():
    jcfg, tcfg = _cfgs()
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return params, model


def _recording(eng):
    """Keep every request ``eng.run`` returns (``serve_batch`` drops them)."""
    seen, run = [], eng.run

    def rec(model):
        done = run(model)
        seen.extend(done)
        return done

    eng.run = rec
    return seen


SIM = dict(n_clients=3, n_packets=4, duration_s=1.0, min_delivered_fraction=0.0)
ARRIVALS = [(0.0, 0), (0.1, 1), (0.2, 2), (0.25, 0)]


def test_live_engine_serves_the_reference_tokens():
    """The live pool behind the simulator serves each simulated request's
    prompt (its length cycling through ``prompt_lens``) under the key
    ``fold_in(PRNGKey(seed), rid)``: the reference engine's tokens."""
    jcfg, tcfg = _cfgs()
    params, model = _weights()
    pool = dict(max_slots=2, max_new=4, max_prompt=8, min_bucket=4)
    eng = ContinuousEngine(tcfg, PoolConfig(**pool), device="cpu")
    jeng = JEngine(jcfg, JPool(**pool))
    got, want = _recording(eng), _recording(jeng)
    rep = t_sim.run_sim(t_sim.SimConfig(**SIM), arrivals=ARRIVALS,
                        engine=make_sim_server(eng, model, prompt_lens=(4, 6, 8), num_tokens=3, seed=5))
    j_sim.run_sim(j_sim.SimConfig(**SIM), arrivals=ARRIVALS,
                  engine=j_make_sim_server(jeng, params, prompt_lens=(4, 6, 8), num_tokens=3, seed=5))
    assert rep.served == len(ARRIVALS) and np.isfinite(rep.latency_p99_s) and rep.latency_p99_s > 0
    assert len(got) == len(want) == len(ARRIVALS) and eng.tokens_generated == 3 * len(ARRIVALS)
    by_prompt = {tuple(r.prompt): r.tokens for r in want}
    for r in got:
        np.testing.assert_array_equal(r.tokens, by_prompt[tuple(r.prompt)])
    assert eng.num_buckets == 2                    # prompts 4 and 6 -> 4, 8 -> 8; min_bucket 4


def test_live_router_with_chaos_and_sla():
    """``make_sim_server`` over the router: the chaos squeeze reaches every
    shard's allocator at the simulated batch start, ``sla_for`` hands each
    request its class, the scheduler sees every completion, and the tokens
    equal the reference engine's."""
    jcfg, tcfg = _cfgs()
    params, model = _weights()
    pool = PoolConfig(max_slots=1, max_new=4, max_prompt=8, min_bucket=4, paged=True, block_size=4)
    router = ShardedEngine(tcfg, pool, devices=["cpu", "cpu"])
    sched = SLAScheduler(backoff_s=1e-4, backoff_cap_s=1e-3, max_retries=10_000)
    router.attach_scheduler(sched)
    got = _recording(router)
    chaos = ChaosSchedule([block_pool_squeeze(0.0, 0.05, 0.34)])     # holds 1 of 3 blocks a shard
    server = make_sim_server(router, model, prompt_lens=(4, 6), num_tokens=3, seed=1, chaos=chaos,
                             sla_for=lambda rid: SLA(priority=rid % 2, class_name=f"c{rid % 2}"))
    held = []
    run = router.run

    def run_and_look(m):
        held.append(sum(len(sub._held) for sub in server_chaos(server)._sub))
        return run(m)

    router.run = run_and_look
    rep = t_sim.run_sim(t_sim.SimConfig(**SIM), arrivals=ARRIVALS, engine=server)
    assert held[0] == 2 and held[-1] == 0, held          # one block a shard inside the window, none after
    assert rep.served == len(ARRIVALS) and len(got) == len(ARRIVALS)
    assert sched.stats["completed"] == len(ARRIVALS) and set(sched.class_report()) == {"c0", "c1"}
    assert all(sh.free_block_count() == pool.total_blocks - 1 for sh in router.shards)   # the window closed
    jeng = JEngine(jcfg, JPool(max_slots=2, max_new=4, max_prompt=8, min_bucket=4))
    want = _recording(jeng)
    j_sim.run_sim(j_sim.SimConfig(**SIM), arrivals=ARRIVALS,
                  engine=j_make_sim_server(jeng, params, prompt_lens=(4, 6), num_tokens=3, seed=1))
    by_prompt = {tuple(r.prompt): r.tokens for r in want}
    for r in got:
        np.testing.assert_array_equal(r.tokens, by_prompt[tuple(r.prompt)])
    assert sum(router.placement_counts) == len(ARRIVALS)     # one batch at a time: ties go to shard 0


# ---------------------------------------------------------------------------
# The train step's link counters
# ---------------------------------------------------------------------------

def server_chaos(server):
    """The ``EngineChaos`` a ``make_sim_server`` closure applies."""
    return next(c.cell_contents for c in server.__closure__ if type(c.cell_contents).__name__ == "EngineChaos")


@pytest.mark.parametrize("case", ["dropout", "ge", "ge_fec", "off"])
def test_train_step_link_counters_equal_the_reference(case):
    jcfg, tcfg = _cfgs(loss_rate=0.3)
    params, _ = _weights()
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    model.requires_grad_(True)
    kw = {"ge": dict(train_channel="ge"), "ge_fec": dict(train_channel="ge", train_fec=(4, 2))}.get(case, {})
    jspec = j_train.build_train_link_spec(jcfg, loss_rate=0.3 if kw else None, **kw)
    tspec = t_train.build_train_link_spec(tcfg, loss_rate=0.3 if kw else None, **kw)
    mode = "off" if case == "off" else "train"
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 16)).astype(np.int32)
    ja, ta = JAdamConfig(lr=1e-3), AdamConfig(lr=1e-3)
    jstep = jax.jit(j_steps.make_train_step(jcfg, ja, link_mode=mode, link_spec=jspec))
    _, _, want = jstep(params, j_init_adam(params, ja), {"tokens": jnp.asarray(tokens)}, jax.random.PRNGKey(4))
    tstep = t_steps.make_train_step(tcfg, ta, link_mode=mode, link_spec=tspec)
    _, _, got = tstep(model, init_adam(dict(model.named_parameters()), ta), {"tokens": torch.from_numpy(tokens)},
                      prng.PRNGKey(4))
    for k in t_steps.LINK_KEYS:
        assert float(got[k]) == float(want[k]), k
    assert (float(got["link_elems"]) > 0) == (case != "off")
    assert (float(got["fec_recovered_packets"]) > 0) == (case == "ge_fec")


def test_train_epoch_carries_per_step_link_counters():
    """K steps: (K,) link counters, each step's equal to a step run alone on
    the same key chain."""
    _, tcfg = _cfgs(loss_rate=0.3)
    model = t_lm.init_lm(tcfg, seed=1, device="cpu").requires_grad_(True)
    adam = AdamConfig(lr=1e-3)
    batches = {"tokens": torch.from_numpy(np.random.default_rng(5).integers(0, tcfg.vocab_size, (3, 2, 8)))}
    _, _, _, metrics = t_steps.make_train_epoch(tcfg, adam)(model, init_adam(dict(model.named_parameters()), adam),
                                                            batches, prng.PRNGKey(6))
    assert all(metrics[k].shape == (3,) for k in t_steps.LINK_KEYS)
    assert torch.all(metrics["link_elems"] == 2 * 8 * tcfg.d_model)
    assert torch.all(metrics["link_dropped"] > 0) and torch.all(metrics["fec_recovered_packets"] == 0)
