"""The port's multi-client serving simulator (``repro_torch.net.simulator``)
and latency statistics (``repro_torch.obs.stats``) against the JAX
package's on the CPU, and the twins of ``tests/test_net.py``'s simulator
cases.

Bars: ``SimReport.row()`` equal field for field (the same numpy code, the
same ``RandomState`` draws in the same order) for every cell of
``chip_smoke.py`` phase 15's grid (channels ge / fading / trace x the
unreliable, ARQ(3) and FEC(4, 2)-ARQ(2) protocols, 16 clients, 41 packets,
hand-scheduled arrivals), for Poisson arrivals, and with the model in the
loop: the tiny CNN carried across (``cnn_params_from_jax``) and a reduced
split LM on the reference's weights (``params_from_jax``), accuracy
included.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.core.link import ChannelConfig as JChannelConfig  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.net import channels as j_channels  # noqa: E402
from repro.net import evalhook as j_hook  # noqa: E402
from repro.net import fec as j_fec  # noqa: E402
from repro.net import protocol as j_protocol  # noqa: E402
from repro.net import simulator as j_sim  # noqa: E402
from repro.net import traces as j_traces  # noqa: E402
from repro.obs import stats as j_stats  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.link import ChannelConfig  # noqa: E402
from repro_torch.models import cnn, lm  # noqa: E402
from repro_torch.net import channels as t_channels  # noqa: E402
from repro_torch.net import evalhook  # noqa: E402
from repro_torch.net import fec as t_fec  # noqa: E402
from repro_torch.net import protocol as t_protocol  # noqa: E402
from repro_torch.net import simulator as t_sim  # noqa: E402
from repro_torch.obs import stats as t_stats  # noqa: E402
from repro_torch.params import params_from_jax  # noqa: E402

N_CLIENTS, N_PACKETS = 16, 41
TRACE = j_traces.synthetic_burst_trace(20_000, 0.3, mean_burst=6.0, seed=3)
# Hand-scheduled arrivals: each client sends 4 requests, staggered, some
# while its radio is still busy.
ARRIVALS = [(0.002 * i + 0.05 * (i // N_CLIENTS), i % N_CLIENTS) for i in range(4 * N_CLIENTS)]
TINY_LM = dict(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64, vocab_size=64)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _channels(mod, name, n=N_CLIENTS):
    if name == "ge":
        return [mod.GilbertElliottChannel.from_target(0.3) for _ in range(n)]
    if name == "fading":
        return [mod.FadingMarkovChannel(distance_m=70.0 + 5.0 * (c % 4)) for c in range(n)]
    if name == "trace":
        return [mod.TraceChannel.from_array(TRACE) for _ in range(n)]
    return [mod.IIDChannel(0.2) for _ in range(n)]


def _protocol(pmod, fmod, name):
    return {"unreliable": lambda: pmod.UnreliableProtocol(),
            "arq": lambda: pmod.ARQProtocol(max_rounds=3),
            "fec_arq": lambda: pmod.HybridFECARQProtocol(fec=fmod.FECSpec(4, 2), max_rounds=2)}[name]()


def _both(channel, protocol, cfg, **kw):
    """(reference report, port report) of one cell."""
    want = j_sim.run_sim(j_sim.SimConfig(**cfg), channels=_channels(j_channels, channel),
                         protocol=_protocol(j_protocol, j_fec, protocol), **kw.get("j", {}))
    got = t_sim.run_sim(t_sim.SimConfig(**cfg), channels=_channels(t_channels, channel),
                        protocol=_protocol(t_protocol, t_fec, protocol), **kw.get("t", {}))
    return want, got


@pytest.mark.parametrize("channel", ["ge", "fading", "trace"])
@pytest.mark.parametrize("protocol", ["unreliable", "arq", "fec_arq"])
def test_phase15_grid_cell_is_the_reference(channel, protocol):
    cfg = dict(n_clients=N_CLIENTS, n_packets=N_PACKETS, seed=5)
    want, got = _both(channel, protocol, cfg, j=dict(arrivals=ARRIVALS), t=dict(arrivals=ARRIVALS))
    assert got.row() == want.row()
    assert got.arrived == got.served + got.dropped == len(ARRIVALS)


@pytest.mark.parametrize("channel", ["iid", "ge", "fading", "trace"])
def test_poisson_run_is_the_reference(channel):
    cfg = dict(n_clients=8, arrival_rate_hz=5.0, duration_s=2.0, seed=1, min_delivered_fraction=0.7)
    want, got = _both(channel, "arq", dict(cfg, n_packets=N_PACKETS) | {"n_clients": N_CLIENTS})
    assert got.row() == want.row()


def test_curve_mode_and_default_channels_are_the_reference():
    fns = (j_sim.accuracy_curve_fn([0.0, 0.5, 1.0], [0.1, 0.5, 0.9]),
           t_sim.accuracy_curve_fn([0.0, 0.5, 1.0], [0.1, 0.5, 0.9]))
    for f in (0.0, 0.25, 0.5, 0.77, 1.0, 1.5):
        assert fns[1](f) == fns[0](f)
    cfg = dict(n_clients=4, arrival_rate_hz=3.0, duration_s=2.0, seed=2)
    want = j_sim.run_sim(j_sim.SimConfig(**cfg), accuracy_fn=fns[0])
    got = t_sim.run_sim(t_sim.SimConfig(**cfg), accuracy_fn=fns[1])
    assert got.row() == want.row() and got.accuracy_mode == "curve"


def test_latency_stats_are_the_reference():
    xs = np.random.default_rng(0).exponential(0.01, 257)
    assert t_stats.latency_summary(xs) == j_stats.latency_summary(xs)
    assert t_stats.latency_summary([]) == j_stats.latency_summary([])
    for q in (0, 50, 99, 100):
        assert t_stats.percentile(xs, q) == j_stats.percentile(xs, q)


# ---------------------------------------------------------------------------
# Model in the loop
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cnn_models():
    """The reference's tiny CNN (30 steps) and the port's TinyModel holding
    its weights and test set."""
    jm = j_hook.train_tiny_model(steps=30, n_train=200, n_test=80, seed=1)
    params, state = cnn.cnn_params_from_jax(jax.tree_util.tree_map(np.asarray, jm.params),
                                            jax.tree_util.tree_map(np.asarray, jm.state), device="cpu")
    return jm, evalhook.TinyModel(params=params, state=state, x_test=jm.x_test, y_test=jm.y_test)


@pytest.mark.parametrize("channel,protocol", [("ge", "unreliable"), ("fading", "fec_arq"), ("trace", "arq")])
def test_model_in_the_loop_cnn_is_the_reference(cnn_models, channel, protocol):
    """The eval hook's tiny CNN scores each served request's realized mask:
    the same accuracy under load, and the network fields equal a run
    without the model."""
    jm, tm = cnn_models
    cfg = dict(n_clients=N_CLIENTS, n_packets=N_PACKETS, seed=7, min_delivered_fraction=0.0)
    want, got = _both(channel, protocol, cfg, j=dict(arrivals=ARRIVALS, model_in_the_loop=True, model=jm),
                      t=dict(arrivals=ARRIVALS, model_in_the_loop=True, model=tm, device="cpu"))
    assert got.row() == want.row() and got.accuracy_mode == "model"
    _, plain = _both(channel, protocol, cfg, t=dict(arrivals=ARRIVALS))
    assert dataclasses.replace(got, accuracy_under_load=None, accuracy_mode=None) == plain


def test_model_in_the_loop_split_lm_is_the_reference():
    """``make_lm_request_eval_fn`` on a reduced qwen holding the reference's
    weights, as ``request_eval_fn``: the same accuracy under load."""
    jcfg = j_get_config("qwen1.5-0.5b").reduced(**TINY_LM)
    tcfg = get_config("qwen1.5-0.5b").reduced(**TINY_LM)
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    cfg = dict(n_clients=N_CLIENTS, n_packets=N_PACKETS, seed=3, min_delivered_fraction=0.0)
    jfn = j_hook.make_lm_request_eval_fn(params, jcfg, N_PACKETS, seq_len=8, n_test=32, seed=1)
    tfn = evalhook.make_lm_request_eval_fn(model, tcfg, N_PACKETS, seq_len=8, n_test=32, seed=1)
    want, got = _both("ge", "unreliable", cfg, j=dict(arrivals=ARRIVALS, model_in_the_loop=True, request_eval_fn=jfn),
                      t=dict(arrivals=ARRIVALS, model_in_the_loop=True, request_eval_fn=tfn))
    assert got.row() == want.row()


def test_masks_reach_the_model_in_chunks(monkeypatch):
    """Collected masks go to the eval function in chunks of
    ``_EVAL_CHUNK`` requests, in service order."""
    monkeypatch.setattr(t_sim, "_EVAL_CHUNK", 7)
    sizes = []

    def eval_fn(masks, rids):
        sizes.append(len(rids))
        return np.ones(len(rids), bool)

    rep = t_sim.run_sim(t_sim.SimConfig(n_clients=N_CLIENTS, n_packets=N_PACKETS, min_delivered_fraction=0.0),
                        channels=_channels(t_channels, "ge"), arrivals=ARRIVALS, model_in_the_loop=True,
                        request_eval_fn=eval_fn)
    assert sum(sizes) == rep.served == len(ARRIVALS) and max(sizes) == 7


def test_default_model_trains_on_the_card(monkeypatch):
    """Without a model, model-in-the-loop trains the eval hook's tiny CNN on
    ``device``: the card unless the caller asks for the CPU."""
    seen = []

    def fake_train(**kw):
        seen.append(kw.get("device"))
        raise RuntimeError("stop")

    monkeypatch.setattr(evalhook, "train_tiny_model", fake_train)
    cfg = t_sim.SimConfig(n_clients=2, n_packets=5, min_delivered_fraction=0.0)
    for kw in ({}, dict(device="cpu")):
        with pytest.raises(RuntimeError, match="stop"):
            t_sim.run_sim(cfg, channels=[t_channels.IIDChannel(0.0)] * 2, arrivals=[(0.0, 0)],
                          model_in_the_loop=True, **kw)
    assert seen == ["cuda", "cpu"]


# ---------------------------------------------------------------------------
# tests/test_net.py::TestSimulator and TestSimulatorFixes
# ---------------------------------------------------------------------------

class TestSimulator:
    def test_conserves_requests(self):
        for seed in range(3):
            channels = ([t_channels.GilbertElliottChannel.from_target(0.5) for _ in range(3)]
                        + [t_channels.IIDChannel(0.2) for _ in range(3)]
                        + [t_channels.FadingMarkovChannel(distance_m=70.0) for _ in range(2)])
            rep = t_sim.run_sim(t_sim.SimConfig(n_clients=8, arrival_rate_hz=5.0, duration_s=2.0, seed=seed,
                                                min_delivered_fraction=0.7),
                                channels=channels, protocol=t_protocol.UnreliableProtocol())
            assert rep.arrived == rep.served + rep.dropped and rep.arrived > 0

    def test_arq_improves_delivery_lowers_drop(self):
        base = t_sim.SimConfig(n_clients=8, arrival_rate_hz=4.0, duration_s=2.0, seed=0, min_delivered_fraction=0.8)
        channels = lambda: [t_channels.GilbertElliottChannel.from_target(0.45) for _ in range(8)]  # noqa: E731
        rep_u = t_sim.run_sim(base, channels=channels(), protocol=t_protocol.UnreliableProtocol())
        rep_a = t_sim.run_sim(base, channels=channels(), protocol=t_protocol.ARQProtocol(max_rounds=4))
        assert rep_a.dropped <= rep_u.dropped
        assert rep_a.mean_delivered_fraction > rep_u.mean_delivered_fraction

    def test_latency_percentiles_ordered(self):
        rep = t_sim.run_sim(t_sim.SimConfig(n_clients=16, arrival_rate_hz=4.0, duration_s=2.0, seed=1))
        assert 0.0 < rep.latency_p50_s <= rep.latency_p99_s

    def test_accuracy_under_load(self):
        fn = t_sim.accuracy_curve_fn([0.0, 0.5, 1.0], [0.1, 0.5, 0.9])
        assert abs(fn(0.25) - 0.3) < 1e-9
        rep = t_sim.run_sim(t_sim.SimConfig(n_clients=4, arrival_rate_hz=3.0, duration_s=2.0, seed=2), accuracy_fn=fn)
        assert rep.accuracy_under_load is not None and 0.0 < rep.accuracy_under_load <= 0.9


class _RecordingChannel:
    """Logs the order in which clients' channels draw."""

    def __init__(self, inner, label, log):
        self.inner, self.label, self.log = inner, label, log

    @property
    def stationary_loss_rate(self):
        return self.inner.stationary_loss_rate

    def init_state(self, rng):
        return self.inner.init_state(rng)

    def step(self, rng, state, n_packets):
        self.log.append(self.label)
        return self.inner.step(rng, state, n_packets)


class TestSimulatorFixes:
    def test_channel_draw_order_follows_uplink_start_not_arrival(self):
        channel_cfg = ChannelConfig()
        uplink_s = 50 * channel_cfg.slot_time_s()
        log = []
        rep = t_sim.run_sim(t_sim.SimConfig(n_clients=2, duration_s=1.0, n_packets=50, min_delivered_fraction=0.0),
                            channels=[_RecordingChannel(t_channels.IIDChannel(0.0), c, log) for c in range(2)],
                            channel_cfg=channel_cfg, arrivals=[(0.0, 0), (0.4 * uplink_s, 0), (0.6 * uplink_s, 1)])
        assert rep.arrived == 3 and rep.served == 3
        assert log == [0, 1, 0], log

    def test_queued_uplinks_serialize_back_to_back(self):
        channel_cfg = ChannelConfig()
        rep = t_sim.run_sim(t_sim.SimConfig(n_clients=1, duration_s=1.0, n_packets=20, min_delivered_fraction=0.0,
                                            server_base_s=0.0, server_per_item_s=0.0),
                            channels=[t_channels.IIDChannel(0.0)], channel_cfg=channel_cfg,
                            arrivals=[(0.0, 0), (0.0, 0)])
        assert rep.served == 2
        np.testing.assert_allclose(rep.latency_mean_s, 1.5 * 20 * channel_cfg.slot_time_s(), rtol=1e-6)

    def test_horizon_covers_dropped_tail(self):
        channel_cfg = ChannelConfig()
        cfg = t_sim.SimConfig(n_clients=2, duration_s=0.05, n_packets=400, min_delivered_fraction=0.2)
        rep = t_sim.run_sim(cfg, channels=[t_channels.IIDChannel(1.0)] * 2, channel_cfg=channel_cfg,
                            arrivals=[(0.049, 0), (0.049, 1)])
        assert (rep.arrived, rep.dropped, rep.served) == (2, 2, 0)
        t_drop_done = 0.049 + 400 * channel_cfg.slot_time_s()
        assert t_drop_done > cfg.duration_s
        np.testing.assert_allclose(rep.duration_s, t_drop_done, rtol=1e-6)
        assert rep.throughput_rps == 0.0

    def test_horizon_dilutes_throughput_with_served_head(self):
        channel_cfg = ChannelConfig()
        rep = t_sim.run_sim(t_sim.SimConfig(n_clients=2, duration_s=0.01, n_packets=200, min_delivered_fraction=0.5),
                            channels=[t_channels.IIDChannel(0.0), t_channels.IIDChannel(1.0)],
                            channel_cfg=channel_cfg, arrivals=[(0.0, 0), (0.009, 1)])
        assert rep.served == 1 and rep.dropped == 1
        t_tail = 0.009 + 200 * channel_cfg.slot_time_s()
        np.testing.assert_allclose(rep.duration_s, t_tail, rtol=1e-6)
        np.testing.assert_allclose(rep.throughput_rps, 1.0 / t_tail, rtol=1e-6)

    def test_conservation_with_drop_tail(self):
        for seed in range(3):
            rep = t_sim.run_sim(t_sim.SimConfig(n_clients=6, arrival_rate_hz=6.0, duration_s=1.0, seed=seed,
                                                min_delivered_fraction=0.9),
                                channels=[t_channels.GilbertElliottChannel.from_target(0.6) for _ in range(6)])
            assert rep.arrived == rep.served + rep.dropped and rep.duration_s >= 1.0

    def test_model_in_the_loop_uses_realized_masks(self):
        seen = {"masks": [], "rids": []}

        def eval_fn(masks, rids):
            seen["masks"].append(np.asarray(masks))
            seen["rids"].append(np.asarray(rids))
            return np.asarray(rids) % 2 == 0

        cfg = t_sim.SimConfig(n_clients=4, arrival_rate_hz=5.0, duration_s=1.0, seed=3, n_packets=17,
                              min_delivered_fraction=0.0)
        rep = t_sim.run_sim(cfg, channels=[t_channels.GilbertElliottChannel.from_target(0.3) for _ in range(4)],
                            model_in_the_loop=True, request_eval_fn=eval_fn)
        assert rep.accuracy_mode == "model"
        masks, rids = np.concatenate(seen["masks"]), np.concatenate(seen["rids"])
        assert masks.shape == (rep.served, cfg.n_packets) and masks.dtype == bool
        assert 0.0 < masks.mean() < 1.0
        np.testing.assert_allclose(rep.accuracy_under_load, float(np.mean(rids % 2 == 0)))

    def test_model_in_the_loop_lossless_equals_clean_accuracy(self, cnn_models):
        _, model = cnn_models
        cfg = t_sim.SimConfig(n_clients=3, arrival_rate_hz=4.0, duration_s=1.0, seed=5, n_packets=11)
        rep = t_sim.run_sim(cfg, channels=[t_channels.IIDChannel(0.0) for _ in range(3)], model_in_the_loop=True,
                            model=model, device="cpu")
        assert rep.served == rep.arrived and rep.served > 0
        expected = float(evalhook.accuracy_per_request_masks(model, np.ones((rep.served, cfg.n_packets), dtype=bool),
                                                             np.arange(rep.served)).mean())
        np.testing.assert_allclose(rep.accuracy_under_load, expected)

    def test_accuracy_curve_mode_still_reported(self):
        rep = t_sim.run_sim(t_sim.SimConfig(n_clients=4, arrival_rate_hz=3.0, duration_s=1.0, seed=2),
                            accuracy_fn=t_sim.accuracy_curve_fn([0.0, 1.0], [0.1, 0.9]))
        assert rep.accuracy_mode == "curve" and rep.accuracy_under_load is not None


def test_reference_channel_config_is_the_ports():
    assert dataclasses.asdict(ChannelConfig()) == dataclasses.asdict(JChannelConfig())
    assert ChannelConfig().slot_time_s() == JChannelConfig().slot_time_s()
