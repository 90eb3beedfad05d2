"""The port's channel processes and traces (``repro_torch.net.channels``,
``repro_torch.net.traces``) against ``repro.net`` on the CPU.

Bars:
  * the numpy half (``init_state``, ``step``, ``mean_loss_over``, the
    traces): equal to the reference's for the same ``RandomState`` (the
    same code);
  * ``packet_keep`` / ``element_keep``: bit-equal to ``packet_keep_jnp`` /
    ``element_keep_jnp`` under the same key, for 1, 41, 164 and 1000
    packets;
  * the fading channel's tables: the f64 tables equal, and the functional
    mask's f32 tables equal to the f32 values the reference compares
    (``jnp.asarray(..., float32)`` and ``jnp.cumsum`` of the f32 law);
  * the twins of ``tests/test_net.py::TestChannels``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.net import channels as j_channels  # noqa: E402
from repro.net import traces as j_traces  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.net import channels as t_channels  # noqa: E402
from repro_torch.net import traces as t_traces  # noqa: E402

SEEDS = (0, 1, 7)
N_PACKETS = (1, 41, 164, 1000)
TRACE = j_traces.synthetic_burst_trace(5000, 0.25, seed=0)

# name -> (registry name, make_channel kwargs)
CHANNELS = {
    "iid": ("iid", dict(loss_rate=0.3)),
    "ge": ("ge", dict(loss_rate=0.3)),
    "ge_params": ("ge", dict(p_gb=0.08, p_bg=0.25, loss_good=0.05, loss_bad=0.8)),
    "fading": ("fading", {}),
    "fading_120m": ("fading", dict(distance_m=120.0)),
    "fading_6_states": ("fading", dict(distance_m=70.0, n_states=6, agility=0.5)),
    "trace": ("trace", dict(keep_trace=tuple(int(v) for v in TRACE[:777]))),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(name):
    reg, kw = CHANNELS[name]
    return j_channels.make_channel(reg, **kw), t_channels.make_channel(reg, **kw)


def _bits_equal(a, b):
    a = np.asarray(a)
    b = b.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("name", list(CHANNELS))
def test_registry_builds_the_same_channel(name):
    jch, tch = _pair(name)
    assert type(tch).__name__ == type(jch).__name__
    assert dataclasses.asdict(tch) == dataclasses.asdict(jch)
    assert tch.stationary_loss_rate == jch.stationary_loss_rate
    assert isinstance(tch, t_channels.Channel)


@pytest.mark.parametrize("name", list(CHANNELS))
@pytest.mark.parametrize("n", N_PACKETS)
def test_packet_keep_is_the_reference(name, n):
    jch, tch = _pair(name)
    for seed in SEEDS:
        _bits_equal(jch.packet_keep_jnp(jax.random.PRNGKey(seed), n), tch.packet_keep(prng.PRNGKey(seed), n))


@pytest.mark.parametrize("name", ["fading", "fading_120m", "trace"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_element_keep_is_the_reference(name, shuffle):
    jch, tch = _pair(name)
    for seed in SEEDS:
        _bits_equal(jch.element_keep_jnp(jax.random.PRNGKey(seed), 4096, 25, shuffle=shuffle),
                    tch.element_keep(prng.PRNGKey(seed), 4096, 25, shuffle=shuffle))


@pytest.mark.parametrize("name", list(CHANNELS))
def test_stateful_steps_are_the_reference(name):
    """``init_state`` then ``step`` in rounds of several sizes, on one
    ``RandomState`` each: the same keep masks, states and draws left."""
    jch, tch = _pair(name)
    jr, tr = np.random.RandomState(3), np.random.RandomState(3)
    js, ts = jch.init_state(jr), tch.init_state(tr)
    assert js == ts
    for n in (1, 41, 164, 0, 1000):
        jk, js = jch.step(jr, js, n)
        tk, ts = tch.step(tr, ts, n)
        assert tk.dtype == jk.dtype and np.array_equal(tk, jk)
        assert ts == js
    assert jr.rand() == tr.rand()
    assert (jch.mean_loss_over(np.random.RandomState(5), 2000)
            == tch.mean_loss_over(np.random.RandomState(5), 2000))


@pytest.mark.parametrize("n_states", [2, 3, 4, 5, 8])
@pytest.mark.parametrize("distance", [10.0, 50.0, 120.0])
def test_fading_tables_are_the_reference(n_states, distance):
    """The f64 tables equal; the functional mask's f32 tables equal the
    values the reference's ``packet_keep_jnp`` compares against (its f32
    cumulative stationary law summed by ``jnp.cumsum``)."""
    kw = dict(distance_m=distance, n_states=n_states)
    jch, tch = j_channels.FadingMarkovChannel(**kw), t_channels.FadingMarkovChannel(**kw)
    for a, b in zip(j_channels._fading_tables(jch), t_channels._fading_tables(tch)):
        assert np.array_equal(a, b)
    np_cum_tm, np_losses, np_pi = j_channels._fading_tables(jch)
    cum_tm, losses, cum_pi = t_channels._fading_tables_f32(tch)
    assert np.array_equal(cum_tm, np.asarray(jnp.asarray(np_cum_tm, jnp.float32)))
    assert np.array_equal(losses, np.asarray(jnp.asarray(np_losses, jnp.float32)))
    assert np.array_equal(cum_pi, np.asarray(jnp.cumsum(jnp.asarray(np_pi, jnp.float32))))
    assert cum_tm.dtype == losses.dtype == cum_pi.dtype == np.float32
    assert tch.mean_snr_db == jch.mean_snr_db


def test_markov_walk_follows_its_tables():
    """Each packet's keep decision is the one of the state the walk is in,
    and the state moves by the next-state table."""
    rng = np.random.default_rng(0)
    keep = torch.tensor(rng.random((3, 50)) < 0.5)
    nxt = torch.tensor(rng.integers(0, 3, (3, 50)))
    got = t_channels.markov_walk(torch.tensor(2), keep, nxt)
    s, want = 2, []
    for t in range(50):
        want.append(bool(keep[s, t]))
        s = int(nxt[s, t])
    assert got.tolist() == want
    assert t_channels.markov_walk(torch.tensor(0), keep[:, :0], nxt[:, :0]).shape == (0,)


def test_trace_start_is_randint_modulo_the_length():
    """The replay starts at ``randint(key, (), 0, len)``, and wraps."""
    ch = t_channels.TraceChannel.from_array(TRACE[:100])
    for seed in SEEDS:
        key = prng.PRNGKey(seed)
        start = int(np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (), 0, 100)))
        assert int(prng.randint(key, (), 0, 100)) == start
        want = TRACE[:100][(start + np.arange(250)) % 100].astype(np.float32)
        assert np.array_equal(ch.packet_keep(key, 250).numpy(), want)


def test_supports_target_rate_is_the_reference():
    for name, params in (("iid", ()), ("ge", ()), ("ge", (("p_gb", 0.1),)), ("gilbert_elliott", (("p_bg", 0.3),)),
                         ("fading", ()), ("trace", ()), ("GE", ())):
        assert t_channels.supports_target_rate(name, params) == j_channels.supports_target_rate(name, params)


def test_registry_errors():
    with pytest.raises(ValueError, match="unknown channel"):
        t_channels.make_channel("nope")
    with pytest.raises(ValueError, match="keep_trace"):
        t_channels.make_channel("trace")
    assert sorted(t_channels.CHANNELS) == sorted(j_channels.CHANNELS)


# ---------------------------------------------------------------------------
# net/traces.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("loss,burst,seed", [(0.25, 5.0, 0), (0.6, 2.0, 3), (0.0, 5.0, 1), (0.05, 20.0, 2)])
def test_synthetic_burst_trace_is_the_reference(loss, burst, seed):
    got = t_traces.synthetic_burst_trace(3000, loss, mean_burst=burst, seed=seed)
    want = j_traces.synthetic_burst_trace(3000, loss, mean_burst=burst, seed=seed)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("name", ["iid", "ge", "fading_120m", "trace"])
def test_record_trace_is_the_reference(name):
    jch, tch = _pair(name)
    assert np.array_equal(t_traces.record_trace(tch, 2000, seed=4), j_traces.record_trace(jch, 2000, seed=4))


@pytest.mark.parametrize("suffix", [".npy", ".txt"])
def test_save_load_across_packages(tmp_path, suffix):
    """A trace saved by either package loads in the other, and
    ``trace_channel`` replays it."""
    a, b = str(tmp_path / f"a{suffix}"), str(tmp_path / f"b{suffix}")
    t_traces.save_trace(a, TRACE[:500])
    j_traces.save_trace(b, TRACE[:500])
    for path in (a, b):
        assert np.array_equal(j_traces.load_trace(path), TRACE[:500])
        assert np.array_equal(t_traces.load_trace(path), TRACE[:500])
    assert t_traces.trace_channel(a) == t_channels.TraceChannel.from_array(TRACE[:500])
    with pytest.raises(FileNotFoundError):
        t_traces.load_trace(str(tmp_path / "missing.npy"))


# ---------------------------------------------------------------------------
# tests/test_net.py::TestChannels
# ---------------------------------------------------------------------------

class TestChannels:
    def test_ge_stationary_matches_analytic(self):
        ch = t_channels.GilbertElliottChannel(p_gb=0.08, p_bg=0.25, loss_good=0.05, loss_bad=0.8)
        emp = ch.mean_loss_over(np.random.RandomState(0), 200_000)
        assert abs(emp - ch.stationary_loss_rate) < 0.01

    def test_ge_packet_keep_matches_stationary(self):
        ch = t_channels.GilbertElliottChannel.from_target(0.3, burst_len=4)
        assert abs(ch.stationary_loss_rate - 0.3) < 1e-9
        keep = ch.packet_keep(prng.PRNGKey(0), 20_000)
        assert abs((1.0 - float(keep.mean())) - 0.3) < 0.03

    def test_ge_burstiness(self):
        ch = t_channels.GilbertElliottChannel.from_target(0.3, burst_len=8)
        keep, _ = ch.step(np.random.RandomState(1), False, 50_000)

        def mean_run(mask):
            runs, cur = [], 0
            for v in mask:
                if not v:
                    cur += 1
                elif cur:
                    runs.append(cur)
                    cur = 0
            return np.mean(runs)

        iid_keep = np.random.RandomState(2).rand(50_000) >= 0.3
        assert mean_run(keep) > 2.5 * mean_run(iid_keep)

    def test_ge_from_target_high_rate_clamped(self):
        ch = t_channels.GilbertElliottChannel.from_target(0.9, burst_len=4)
        assert 0.0 < ch.p_gb <= 1.0 and 0.0 < ch.p_bg <= 1.0
        assert abs(ch.stationary_loss_rate - 0.9) < 1e-9
        assert abs(ch.mean_loss_over(np.random.RandomState(0), 200_000) - 0.9) < 0.01

    def test_fading_stationary_matches_analytic(self):
        ch = t_channels.FadingMarkovChannel(distance_m=60.0)
        emp = np.mean([ch.mean_loss_over(np.random.RandomState(s), 50_000) for s in range(4)])
        assert abs(emp - ch.stationary_loss_rate) < 0.01

    def test_fading_packet_keep_matches_stationary(self):
        ch = t_channels.FadingMarkovChannel(distance_m=60.0)
        rates = [1.0 - float(ch.packet_keep(prng.PRNGKey(s), 5000).mean()) for s in range(8)]
        assert abs(np.mean(rates) - ch.stationary_loss_rate) < 0.03

    def test_fading_distance_monotone(self):
        rates = [t_channels.FadingMarkovChannel(distance_m=d).stationary_loss_rate for d in (10.0, 40.0, 100.0)]
        assert rates[0] < rates[1] < rates[2]

    def test_trace_replay(self):
        ch = t_channels.TraceChannel.from_array(TRACE)
        assert abs(ch.stationary_loss_rate - (1 - TRACE.mean())) < 1e-9
        keep, state = ch.step(np.random.RandomState(0), 17, 100)
        assert np.array_equal(keep, TRACE[17:117].astype(bool)) and state == 117

    def test_record_trace_roundtrip(self):
        ch = t_channels.GilbertElliottChannel.from_target(0.4)
        replay = t_channels.TraceChannel.from_array(t_traces.record_trace(ch, 10_000, seed=0))
        assert abs(replay.stationary_loss_rate - 0.4) < 0.05

    def test_registry(self):
        assert isinstance(t_channels.make_channel("iid", 0.2), t_channels.IIDChannel)
        assert abs(t_channels.make_channel("ge", 0.2).stationary_loss_rate - 0.2) < 1e-9
        assert isinstance(t_channels.make_channel("fading", 0.2, distance_m=30.0), t_channels.FadingMarkovChannel)
        with pytest.raises(ValueError):
            t_channels.make_channel("nope")
