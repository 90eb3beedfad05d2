"""The port's link-layer protocols (``repro_torch.net.protocol``) and the
protocol latency of its DI round (``core.comtune.di_latency_s``) against
the JAX package on the CPU.

Bars: ``latency_pmf``, ``completion_latency_pmf``, ``expected_latency_s``,
``expected_delivery_rate``, ``latency_quantile`` and ``deadline_feasible``
equal (``np.array_equal``: the same numpy code); ``run_round`` equal on the
same ``RandomState`` over every channel; ``di_latency_s`` equal under every
protocol.  Plus the twins of ``tests/test_net.py::TestProtocols``, of
``tests/test_chaos.py::TestDeadlineFeasible`` and of
``tests/test_channel_training.py::TestProtocolLatency``.
"""

import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import comtune as j_comtune  # noqa: E402
from repro.core import link as j_link  # noqa: E402
from repro.net import channels as j_channels  # noqa: E402
from repro.net import fec as j_fec  # noqa: E402
from repro.net import protocol as j_protocol  # noqa: E402
from repro.net import traces as j_traces  # noqa: E402
from repro_torch.core import comtune as t_comtune  # noqa: E402
from repro_torch.core import link as t_link  # noqa: E402
from repro_torch.net import channels as t_channels  # noqa: E402
from repro_torch.net import fec as t_fec  # noqa: E402
from repro_torch.net import protocol as t_protocol  # noqa: E402

TRACE = tuple(int(v) for v in j_traces.synthetic_burst_trace(3000, 0.3, seed=2))

# name -> (constructor name, kwargs; "fec" given as (k, m)).  The ARQ DP
# over (missing, slots) grows with the message and the round budget (60
# rounds at 10 packets: ~15 s), so the parity grid keeps ARQ's messages at
# 41 packets and its budgets at 4 rounds, or under a deadline.
PROTOCOLS = {
    "unreliable": ("UnreliableProtocol", {}),
    "arq": ("ARQProtocol", {}),
    "arq_3": ("ARQProtocol", dict(max_rounds=3)),
    "arq_deadline": ("ARQProtocol", dict(max_rounds=50, deadline_slots=30)),
    "fec_arq": ("HybridFECARQProtocol", {}),
    "fec_arq_4_2": ("HybridFECARQProtocol", dict(fec=(4, 2), max_rounds=2)),
    "fec_arq_10_2": ("HybridFECARQProtocol", dict(fec=(10, 2), max_rounds=3)),
}
PMF_CASES = [(name, n) for name in PROTOCOLS for n in (1, 16, 41, 164)
             if not (name.startswith("arq") and n > 41)]


def _protocols(name):
    cls, kw = PROTOCOLS[name]
    out = []
    for mod, fec in ((j_protocol, j_fec), (t_protocol, t_fec)):
        k = dict(kw)
        if "fec" in k:
            k["fec"] = fec.FECSpec(*k["fec"])
        out.append(getattr(mod, cls)(**k))
    return out


def _arrays_equal(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y), (x, y)


@pytest.mark.parametrize("name,n", PMF_CASES)
def test_pmfs_are_the_reference(name, n):
    jp, tp = _protocols(name)
    for p in (0.0, 0.3, 0.7, 1.0):
        jc, tc = j_link.ChannelConfig(loss_rate=p), t_link.ChannelConfig(loss_rate=p)
        lat, pmf = tp.latency_pmf(n, tc)
        _arrays_equal((lat, pmf), jp.latency_pmf(n, jc))
        _arrays_equal(tp.completion_latency_pmf(n, tc, loss_rate=p / 2),
                      jp.completion_latency_pmf(n, jc, loss_rate=p / 2))
        for q in (0.5, 0.99):
            assert t_protocol.latency_quantile(lat, pmf, q) == j_protocol.latency_quantile(lat, pmf, q)
        d = (1 + p) * n * tc.slot_time_s()
        assert t_protocol.deadline_feasible(tp, n, tc, d) == j_protocol.deadline_feasible(jp, n, jc, d)
    assert tp.expected_latency_s(n, tc) == jp.expected_latency_s(n, jc)


@pytest.mark.parametrize("name", list(PROTOCOLS))
def test_expected_delivery_rate_is_the_reference(name):
    jp, tp = _protocols(name)
    for p in (0.0, 0.2, 0.5, 0.9):
        assert tp.expected_delivery_rate(41, t_channels.IIDChannel(p)) == \
            jp.expected_delivery_rate(41, j_channels.IIDChannel(p))
    assert tp.expected_delivery_rate(164, t_channels.FadingMarkovChannel(distance_m=90.0)) == \
        jp.expected_delivery_rate(164, j_channels.FadingMarkovChannel(distance_m=90.0))


CHANNELS = {
    "iid": ("iid", dict(loss_rate=0.3)),
    "ge": ("ge", dict(loss_rate=0.4)),
    "fading": ("fading", dict(distance_m=80.0)),
    "trace": ("trace", dict(keep_trace=TRACE)),
}


@pytest.mark.parametrize("name", list(PROTOCOLS))
@pytest.mark.parametrize("channel", list(CHANNELS))
def test_run_round_is_the_reference(name, channel):
    """Rounds in turn on one ``RandomState`` and one channel state: the same
    deliveries, slots, rounds and states, and the same draws left."""
    jp, tp = _protocols(name)
    reg, kw = CHANNELS[channel]
    jch, tch = j_channels.make_channel(reg, **kw), t_channels.make_channel(reg, **kw)
    jr, tr = np.random.RandomState(11), np.random.RandomState(11)
    js, ts = jch.init_state(jr), tch.init_state(tr)
    for n in (41, 1, 164, 17):
        jres, js = jp.run_round(jr, jch, js, n)
        tres, ts = tp.run_round(tr, tch, ts, n)
        assert np.array_equal(tres.delivered, jres.delivered) and tres.delivered.dtype == jres.delivered.dtype
        assert (tres.slots, tres.rounds, tres.delivered_fraction, tres.complete) == \
            (jres.slots, jres.rounds, jres.delivered_fraction, jres.complete)
        assert ts == js
    assert jr.rand() == tr.rand()


def test_retry_dp_is_the_reference():
    for args in ((10, 1, 0.3, 4, lambda s: False), (5, 6, 0.2, 3, lambda s: False),
                 (16, 1, 0.5, 50, lambda s: s >= 30)):
        assert t_protocol._retry_dp(*args) == j_protocol._retry_dp(*args)
    for n, p in ((0, 0.3), (7, 0.0), (7, 1.0), (40, 0.37)):
        assert np.array_equal(t_protocol._binom_pmf(n, p), j_protocol._binom_pmf(n, p))


def test_make_protocol_is_the_reference():
    for name, kw in (("unreliable", {}), ("arq", dict(max_rounds=2)), ("FEC_ARQ", dict(fec={"k": 8, "m": 2})),
                     ("fec_arq", dict(max_rounds=4))):
        tp, jp = t_protocol.make_protocol(name, **kw), j_protocol.make_protocol(name, **kw)
        assert type(tp).__name__ == type(jp).__name__ and tp.name == jp.name
        assert repr(tp) == repr(jp)
    with pytest.raises(ValueError, match="unknown protocol"):
        t_protocol.make_protocol("tcp")
    assert sorted(t_protocol.PROTOCOLS) == sorted(j_protocol.PROTOCOLS)


# ---------------------------------------------------------------------------
# di_latency_s under the protocols
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("protocol", [None, "unreliable", "arq", "fec_arq", "arq_instance", "fec_arq_instance"])
@pytest.mark.parametrize("fec", [(0, 0), (10, 2), (4, 2)])
@pytest.mark.parametrize("batch", [1, 2])
def test_di_latency_is_the_reference(protocol, fec, batch):
    js = j_comtune.LinkSpec(fec_k=fec[0], fec_m=fec[1])
    ts = t_comtune.LinkSpec(fec_k=fec[0], fec_m=fec[1])
    jc, tc = j_link.ChannelConfig(loss_rate=0.3), t_link.ChannelConfig(loss_rate=0.3)
    if protocol == "arq_instance":
        jp, tp = j_protocol.ARQProtocol(max_rounds=2), t_protocol.ARQProtocol(max_rounds=2)
    elif protocol == "fec_arq_instance":
        jp, tp = (j_protocol.HybridFECARQProtocol(fec=j_fec.FECSpec(8, 2)),
                  t_protocol.HybridFECARQProtocol(fec=t_fec.FECSpec(8, 2)))
    else:
        jp = tp = protocol
    if protocol == "fec_arq" and fec == (0, 0):
        with pytest.raises(ValueError, match="fec_arq"):
            t_comtune.di_latency_s(ts, 1024, batch, tc, tp)
        return
    assert t_comtune.di_latency_s(ts, 1024, batch, tc, tp) == j_comtune.di_latency_s(js, 1024, batch, jc, jp)


class TestProtocolLatency:
    FEAT, BATCH = 4096, 1

    def test_unreliable_default_unchanged(self):
        cfg = t_link.ChannelConfig(loss_rate=0.3)
        spec = t_comtune.LinkSpec()
        assert t_comtune.di_latency_s(spec, self.FEAT, self.BATCH, cfg) == \
            t_comtune.di_latency_s(spec, self.FEAT, self.BATCH, cfg, protocol="unreliable")

    def test_arq_matches_pmf_mean(self):
        cfg = t_link.ChannelConfig(loss_rate=0.3)
        spec = t_comtune.LinkSpec()
        got = t_comtune.di_latency_s(spec, self.FEAT, self.BATCH, cfg, protocol="arq")
        n_t = -(-int(t_comtune.message_bytes(spec, self.FEAT) * self.BATCH) // cfg.packet_bytes)
        lat, pmf = t_protocol.ARQProtocol().latency_pmf(n_t, cfg)
        assert abs(got - float(np.dot(lat, pmf))) < 1e-12
        assert got > t_comtune.di_latency_s(spec, self.FEAT, self.BATCH, cfg)

    def test_hybrid_uses_spec_fec(self):
        cfg = t_link.ChannelConfig(loss_rate=0.3)
        spec = t_comtune.LinkSpec(fec_k=8, fec_m=2)
        got = t_comtune.di_latency_s(spec, self.FEAT, self.BATCH, cfg, protocol="fec_arq")
        n_data = -(-int(t_comtune.message_bytes(spec, self.FEAT) * self.BATCH) // cfg.packet_bytes)
        lat, pmf = t_protocol.HybridFECARQProtocol(fec=t_fec.FECSpec(k=8, m=2)).latency_pmf(n_data, cfg)
        assert abs(got - float(np.dot(lat, pmf))) < 1e-12

    def test_fec_arq_without_spec_fec_rejected(self):
        with pytest.raises(ValueError, match="fec_arq"):
            t_comtune.di_latency_s(t_comtune.LinkSpec(), self.FEAT, self.BATCH,
                                   t_link.ChannelConfig(loss_rate=0.3), protocol="fec_arq")

    def test_policy_instance_accepted(self):
        cfg = t_link.ChannelConfig(loss_rate=0.2)
        spec = t_comtune.LinkSpec()
        policy = t_protocol.ARQProtocol(max_rounds=2)
        got = t_comtune.di_latency_s(spec, self.FEAT, self.BATCH, cfg, protocol=policy)
        assert got == policy.expected_latency_s(-(-int(t_comtune.message_bytes(spec, self.FEAT)) // cfg.packet_bytes),
                                                cfg)

    def test_di_latency_accounts_fec_overhead(self):
        cfg = t_link.ChannelConfig()
        t0 = t_comtune.di_latency_s(t_comtune.LinkSpec(loss_rate=0.1), 1024, 1, cfg)
        t1 = t_comtune.di_latency_s(t_comtune.LinkSpec(loss_rate=0.1, fec_k=4, fec_m=2), 1024, 1, cfg)
        assert t1 > t0 * 1.3


# ---------------------------------------------------------------------------
# tests/test_net.py::TestProtocols
# ---------------------------------------------------------------------------

class TestProtocols:
    def test_unreliable_matches_eq4(self):
        cfg = t_link.ChannelConfig(loss_rate=0.3)
        lat, pmf = t_protocol.UnreliableProtocol().latency_pmf(20, cfg)
        assert lat.shape == (1,) and abs(float(lat[0]) - 20 * cfg.slot_time_s()) < 1e-12

    def test_arq_unbounded_matches_eq5_mean(self):
        cfg = t_link.ChannelConfig(loss_rate=0.4)
        lat, pmf = t_protocol.ARQProtocol(max_rounds=60).latency_pmf(10, cfg)
        assert abs(float(np.dot(lat, pmf)) / cfg.slot_time_s() - 10 / 0.6) < 0.1

    def test_arq_deadline_bounds_latency(self):
        cfg = t_link.ChannelConfig(loss_rate=0.5)
        lat, pmf = t_protocol.ARQProtocol(max_rounds=50, deadline_slots=30).latency_pmf(10, cfg)
        assert float(lat.max()) <= 40 * cfg.slot_time_s() + 1e-12
        assert abs(float(pmf.sum()) - 1.0) < 1e-9

    def test_fec_arq_beats_unreliable_delivery(self):
        ch = t_channels.GilbertElliottChannel.from_target(0.3)
        rng = np.random.RandomState(0)
        fr_u, fr_f = [], []
        for _ in range(50):
            r, _ = t_protocol.UnreliableProtocol().run_round(rng, ch, ch.init_state(rng), 24)
            fr_u.append(r.delivered_fraction)
            r, _ = t_protocol.HybridFECARQProtocol(fec=t_fec.FECSpec(k=4, m=2), max_rounds=2).run_round(
                rng, ch, ch.init_state(rng), 24)
            fr_f.append(r.delivered_fraction)
        assert np.mean(fr_f) > np.mean(fr_u) + 0.1

    def test_arq_expected_delivery_rate(self):
        proto = t_protocol.ARQProtocol(max_rounds=4)
        assert proto.expected_delivery_rate(10, t_channels.IIDChannel(0.1)) == pytest.approx(1.0 - 0.1 ** 4)
        assert proto.expected_delivery_rate(1000, t_channels.IIDChannel(0.1)) == pytest.approx(1.0 - 0.1 ** 4)
        tight = t_protocol.ARQProtocol(max_rounds=4, deadline_slots=1)
        assert tight.expected_delivery_rate(100, t_channels.IIDChannel(0.5)) == pytest.approx(0.5)

    def test_latency_pmfs_normalized(self):
        cfg = t_link.ChannelConfig(loss_rate=0.3)
        for name in ("unreliable", "arq", "fec_arq"):
            lat, pmf = t_protocol.make_protocol(name).latency_pmf(16, cfg)
            assert abs(float(pmf.sum()) - 1.0) < 1e-9
            assert np.all(np.diff(lat) > 0) or lat.size == 1


# ---------------------------------------------------------------------------
# tests/test_chaos.py::TestDeadlineFeasible
# ---------------------------------------------------------------------------

class TestDeadlineFeasible:
    PROTOS = ["unreliable", "arq", "fec_arq"]

    @pytest.mark.parametrize("name", PROTOS)
    def test_lossless_link_is_certain_within_deadline(self, name):
        p = t_protocol.deadline_feasible(t_protocol.make_protocol(name), 16, t_link.ChannelConfig(loss_rate=0.0), 10.0)
        assert p == pytest.approx(1.0, abs=1e-9)

    @pytest.mark.parametrize("name", PROTOS)
    def test_total_loss_is_exactly_zero_not_nan(self, name):
        p = t_protocol.deadline_feasible(t_protocol.make_protocol(name), 16, t_link.ChannelConfig(loss_rate=1.0), 10.0)
        assert p == 0.0 and not math.isnan(p)

    @pytest.mark.parametrize("name", PROTOS)
    def test_negative_deadline_is_zero(self, name):
        assert t_protocol.deadline_feasible(t_protocol.make_protocol(name), 16,
                                            t_link.ChannelConfig(loss_rate=0.1), -1.0) == 0.0

    def test_deadline_below_first_shot_latency_is_zero_when_lossless(self):
        cfg = t_link.ChannelConfig(loss_rate=0.0)
        proto = t_protocol.make_protocol("unreliable")
        first_shot = 16 * cfg.slot_time_s()
        assert t_protocol.deadline_feasible(proto, 16, cfg, first_shot / 2) == 0.0
        assert t_protocol.deadline_feasible(proto, 16, cfg, first_shot * 1.01) == pytest.approx(1.0, abs=1e-9)

    def test_monotone_in_deadline_and_loss(self):
        cfg = t_link.ChannelConfig(loss_rate=0.3)
        proto = t_protocol.make_protocol("arq", max_rounds=4)
        ps = [t_protocol.deadline_feasible(proto, 16, cfg, d) for d in (0.0, 0.002, 0.01, 0.05, 1.0)]
        assert all(b >= a - 1e-12 for a, b in zip(ps, ps[1:]))
        assert (t_protocol.deadline_feasible(proto, 16, cfg, 1.0, loss_rate=0.05)
                > t_protocol.deadline_feasible(proto, 16, cfg, 1.0, loss_rate=0.8))

    def test_loss_rate_override_beats_config(self):
        cfg = t_link.ChannelConfig(loss_rate=0.0)
        proto = t_protocol.make_protocol("unreliable")
        assert t_protocol.deadline_feasible(proto, 16, cfg, 10.0, loss_rate=1.0) == 0.0
        assert t_protocol.deadline_feasible(proto, 16, t_link.ChannelConfig(loss_rate=1.0), 10.0,
                                            loss_rate=0.0) == pytest.approx(1.0, abs=1e-9)
