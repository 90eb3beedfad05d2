"""The port's packet FEC (``repro_torch.net.fec``) and the FEC and adaptive
branches of its link (``repro_torch.core.comtune``) against the JAX package
on the CPU.

Bars:
  * the GF(256) tables, ``gf_mul`` / ``gf_inv`` / ``cauchy_matrix``,
    ``encode`` / ``decode`` (floats too) and ``residual_loss_rate``: equal;
  * ``block_recovery_mask`` and ``fec_element_keep``: bit-equal to the JAX
    functions under the same keys, for i.i.d., Gilbert–Elliott, fading and
    trace channels;
  * ``channel_link`` / ``emulate_link`` under FEC: bit-equal to the eager
    reference (masks and values); GE + FEC under ``use_kernel`` takes the
    FEC branch, as the reference's does;
  * adaptive compensation: the masks bit-equal, the outputs within 2 f32
    ulps of the reference's (its mean is an XLA reduction, the port's a
    torch one; measured equal);
  * the twins of ``tests/test_net.py::TestFEC`` and its LinkSpec cases, and
    of the FEC and adaptive cases of ``tests/test_channel_training.py``.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import comtune as j_comtune  # noqa: E402
from repro.net import channels as j_channels  # noqa: E402
from repro.net import fec as j_fec  # noqa: E402
from repro.net import traces as j_traces  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import comtune as t_comtune  # noqa: E402
from repro_torch.core import link as t_link  # noqa: E402
from repro_torch.net import channels as t_channels  # noqa: E402
from repro_torch.net import fec as t_fec  # noqa: E402

SEEDS = (0, 3)
TRACE = tuple(int(v) for v in j_traces.synthetic_burst_trace(2000, 0.3, seed=1))
CHANNELS = {
    "iid": ("iid", dict(loss_rate=0.3)),
    "ge": ("ge", dict(loss_rate=0.4)),
    "fading": ("fading", dict(distance_m=90.0)),
    "trace": ("trace", dict(keep_trace=TRACE)),
}
CODES = [(10, 2, "rs"), (4, 2, "rs"), (5, 1, "xor"), (3, 0, "rs")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small torch ops: one thread, restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits_equal(a, b):
    a = np.asarray(a)
    b = b.detach().numpy()
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _channels(name):
    reg, kw = CHANNELS[name]
    return j_channels.make_channel(reg, **kw), t_channels.make_channel(reg, **kw)


# ---------------------------------------------------------------------------
# The codes (numpy)
# ---------------------------------------------------------------------------

def test_gf_tables_and_arithmetic_are_the_reference():
    assert np.array_equal(t_fec._GF_EXP, j_fec._GF_EXP) and np.array_equal(t_fec._GF_LOG, j_fec._GF_LOG)
    a, b = np.meshgrid(np.arange(256), np.arange(256))
    assert np.array_equal(t_fec.gf_mul(a, b), j_fec.gf_mul(a, b))
    assert [t_fec.gf_inv(v) for v in range(1, 256)] == [j_fec.gf_inv(v) for v in range(1, 256)]
    for k, m in ((1, 1), (4, 2), (10, 2), (200, 56)):
        assert np.array_equal(t_fec.cauchy_matrix(k, m), j_fec.cauchy_matrix(k, m))


@pytest.mark.parametrize("k,m,kind", CODES)
def test_encode_decode_are_the_reference(k, m, kind):
    jspec, tspec = j_fec.FECSpec(k, m, kind), t_fec.FECSpec(k, m, kind)
    assert (tspec.block_packets, tspec.overhead, tspec.num_blocks(41), tspec.transmitted_packets(41)) == \
        (jspec.block_packets, jspec.overhead, jspec.num_blocks(41), jspec.transmitted_packets(41))
    data = np.random.RandomState(k * 10 + m).randint(0, 256, (k, 48)).astype(np.uint8)
    cw = t_fec.encode(data, tspec)
    assert np.array_equal(cw, j_fec.encode(data, jspec))
    for r in range(m + 1):
        for erased in itertools.islice(itertools.combinations(range(k + m), r), 12):
            keep = [i for i in range(k + m) if i not in erased]
            got = t_fec.decode(cw[keep], keep, tspec)
            assert np.array_equal(got, j_fec.decode(cw[keep], keep, jspec)) and np.array_equal(got, data)
    acts = np.random.RandomState(m).randn(k, 25).astype(np.float32)
    cwf = t_fec.encode_floats(acts, tspec)
    assert np.array_equal(cwf, j_fec.encode_floats(acts, jspec))
    keep = list(range(m, k + m))
    assert np.array_equal(t_fec.decode_floats(cwf[keep], keep, tspec, 25).view(np.uint32), acts.view(np.uint32))


@pytest.mark.parametrize("name", list(CHANNELS))
@pytest.mark.parametrize("k,m,kind", CODES)
def test_residual_loss_rate_is_the_reference(name, k, m, kind):
    jch, tch = _channels(name)
    assert t_fec.residual_loss_rate(t_fec.FECSpec(k, m, kind), tch) == \
        j_fec.residual_loss_rate(j_fec.FECSpec(k, m, kind), jch)


# ---------------------------------------------------------------------------
# The mask algebra (torch)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,m,kind", CODES)
@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
def test_block_recovery_mask_is_the_reference(k, m, kind, lead):
    rng = np.random.default_rng(k + m)
    pkt = (rng.random(lead + (7 * (k + m),)) < 0.6).astype(np.float32)
    _bits_equal(j_fec.block_recovery_mask(jnp.asarray(pkt), j_fec.FECSpec(k, m, kind)),
                t_fec.block_recovery_mask(torch.tensor(pkt), t_fec.FECSpec(k, m, kind)))
    _bits_equal(j_fec.block_recovery_mask(jnp.asarray(pkt > 0), j_fec.FECSpec(k, m, kind)),
                t_fec.block_recovery_mask(torch.tensor(pkt > 0), t_fec.FECSpec(k, m, kind)))


@pytest.mark.parametrize("name", list(CHANNELS))
@pytest.mark.parametrize("k,m", [(10, 2), (4, 2), (5, 1)])
@pytest.mark.parametrize("shuffle", [False, True])
def test_fec_element_keep_is_the_reference(name, k, m, shuffle):
    jch, tch = _channels(name)
    for seed in SEEDS:
        for n_elem in (4096, 1000):
            want = j_fec.fec_element_keep_jnp(jax.random.PRNGKey(seed), jch, n_elem, 25, j_fec.FECSpec(k, m), shuffle)
            got = t_fec.fec_element_keep(prng.PRNGKey(seed), tch, n_elem, 25, t_fec.FECSpec(k, m), shuffle)
            assert not got.requires_grad
            _bits_equal(want, got)


# ---------------------------------------------------------------------------
# The link: FEC and adaptive branches
# ---------------------------------------------------------------------------

def _specs(**kw):
    return j_comtune.LinkSpec(**kw), t_comtune.LinkSpec(**kw)


LINKS = {
    "iid_fec": dict(loss_rate=0.3, fec_k=10, fec_m=2),
    "ge_fec": dict(loss_rate=0.3, channel="ge", fec_k=4, fec_m=2),
    "ge_fec_kernel": dict(loss_rate=0.3, channel="ge", fec_k=4, fec_m=2, use_kernel=True),
    "fading_fec": dict(channel="fading", fec_k=10, fec_m=2),
    "fading": dict(channel="fading"),
    "fading_120m": dict(channel="fading", channel_params=(("distance_m", 120.0),)),
    "trace": dict(channel="trace", channel_params=(("keep_trace", TRACE),)),
    "xor_no_shuffle": dict(loss_rate=0.2, fec_k=5, fec_m=1, fec_kind="xor", shuffle=False),
    "fec_k0": dict(loss_rate=0.2, fec_k=0, fec_m=1),
}


@pytest.mark.parametrize("name", list(LINKS))
@pytest.mark.parametrize("shape", [(4, 1, 1024), (2, 3, 64)], ids=["decode", "prefill"])
def test_link_on_the_net_path_is_the_reference(name, shape):
    """``channel_link`` and ``emulate_link`` (serve: quantize, mask,
    compensate, dequantize; a prefill-shaped message streams per position)
    equal the eager reference's to the last bit."""
    js, ts = _specs(**LINKS[name])
    assert ts.uses_net_path and js.uses_net_path
    x = (np.random.default_rng(1).standard_normal(shape) * 3).astype(np.float32)
    for seed in SEEDS:
        _bits_equal(j_comtune.channel_link(jax.random.PRNGKey(seed), jnp.asarray(x), js),
                    t_comtune.channel_link(prng.PRNGKey(seed), torch.tensor(x), ts))
        _bits_equal(j_comtune.emulate_link(jax.random.PRNGKey(seed), jnp.asarray(x), js, "serve"),
                    t_comtune.emulate_link(prng.PRNGKey(seed), torch.tensor(x), ts, "serve"))


def test_fec_spec_and_with_channel():
    spec = t_comtune.LinkSpec(fec_k=0, fec_m=2)
    assert spec.fec_spec == t_fec.FECSpec(k=1, m=2, kind="rs")
    assert t_comtune.LinkSpec().fec_spec is None
    assert t_comtune.LinkSpec(fec_k=10, fec_m=2, fec_kind="rs").fec_spec == t_fec.FECSpec(10, 2)
    ts = t_comtune.LinkSpec().with_channel("ge", p_gb=0.1, loss_bad=0.9)
    js = j_comtune.LinkSpec().with_channel("ge", p_gb=0.1, loss_bad=0.9)
    assert ts.channel_params == js.channel_params == (("loss_bad", 0.9), ("p_gb", 0.1))
    fields = [f.name for f in dataclasses.fields(t_comtune.LinkSpec)]
    assert fields == [f.name for f in dataclasses.fields(j_comtune.LinkSpec)]


def test_ge_fec_under_use_kernel_takes_the_fec_branch(monkeypatch):
    """With FEC the FEC branch comes first: no burst-mask or egress call,
    and the same output as without ``use_kernel``."""
    from repro_torch.kernels.lossy_link import dispatch

    calls = []
    monkeypatch.setattr(dispatch, "burst_mask", lambda *a, **k: calls.append("burst"))
    monkeypatch.setattr(dispatch, "lossy_link_egress", lambda *a, **k: calls.append("egress"))
    x = torch.tensor(np.random.default_rng(2).standard_normal((4, 1, 1024)).astype(np.float32))
    kw = dict(loss_rate=0.3, channel="ge", fec_k=4, fec_m=2)
    a = t_comtune.channel_link(prng.PRNGKey(1), x, t_comtune.LinkSpec(use_kernel=True, **kw))
    b = t_comtune.channel_link(prng.PRNGKey(1), x, t_comtune.LinkSpec(**kw))
    assert calls == [] and torch.equal(a, b)


@pytest.mark.parametrize("granularity", ["element", "packet"])
@pytest.mark.parametrize("channel", ["iid", "ge", "fading"])
@pytest.mark.parametrize("fec_m", [0, 2])
def test_adaptive_compensation_is_the_reference(granularity, channel, fec_m):
    """Masks bit-equal (the zeros), outputs within 2 f32 ulps of their
    size."""
    kw = dict(loss_rate=0.3, channel=channel, adaptive_compensation=True, granularity=granularity,
              fec_k=4, fec_m=fec_m)
    js, ts = _specs(**kw)
    x = (np.random.default_rng(4).standard_normal((4, 1, 1024)) * 3).astype(np.float32)
    for seed in SEEDS:
        want = np.asarray(j_comtune.channel_link(jax.random.PRNGKey(seed), jnp.asarray(x), js))
        got = t_comtune.channel_link(prng.PRNGKey(seed), torch.tensor(x), ts).numpy()
        np.testing.assert_array_equal(got == 0, want == 0)
        np.testing.assert_array_less(np.abs(got - want), 2 * np.spacing(np.abs(want)) + 1e-45)


def test_fec_link_gradient_is_identity_on_the_mask():
    """Fine-tuning through GE + FEC: the gradient is the mask over the
    residual-rate compensation, as the reference's stop_gradient makes it."""
    spec = t_comtune.LinkSpec(train_link="channel", channel="ge", shuffle=False, loss_rate=0.4, fec_k=10, fec_m=2)
    x = torch.randn(2, 16, 32, requires_grad=True)
    y = t_comtune.emulate_link(prng.PRNGKey(2), x, spec, "train")
    y.sum().backward()
    keep = max(1.0 - t_fec.residual_loss_rate(spec.fec_spec, spec.resolve_channel()), t_link.MIN_KEEP_FRACTION)
    want = (y != 0).float() / t_link.scalar_as(keep, torch.float32)
    torch.testing.assert_close(x.grad, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# tests/test_net.py::TestFEC and TestLinkSpecIntegration
# ---------------------------------------------------------------------------

class TestFEC:
    def test_rs_recovers_any_m_erasures_exactly(self):
        spec = t_fec.FECSpec(k=5, m=3, kind="rs")
        data = np.random.RandomState(0).randint(0, 256, (5, 64)).astype(np.uint8)
        cw = t_fec.encode(data, spec)
        for r in range(spec.m + 1):
            for erased in itertools.combinations(range(spec.block_packets), r):
                keep = [i for i in range(spec.block_packets) if i not in erased]
                assert np.array_equal(t_fec.decode(cw[keep], keep, spec), data), erased

    def test_rs_raises_beyond_m(self):
        spec = t_fec.FECSpec(k=4, m=2, kind="rs")
        cw = t_fec.encode(np.zeros((4, 8), np.uint8), spec)
        with pytest.raises(ValueError):
            t_fec.decode(cw[[0, 1, 2]], [0, 1, 2], spec)

    def test_xor_single_erasure(self):
        spec = t_fec.FECSpec(k=4, m=1, kind="xor")
        data = np.random.RandomState(1).randint(0, 256, (4, 32)).astype(np.uint8)
        cw = t_fec.encode(data, spec)
        for miss in range(4):
            keep = [i for i in range(5) if i != miss]
            assert np.array_equal(t_fec.decode(cw[keep], keep, spec), data)

    def test_float_payload_bit_exact(self):
        spec = t_fec.FECSpec(k=6, m=2, kind="rs")
        acts = np.random.RandomState(2).randn(6, 25).astype(np.float32)
        cw = t_fec.encode_floats(acts, spec)
        keep = [0, 2, 3, 5, 6, 7]
        assert np.array_equal(t_fec.decode_floats(cw[keep], keep, spec, 25), acts)

    def test_block_recovery_mask(self):
        pkt = torch.tensor([1, 1, 1, 0, 1, 1, 0, 1, 0], dtype=torch.float32)
        out = t_fec.block_recovery_mask(pkt, t_fec.FECSpec(k=2, m=1))
        assert out.tolist() == [1, 1, 1, 1, 0, 1]

    def test_fec_element_mask_raises_delivery(self):
        """FEC closes most of the delivery gap on the i.i.d. channel, and
        far less on an un-interleaved burst channel."""
        key = prng.PRNGKey(0)
        spec = t_fec.FECSpec(k=4, m=2)

        def mean_mask(ch, protected):
            vals = []
            for s in range(20):
                k = prng.fold_in(key, s)
                m = (t_fec.fec_element_keep(k, ch, 2000, 25, spec) if protected else ch.element_keep(k, 2000, 25))
                vals.append(float(m.mean()))
            return float(np.mean(vals))

        iid = t_channels.IIDChannel(0.3)
        ge = t_channels.GilbertElliottChannel.from_target(0.3, burst_len=4)
        gain_iid = mean_mask(iid, True) - mean_mask(iid, False)
        gain_ge = mean_mask(ge, True) - mean_mask(ge, False)
        assert gain_iid > 0.1
        assert gain_ge < gain_iid


class TestLinkSpecIntegration:
    def test_channel_link_ge_kernel_matches_reference_path(self):
        """Without FEC, GE under ``use_kernel`` on the CPU takes the burst
        mask's plain version: the same values as the channel's own scan."""
        x = torch.randn(4, 200, generator=torch.Generator().manual_seed(0))
        spec = t_comtune.LinkSpec(loss_rate=0.3).with_channel("ge")
        spec_k = t_comtune.LinkSpec(loss_rate=0.3, use_kernel=True).with_channel("ge")
        torch.testing.assert_close(t_comtune.channel_link(prng.PRNGKey(7), x, spec),
                                   t_comtune.channel_link(prng.PRNGKey(7), x, spec_k), rtol=0, atol=0)

    def test_channel_link_fec_finite(self):
        x = torch.randn(4, 100)
        spec = t_comtune.LinkSpec(loss_rate=0.4, fec_k=4, fec_m=2).with_channel("ge")
        assert torch.isfinite(t_comtune.channel_link(prng.PRNGKey(1), x, spec)).all()

    def test_iid_fec_recovers_delivery(self):
        x = torch.ones(2000)
        raw = t_comtune.channel_link(prng.PRNGKey(3), x, t_comtune.LinkSpec(loss_rate=0.4))
        prot = t_comtune.channel_link(prng.PRNGKey(3), x, t_comtune.LinkSpec(loss_rate=0.4, fec_k=4, fec_m=2))
        assert float((prot != 0).float().mean()) > float((raw != 0).float().mean()) + 0.1

    def test_iid_channel_params_loss_rate_override(self):
        x = torch.ones(1000)
        y = t_comtune.channel_link(prng.PRNGKey(0), x, t_comtune.LinkSpec().with_channel("iid", loss_rate=0.5))
        assert 0.3 < float((y == 0).float().mean()) < 0.7
        y_plain = t_comtune.channel_link(prng.PRNGKey(0), x, t_comtune.LinkSpec(loss_rate=0.5))
        assert torch.equal(y, y_plain)


# ---------------------------------------------------------------------------
# tests/test_channel_training.py: FEC and adaptive cases
# ---------------------------------------------------------------------------

class TestKeptFractionClamp:
    def test_adaptive_compensation_total_loss(self):
        for gran in ("element", "packet"):
            spec = t_comtune.LinkSpec(loss_rate=1.0, adaptive_compensation=True, granularity=gran)
            y = t_comtune.channel_link(prng.PRNGKey(0), torch.ones(64), spec)
            assert torch.isfinite(y).all() and (y == 0).all(), gran

    def test_stateful_adaptive_total_loss(self):
        spec = t_comtune.LinkSpec(channel="ge", adaptive_compensation=True,
                                  channel_params=(("p_gb", 1.0), ("p_bg", 0.0), ("loss_good", 1.0),
                                                  ("loss_bad", 1.0)))
        y = t_comtune.channel_link(prng.PRNGKey(0), torch.ones(64), spec)
        assert torch.isfinite(y).all() and (y == 0).all()

    def test_fec_total_loss(self):
        spec = t_comtune.LinkSpec(loss_rate=1.0, fec_k=4, fec_m=2)
        y = t_comtune.channel_link(prng.PRNGKey(0), torch.ones(64), spec)
        assert torch.isfinite(y).all() and (y == 0).all()


class TestChannelTrainGradients:
    def test_grads_flow_through_ge_fec_emulation(self):
        """Fine-tuning against the bursty FEC-protected channel gives real
        gradients on both sides of the split."""
        from repro_torch.configs import get_config
        from repro_torch.models import lm

        cfg = get_config("qwen1.5-0.5b").reduced(d_model=32, num_heads=2, num_kv_heads=2, head_dim=16, d_ff=64,
                                                  vocab_size=64)
        model = lm.init_lm(cfg, seed=0, device="cpu")
        model.requires_grad_(True)
        spec = t_comtune.LinkSpec(train_link="channel", channel="ge", shuffle=False, loss_rate=0.4, fec_k=10,
                                  fec_m=2)
        tokens = torch.randint(0, cfg.vocab_size, (2, 16), generator=torch.Generator().manual_seed(1))
        logits, _, aux = lm.forward(model, tokens, cfg, link_key=prng.PRNGKey(2), link_mode="train",
                                    link_spec=spec)
        loss = lm.lm_loss(logits, tokens, aux, cfg.router_aux_coef)
        loss.backward()
        assert torch.isfinite(loss)
        g_embed = float(model.embed.grad.abs().sum())
        g_norm = float(model.final_norm.scale.grad.abs().sum())
        assert g_embed > 0.0 and np.isfinite(g_embed)
        assert g_norm > 0.0 and np.isfinite(g_norm)
