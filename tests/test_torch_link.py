"""The port's link layer against the reference: loss masks (iid element,
packet + shuffle, Gilbert–Elliott) bit-equal for the same key, and
``emulate_link`` outputs f32-equal for decode-shaped (B, 1, d) and
streamed prefill-shaped (B, S, d) messages."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import comtune as j_comtune  # noqa: E402
from repro.core import link as j_link  # noqa: E402
from repro.core.compression import Compressor as JCompressor  # noqa: E402
from repro.core.compression import PCASpec as JPCASpec  # noqa: E402
from repro.core.compression import QuantSpec as JQuantSpec  # noqa: E402
from repro.net import channels as j_channels  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import comtune as t_comtune  # noqa: E402
from repro_torch.core import link as t_link  # noqa: E402
from repro_torch.core.compression import Compressor as TCompressor  # noqa: E402
from repro_torch.core.compression import PCASpec as TPCASpec  # noqa: E402
from repro_torch.core.compression import QuantSpec as TQuantSpec  # noqa: E402
from repro_torch.net import channels as t_channels  # noqa: E402

SEEDS = (0, 3, 11)


def _bits_equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("shape", [(4, 1, 33), (2, 8, 64), (4096,)])
@pytest.mark.parametrize("loss", [0.1, 0.3])
def test_element_mask(shape, loss):
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        _bits_equal(j_link.element_loss_mask(jk, shape, loss),
                    t_link.element_loss_mask(prng.PRNGKey(seed), shape, loss))


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("n", [25, 1000, 4096])
def test_packet_mask(shuffle, n):
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        _bits_equal(j_link.packet_loss_mask(jk, n, 0.3, 25, shuffle),
                    t_link.packet_loss_mask(prng.PRNGKey(seed), n, 0.3, 25, shuffle))


@pytest.mark.parametrize("shuffle", [True, False])
def test_apply_channel_packet_granularity(shuffle):
    x = np.random.default_rng(5).standard_normal((3, 1, 100)).astype(np.float32)
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        want = j_link.apply_channel(jk, jnp.asarray(x), 0.3, granularity="packet", shuffle=shuffle)
        got = t_link.apply_channel(prng.PRNGKey(seed), torch.tensor(x), 0.3, granularity="packet", shuffle=shuffle)
        _bits_equal(want, got)


@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("loss", [0.1, 0.3])
def test_gilbert_elliott_mask(shuffle, loss):
    j_ch = j_channels.make_channel("ge", loss_rate=loss)
    t_ch = t_channels.make_channel("ge", loss_rate=loss)
    assert dataclasses.astuple(j_ch) == dataclasses.astuple(t_ch)
    assert j_ch.stationary_loss_rate == t_ch.stationary_loss_rate
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        _bits_equal(j_ch.element_keep_jnp(jk, 4096, 25, shuffle=shuffle),
                    t_ch.element_keep(prng.PRNGKey(seed), 4096, 25, shuffle=shuffle))


def test_gilbert_elliott_scan_batched():
    """Independent chains over leading axes, from the same uniforms."""
    rng = np.random.default_rng(0)
    u_init = rng.random((), dtype=np.float32)
    u_loss = rng.random((3, 200), dtype=np.float32)
    u_tr = rng.random((3, 200), dtype=np.float32)
    args = (0.05, 0.4, 0.01, 0.75)
    want = j_channels.gilbert_elliott_scan(jnp.asarray(u_init), jnp.asarray(u_loss), jnp.asarray(u_tr), *args)
    got = t_channels.gilbert_elliott_scan(torch.tensor(u_init), torch.tensor(u_loss), torch.tensor(u_tr), *args)
    _bits_equal(want, got)


def test_iid_channel_packet_keep():
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        _bits_equal(j_channels.IIDChannel(0.2).packet_keep_jnp(jk, 300),
                    t_channels.IIDChannel(0.2).packet_keep(prng.PRNGKey(seed), 300))


def _specs(channel, loss, compression="quant", d=64, **kw):
    rng = np.random.default_rng(1)
    if compression == "quant":
        smin = np.full((d,), -6.0, np.float32) + rng.random(d, dtype=np.float32) * 0.1
        smax = np.full((d,), 6.0, np.float32) - rng.random(d, dtype=np.float32) * 0.1
        jc = JCompressor(kind="quant", quant=JQuantSpec(8, jnp.asarray(smin), jnp.asarray(smax)))
        tc = TCompressor(kind="quant", quant=TQuantSpec(8, torch.tensor(smin), torch.tensor(smax)))
    elif compression == "pca":
        w = rng.standard_normal((d // 4, d)).astype(np.float32) / 8
        b = rng.standard_normal(d).astype(np.float32)
        jc = JCompressor(kind="pca", pca=JPCASpec(jnp.asarray(w), jnp.asarray(b)))
        tc = TCompressor(kind="pca", pca=TPCASpec(torch.tensor(w), torch.tensor(b)))
    else:
        jc, tc = JCompressor(), TCompressor()
    common = dict(loss_rate=loss, channel=channel, **kw)
    return j_comtune.LinkSpec(compressor=jc, **common), t_comtune.LinkSpec(compressor=tc, **common)


@pytest.mark.parametrize("channel", ["iid", "ge"])
@pytest.mark.parametrize("shape", [(4, 1, 64), (2, 8, 64)], ids=["decode", "prefill"])
@pytest.mark.parametrize("shuffle", [True, False])
def test_emulate_link_serve(channel, shape, shuffle):
    """Eq. 12 under one key: quantize, mask, 1/(1-p), dequantize — equal to
    the last bit, including the streamed per-position prefill rounds."""
    js, ts = _specs(channel, 0.3, shuffle=shuffle)
    for seed in SEEDS:
        x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)
        jk = jax.random.PRNGKey(seed)
        _bits_equal(j_comtune.emulate_link(jk, jnp.asarray(x), js, "serve"),
                    t_comtune.emulate_link(prng.PRNGKey(seed), torch.tensor(x), ts, "serve"))


@pytest.mark.parametrize("mode", ["clean", "off"])
@pytest.mark.parametrize("compression", ["quant", "pca", "identity"])
def test_emulate_link_clean_and_off(mode, compression):
    js, ts = _specs("iid", 0.3, compression)
    x = (np.random.default_rng(2).standard_normal((2, 3, 64)) * 3).astype(np.float32)
    want = np.asarray(j_comtune.emulate_link(None, jnp.asarray(x), js, mode))
    got = t_comtune.emulate_link(None, torch.tensor(x), ts, mode).numpy()
    # PCA's two products sum 64 and 16 terms in another order than XLA: ~1e-6.
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("loss", [0.0, 1.0])
def test_extreme_loss_rates(loss):
    """Zero loss is the identity; loss 1.0 drops everything without NaN."""
    js, ts = _specs("iid", loss, "identity")
    x = np.random.default_rng(4).standard_normal((2, 1, 64)).astype(np.float32)
    jk = jax.random.PRNGKey(1)
    _bits_equal(j_comtune.emulate_link(jk, jnp.asarray(x), js, "serve"),
                t_comtune.emulate_link(prng.PRNGKey(1), torch.tensor(x), ts, "serve"))


@pytest.mark.parametrize("compression", ["quant", "pca", "identity"])
@pytest.mark.parametrize("batch", [1, 4])
def test_link_accounting(compression, batch):
    js, ts = _specs("iid", 0.1, compression, d=1024)
    assert t_comtune.message_bytes(ts, 1024) == j_comtune.message_bytes(js, 1024)
    jcfg, tcfg = j_link.ChannelConfig(loss_rate=0.1), t_link.ChannelConfig(loss_rate=0.1)
    assert t_comtune.di_latency_s(ts, 1024, batch, tcfg) == j_comtune.di_latency_s(js, 1024, batch, jcfg)


def test_unported_paths_raise():
    """The paths this test once held to "not ported" now run: the FEC train
    link (GE + FEC, train mode), the FEC serve link and the fading channel
    each equal the reference's to the last bit."""
    x = (np.random.default_rng(6).standard_normal((2, 3, 64)) * 3).astype(np.float32)
    for kw, mode in ((dict(fec_k=10, fec_m=2, train_link="channel", channel="ge"), "train"),
                     (dict(fec_k=4, fec_m=2), "serve"), (dict(channel="fading"), "serve")):
        js, ts = _specs(kw.pop("channel", "iid"), 0.1, "identity", **kw)
        for seed in SEEDS:
            _bits_equal(j_comtune.emulate_link(jax.random.PRNGKey(seed), jnp.asarray(x), js, mode),
                        t_comtune.emulate_link(prng.PRNGKey(seed), torch.tensor(x), ts, mode).detach())
    assert isinstance(t_channels.make_channel("fading"), t_channels.FadingMarkovChannel)
    assert (dataclasses.asdict(t_channels.make_channel("fading"))
            == dataclasses.asdict(j_channels.make_channel("fading")))
