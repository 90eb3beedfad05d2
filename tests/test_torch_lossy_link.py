"""The port's split-point link kernels (``repro_torch.kernels.lossy_link``)
and the ``LinkSpec(use_kernel=True)`` serving path against the reference,
on inputs made from a seed with numpy; and, on an sm_90 card only, the CUDA
kernels against their plain versions.

Bars:
  * the egress kernel draws its own uniforms: what one of its threads
    computes for element ``i`` (one threefry block of ``i``'s words, in
    plain Python ints here) equals ``prng.uniform(key, (T, D))`` at ``i``
    bit for bit, and the keyed plain egress equals the reference's
    ``ops.lossy_link_egress`` as the keyless one does;
  * the plain egress equals the reference's ``ref.py`` bit for bit; the
    reference's own interpret-mode Pallas kernel differs from its ``ref.py``
    by up to ~2.4e-6 in f32, so the port is held to that kernel at the
    ``atol=1e-5`` the reference's tests pin between the two
    (``tests/test_kernels.py``), values compared in f32; in bf16 an f32
    difference that small can round to the neighbouring bf16 value, so bf16
    outputs also take one bf16 ulp (``rtol=2**-7``);
  * burst masks (0/1 from comparisons only) are exact, and so is the plain
    version of the CUDA kernel's warp scan of state maps
    (``burst_mask_scan_ref``);
  * the Gilbert–Elliott link with the burst-mask kernel equals the link
    without it bit for bit (the same keys, the same comparisons);
  * at reduced size, the prefill-plus-decode loop through
    ``forward(link_spec=LinkSpec(use_kernel=True))`` gives the reference
    loop's greedy tokens, under i.i.d. and Gilbert–Elliott links;
  * on the card, each kernel equals its plain version bit for bit.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import prng  # noqa: E402
from repro_torch.core import comtune as t_comtune  # noqa: E402
from repro_torch.core.compression import Compressor as TCompressor  # noqa: E402
from repro_torch.core.compression import QuantSpec as TQuantSpec  # noqa: E402
from repro_torch.kernels.lossy_link import (  # noqa: E402
    burst_mask,
    burst_mask_ref,
    burst_mask_scan_ref,
    cuda_kernel,
    dispatch,
    lossy_link_egress,
    lossy_link_egress_keyed_ref,
    lossy_link_egress_ref,
)
from repro_torch.net.channels import make_channel  # noqa: E402

KERNEL_TOL = {"float32": dict(rtol=0, atol=1e-5), "bfloat16": dict(rtol=2.0 ** -7, atol=1e-5)}
GE = dict(p_gb=0.1, p_bg=0.3, loss_good=0.02, loss_bad=0.8)
SEEDS = (0, 3, 11)


@pytest.fixture
def J():
    """The reference package, imported where it is needed so the card-only
    tests run where jax is absent."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.core import comtune
    from repro.core.compression import Compressor, QuantSpec
    from repro.kernels.lossy_link import kernel, ops, ref

    return dataclasses.make_dataclass("J", ["jax", "jnp", "comtune", "Compressor", "QuantSpec", "kernel", "ops",
                                            "ref"])(jax, jnp, comtune, Compressor, QuantSpec, kernel, ops, ref)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (the kernels are built for sm_90a)")


def _bits_equal(a, b):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape, a.dtype, b.dtype)
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _tdtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def _egress_inputs(seed, t, d, scale=3.0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((t, d)) * scale).astype(np.float32)
    u = rng.random((t, d), dtype=np.float32)
    smin = (np.full((d,), -4.0) + rng.random(d) * 0.2).astype(np.float32)
    smax = (np.full((d,), 4.0) - rng.random(d) * 0.2).astype(np.float32)
    return x, u, smin, smax


def _as_f32(a):
    return np.asarray(a.float() if isinstance(a, torch.Tensor) else a.astype("float32"), np.float32)


def _check_egress(J, x, u, smin, smax, dtype, bits, loss):
    jx = J.jnp.asarray(x).astype(getattr(J.jnp, dtype))
    jargs = (jx, J.jnp.asarray(u), J.jnp.asarray(smin), J.jnp.asarray(smax))
    want_ref = J.ref.lossy_link_egress_ref(*jargs, bits=bits, loss_rate=loss)
    want_ker = J.kernel.lossy_link_egress_kernel(*jargs, bits=bits, loss_rate=loss, interpret=True)
    got = lossy_link_egress_ref(torch.tensor(x).to(_tdtype(dtype)), torch.tensor(u), torch.tensor(smin),
                                torch.tensor(smax), bits=bits, loss_rate=loss)
    assert got.dtype == _tdtype(dtype) and tuple(got.shape) == x.shape
    _bits_equal(_as_f32(want_ref), _as_f32(got))
    np.testing.assert_allclose(_as_f32(got), _as_f32(want_ker), **KERNEL_TOL[dtype])


@pytest.mark.parametrize("shape", [(64, 256), (100, 300), (1, 128), (257, 513)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("loss", [0.0, 0.3, 0.8])
def test_egress_ref_matches_reference(J, shape, dtype, loss):
    """The reference test's grid (8 bits): bitwise vs ``ref.py``, within
    1e-5 of the interpret-mode kernel."""
    _check_egress(J, *_egress_inputs(shape[0] * 31 + shape[1], *shape), dtype, 8, loss)


@pytest.mark.parametrize("bits", [1, 4, 8, 16])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_egress_ref_bit_widths(J, bits, dtype):
    _check_egress(J, *_egress_inputs(bits, 32, 128, scale=2.0), dtype, bits, 0.2)


@pytest.mark.parametrize("shape", [(8, 64), (5, 130), (1, 7), (17, 256), (1, 164)])
def test_burst_mask_ref_matches_reference(J, shape):
    """Exact against the reference's scan oracle and its Pallas kernel."""
    r, n = shape
    rng = np.random.default_rng(r * 777 + n)
    ui, ul, ut = (rng.random(s, dtype=np.float32) for s in ((r,), (r, n), (r, n)))
    got = burst_mask_ref(torch.tensor(ui), torch.tensor(ul), torch.tensor(ut), **GE)
    jargs = tuple(J.jnp.asarray(a) for a in (ui, ul, ut))
    _bits_equal(J.ref.burst_mask_ref(*jargs, **GE), got)
    _bits_equal(J.kernel.burst_mask_kernel(*jargs, **GE, interpret=True), got)


# The main path's channel: GE at loss 0.1 as ``make_channel`` builds it
# (mean burst 4 packets, a lossless good state, a lossy bad state).
MAIN_GE = dataclasses.asdict(make_channel("ge", loss_rate=0.1))


@pytest.mark.parametrize("r", [1, 5, 32])
@pytest.mark.parametrize("n", [1, 31, 32, 33, 164, 1000, 4097])
@pytest.mark.parametrize("channel", ["main", "leaky"])
def test_burst_mask_scan_ref_matches_reference(J, r, n, channel):
    """The CUDA kernel's arithmetic (per-lane chunk maps, their scan over 32
    lanes, the re-walk, the carry across 256-packet tiles) gives the
    sequential chain's masks bit for bit: against the port's
    ``burst_mask_ref`` and the reference's.  N 31 / 32 / 33 leave lanes
    without packets; 1000 and 4097 carry across tiles."""
    kw = MAIN_GE if channel == "main" else GE
    rng = np.random.default_rng(r * 10007 + n)
    ui, ul, ut = (rng.random(s, dtype=np.float32) for s in ((r,), (r, n), (r, n)))
    got = burst_mask_scan_ref(torch.tensor(ui), torch.tensor(ul), torch.tensor(ut), **kw)
    assert torch.equal(got, burst_mask_ref(torch.tensor(ui), torch.tensor(ul), torch.tensor(ut), **kw))
    _bits_equal(J.ref.burst_mask_ref(*(J.jnp.asarray(a) for a in (ui, ul, ut)), **kw), got)


@pytest.mark.parametrize("shape", [(4, 1, 64), (3, 200), (1, 1, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatch_egress_matches_ops(J, shape, dtype):
    """``lossy_link_egress(key, x, quant, p)`` vs the reference's ``ops``:
    the same uniforms (bitwise), the reference ref's output on them
    (bitwise) and its kernel's (within 1e-5)."""
    d = shape[-1]
    x, _, smin, smax = _egress_inputs(d, int(np.prod(shape[:-1])), d)
    x = x.reshape(shape)
    for seed in SEEDS:
        jkey = J.jax.random.PRNGKey(seed)
        t_flat = int(np.prod(shape[:-1]))
        _bits_equal(J.jax.random.uniform(jkey, (t_flat, d), J.jnp.float32), prng.uniform(prng.PRNGKey(seed), (t_flat, d)))
        jx = J.jnp.asarray(x).astype(getattr(J.jnp, dtype))
        jq = J.QuantSpec(8, J.jnp.asarray(smin), J.jnp.asarray(smax))
        got = lossy_link_egress(prng.PRNGKey(seed), torch.tensor(x).to(_tdtype(dtype)),
                                TQuantSpec(8, torch.tensor(smin), torch.tensor(smax)), 0.3)
        u = J.jax.random.uniform(jkey, (t_flat, d), J.jnp.float32)
        want_ref = J.ref.lossy_link_egress_ref(jx.reshape(t_flat, d), u, jq.s_min, jq.s_max, bits=8, loss_rate=0.3)
        _bits_equal(_as_f32(want_ref).reshape(shape), _as_f32(got))
        np.testing.assert_allclose(_as_f32(got), _as_f32(J.ops.lossy_link_egress(jkey, jx, jq, 0.3)),
                                   **KERNEL_TOL[dtype])


M32 = 0xFFFFFFFF


def _threefry_words(key, i):
    """What one thread of the CUDA egress computes for element ``i`` of a
    draw under ``key``, in plain Python ints: Threefry-2x32 (20 rounds) of
    the counter ``(i >> 32, i & 0xffffffff)``; returns ``w0 ^ w1``."""
    k0, k1 = int(key[0]) & M32, int(key[1]) & M32
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0, x1 = ((i >> 32) + ks[0]) & M32, ((i & M32) + ks[1]) & M32
    for rnd in range(5):
        for r in ((13, 15, 26, 6), (17, 29, 16, 24))[rnd % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 ^= x0
        x0 = (x0 + ks[(rnd + 1) % 3]) & M32
        x1 = (x1 + ks[(rnd + 2) % 3] + rnd + 1) & M32
    return x0 ^ x1


def _uniform_at(key, i):
    """The thread's uniform: the top 23 bits as the mantissa of a float in
    [1, 2), minus 1, in f32."""
    one = np.array([(_threefry_words(key, i) >> 9) | 0x3F800000], np.uint32).view(np.float32)[0]
    return np.float32(one - np.float32(1.0))


@pytest.mark.parametrize("shape", [(1, 1), (3, 7), (4, 1024), (5, 33), (257, 513), (1, 4097)])
def test_egress_thread_uniform_equals_prng_uniform(shape):
    """Scattered elements (the first, the last, the middle, random ones) of
    ``prng.uniform(key, (T, D))`` are what one egress thread computes, bit
    for bit, under fresh and split keys."""
    n = int(np.prod(shape))
    rng = np.random.default_rng(n)
    idx = sorted({0, n - 1, n // 2, *rng.integers(0, n, size=min(n, 40)).tolist()})
    for key in (prng.PRNGKey(0), prng.PRNGKey(2 ** 32 - 3), *prng.split(prng.PRNGKey(7), 2)):
        u = prng.uniform(key, shape).reshape(-1).numpy()
        got = np.array([_uniform_at(key, i) for i in idx], np.float32)
        np.testing.assert_array_equal(got.view(np.uint32), u[idx].view(np.uint32))


def test_egress_thread_counter_high_word():
    """Past 2**32 elements the counter's high word is ``i >> 32``, as
    ``prng.random_bits`` forms it: the thread's words equal
    ``prng.threefry2x32`` on ``(i >> 32, i & 0xffffffff)``."""
    key = prng.split(prng.PRNGKey(5))[1]
    idx = torch.tensor([0, 2 ** 32 - 1, 2 ** 32, 2 ** 32 + 5, 3 * 2 ** 40 + 17], dtype=torch.int64)
    w0, w1 = prng.threefry2x32(key[0], key[1], idx >> 32, idx & M32)
    assert (w0 ^ w1).tolist() == [_threefry_words(key, int(i)) for i in idx]


@pytest.mark.parametrize("shape", [(4, 1024), (3, 200), (257, 513)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_keyed_egress_ref_matches_ops(J, shape, dtype):
    """``lossy_link_egress_keyed_ref(key, x, ...)``, the keyed kernel's
    plain version, against the reference's ``ops.lossy_link_egress``: its
    ref on ``jax.random.uniform(key, (T, D))`` bit for bit, its kernel
    within 1e-5."""
    t, d = shape
    x, _, smin, smax = _egress_inputs(t * 7 + d, t, d)
    jq = J.QuantSpec(8, J.jnp.asarray(smin), J.jnp.asarray(smax))
    jx = J.jnp.asarray(x).astype(getattr(J.jnp, dtype))
    for seed in SEEDS:
        jkey = J.jax.random.PRNGKey(seed)
        got = lossy_link_egress_keyed_ref(prng.PRNGKey(seed), torch.tensor(x).to(_tdtype(dtype)),
                                          torch.tensor(smin), torch.tensor(smax), bits=8, loss_rate=0.3)
        u = J.jax.random.uniform(jkey, (t, d), J.jnp.float32)
        _bits_equal(_as_f32(J.ref.lossy_link_egress_ref(jx, u, jq.s_min, jq.s_max, bits=8, loss_rate=0.3)),
                    _as_f32(got))
        np.testing.assert_allclose(_as_f32(got), _as_f32(J.ops.lossy_link_egress(jkey, jx, jq, 0.3)),
                                   **KERNEL_TOL[dtype])


def test_kernel_path_draws_no_uniforms(monkeypatch):
    """The dispatch's kernel path hands the key itself to the wrapper and
    never calls ``prng.uniform``; the CPU path draws and defers to the
    keyed plain version."""
    calls = []
    monkeypatch.setattr(dispatch.runtime, "use_kernel", lambda t: True)
    monkeypatch.setattr(dispatch.cuda_kernel, "lossy_link_egress", lambda *a, **kw: calls.append((a, kw)) or a[1])
    monkeypatch.setattr(prng, "uniform", lambda *a, **kw: pytest.fail("prng.uniform on the kernel path"))
    key = prng.PRNGKey(4)
    q = TQuantSpec(8, torch.full((16,), -3.0), torch.full((16,), 3.0))
    lossy_link_egress(key, torch.randn(2, 1, 16), q, 0.1)
    (args, kw), = calls
    assert torch.equal(args[0], key) and tuple(args[1].shape) == (2, 16) and kw == dict(bits=8, loss_rate=0.1)


def test_egress_wrapper_refuses_non_partitionable(monkeypatch):
    """The kernel implements the partitionable threefry scheme only: with
    ``prng.DEFAULT_PARTITIONABLE`` False the wrapper raises, before any
    device check."""
    monkeypatch.setattr(prng, "DEFAULT_PARTITIONABLE", False)
    x = torch.zeros(2, 8)
    with pytest.raises(RuntimeError, match="partitionable"):
        cuda_kernel.lossy_link_egress(prng.PRNGKey(0), x, torch.zeros(8), torch.ones(8), bits=8, loss_rate=0.1)


@pytest.mark.parametrize("shape", [(1, 164), (4, 130), (17, 33)])
def test_dispatch_burst_mask_matches_ops(J, shape):
    """``burst_mask(key, R, N)``: the three draws of ``split(key, 3)`` are
    bit-equal to the reference's, and so are the masks."""
    r, n = shape
    ch = dict(p_gb=0.05, p_bg=0.25, loss_good=0.0, loss_bad=1.0)
    for seed in SEEDS:
        jkey = J.jax.random.PRNGKey(seed)
        jk = J.jax.random.split(jkey, 3)
        tk = prng.split(prng.PRNGKey(seed), 3)
        for i, s in enumerate(((r,), (r, n), (r, n))):
            _bits_equal(J.jax.random.uniform(jk[i], s, J.jnp.float32), prng.uniform(tk[i], s))
        _bits_equal(J.ops.burst_mask(jkey, r, n, **ch), burst_mask(prng.PRNGKey(seed), r, n, **ch))


def test_cpu_tensors_take_the_plain_versions():
    """CPU inputs never reach the CUDA wrappers (their counts stay put)."""
    before = (cuda_kernel.egress_launch_count, cuda_kernel.burst_launch_count)
    q = TQuantSpec(8, torch.full((16,), -3.0), torch.full((16,), 3.0))
    lossy_link_egress(prng.PRNGKey(0), torch.randn(2, 1, 16), q, 0.1)
    burst_mask(prng.PRNGKey(0), 2, 9, p_gb=0.1, p_bg=0.3)
    assert (cuda_kernel.egress_launch_count, cuda_kernel.burst_launch_count) == before


def test_cuda_wrappers_refuse_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernel.lossy_link_egress(prng.PRNGKey(0), x, torch.zeros(8), torch.ones(8), bits=8, loss_rate=0.1)
    with pytest.raises(ValueError, match="CUDA"):
        cuda_kernel.burst_mask(torch.zeros(2), x, x, **GE)


# ---------------------------------------------------------------------------
# core.comtune: LinkSpec(use_kernel=True)
# ---------------------------------------------------------------------------

def _specs(J, channel, loss=0.3, d=64, **kw):
    rng = np.random.default_rng(1)
    smin = (np.full((d,), -6.0) + rng.random(d) * 0.1).astype(np.float32)
    smax = (np.full((d,), 6.0) - rng.random(d) * 0.1).astype(np.float32)
    jc = J.Compressor(kind="quant", quant=J.QuantSpec(8, J.jnp.asarray(smin), J.jnp.asarray(smax)))
    tc = TCompressor(kind="quant", quant=TQuantSpec(8, torch.tensor(smin), torch.tensor(smax)))
    common = dict(loss_rate=loss, channel=channel, **kw)
    return J.comtune.LinkSpec(compressor=jc, **common), t_comtune.LinkSpec(compressor=tc, **common)


@pytest.mark.parametrize("shape", [(4, 200), (4, 1, 64), (1, 1, 1024)])
@pytest.mark.parametrize("shuffle", [True, False])
def test_ge_channel_link_kernel_path(J, shape, shuffle):
    """The twin of the reference's ``test_channel_link_ge_kernel_matches_
    reference_path``: with and without the burst-mask kernel, bit for bit,
    and equal to the reference's kernel path."""
    js, ts = _specs(J, "ge", shuffle=shuffle, use_kernel=True)
    for seed in SEEDS:
        x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
        key = prng.PRNGKey(seed + 7)
        got = t_comtune.channel_link(key, torch.tensor(x), ts)
        _bits_equal(t_comtune.channel_link(key, torch.tensor(x), dataclasses.replace(ts, use_kernel=False)), got)
        _bits_equal(J.comtune.channel_link(J.jax.random.PRNGKey(seed + 7), J.jnp.asarray(x), js), got)


@pytest.mark.parametrize("channel", ["iid", "ge"])
@pytest.mark.parametrize("shape", [(4, 1, 64), (2, 8, 64)], ids=["decode", "prefill"])
def test_emulate_link_serve_use_kernel(J, channel, shape):
    """``emulate_link("serve")`` under ``use_kernel``: a decode-shaped iid
    message takes the fused egress (equal to the reference's kernel within
    1e-5, and to its ``ref.py`` on the same draws bit for bit); GE and the
    streamed prefill take the channel path, bit-equal to the reference's."""
    js, ts = _specs(J, channel, use_kernel=True)
    for seed in SEEDS:
        x = (np.random.default_rng(seed).standard_normal(shape) * 3).astype(np.float32)
        jkey = J.jax.random.PRNGKey(seed)
        got = t_comtune.emulate_link(prng.PRNGKey(seed), torch.tensor(x), ts, "serve")
        want = J.comtune.emulate_link(jkey, J.jnp.asarray(x), js, "serve")
        if channel == "iid" and shape[1] == 1:
            np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL["float32"])
            u = J.jax.random.uniform(jkey, (shape[0], shape[2]), J.jnp.float32)
            q = js.compressor.quant
            oracle = J.ref.lossy_link_egress_ref(J.jnp.asarray(x).reshape(-1, shape[2]), u, q.s_min, q.s_max,
                                                 bits=8, loss_rate=0.3)
            _bits_equal(np.asarray(oracle).reshape(shape), got)
        else:
            _bits_equal(want, got)
            if channel == "ge":
                plain = t_comtune.emulate_link(prng.PRNGKey(seed), torch.tensor(x),
                                               dataclasses.replace(ts, use_kernel=False), "serve")
                _bits_equal(plain.numpy(), got)


@pytest.mark.parametrize("case", ["ge", "gilbert_elliott", "loss_rate_param", "identity", "iid"])
def test_egress_routing(J, case, monkeypatch):
    """Only a plain-iid quantized spec takes the egress: a stateful channel
    or a ``channel_params`` loss-rate override never does (``uses_net_path``
    as the reference's), nor does a compressor other than quant."""
    kw = dict(use_kernel=True)
    channel = "iid"
    if case in ("ge", "gilbert_elliott"):
        channel = case
    elif case == "loss_rate_param":
        kw["channel_params"] = (("loss_rate", 0.5),)
    js, ts = _specs(J, channel, **kw)
    if case == "identity":
        ts = dataclasses.replace(ts, compressor=TCompressor())
    assert ts.uses_net_path == js.uses_net_path == (case not in ("identity", "iid"))
    calls = []
    real = dispatch.lossy_link_egress
    monkeypatch.setattr(dispatch, "lossy_link_egress", lambda *a: calls.append(1) or real(*a))
    x = torch.tensor(np.random.default_rng(2).standard_normal((2, 1, 64)).astype(np.float32))
    t_comtune.emulate_link(prng.PRNGKey(0), x, ts, "serve")
    assert len(calls) == (1 if case == "iid" else 0)


def test_fec_never_takes_the_egress(J, monkeypatch):
    """An FEC link under ``use_kernel`` is on the net path: no egress launch,
    and the output of the reference's FEC branch, bit for bit."""
    js, ts = _specs(J, "iid", use_kernel=True, fec_m=2)
    assert ts.uses_net_path and js.uses_net_path
    calls = []
    real = dispatch.lossy_link_egress
    monkeypatch.setattr(dispatch, "lossy_link_egress", lambda *a: calls.append(1) or real(*a))
    for seed in SEEDS:
        x = (np.random.default_rng(seed).standard_normal((2, 1, 64)) * 3).astype(np.float32)
        got = t_comtune.emulate_link(prng.PRNGKey(seed), torch.tensor(x), ts, "serve")
        _bits_equal(J.comtune.emulate_link(J.jax.random.PRNGKey(seed), J.jnp.asarray(x), js, "serve"), got)
    assert calls == []


# ---------------------------------------------------------------------------
# The slice at reduced size: forward(link_spec=LinkSpec(use_kernel=True))
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _model(channel):
    import jax

    from repro.configs import ARCHITECTURES as J_ARCHS
    from repro.models import lm as j_lm
    from repro_torch.configs import ARCHITECTURES as T_ARCHS
    from repro_torch.models import lm as t_lm
    from repro_torch.params import params_from_jax

    cfgs = []
    for archs in (J_ARCHS, T_ARCHS):
        cfg = archs["qwen1.5-0.5b"].reduced(attn_impl="flash_decode")
        cfgs.append(cfg.with_updates(link=dataclasses.replace(cfg.link, loss_rate=0.3, channel=channel)))
    jcfg, tcfg = cfgs
    params = j_lm.init_lm(jax.random.PRNGKey(0), jcfg)
    model = t_lm.LM(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree_util.tree_map(np.asarray, params), tcfg))
    return jcfg, tcfg, params, model


def _kernel_specs(J, channel):
    return (J.comtune.LinkSpec(loss_rate=0.3, channel=channel, use_kernel=True),
            t_comtune.LinkSpec(loss_rate=0.3, channel=channel, use_kernel=True))


def _jax_loop(J, params, jcfg, prompts, n, seed, spec):
    from repro.models import cache as j_cache, lm as j_lm

    def fwd(p, tok, c, idx, k, mode):
        logits, c, _ = j_lm.forward(p, tok, jcfg, cache=c, cache_index=idx, link_key=k, link_mode="serve",
                                    link_spec=spec, mode=mode)
        return logits, c

    prefill = J.jax.jit(functools.partial(fwd, idx=0, mode="prefill"))
    step = J.jax.jit(functools.partial(fwd, mode="decode"))
    b, s = prompts.shape
    cache = j_cache.init_cache(jcfg, b, s + n)
    key, sub = J.jax.random.split(J.jax.random.PRNGKey(seed))
    logits, cache = prefill(params, J.jnp.asarray(prompts), cache, k=sub)
    token = J.jnp.argmax(logits[:, -1], axis=-1)[:, None].astype(J.jnp.int32)
    out = []
    for i in range(n):
        out.append(np.asarray(token))
        key, sub = J.jax.random.split(key)
        logits, cache = step(params, token, cache, J.jnp.int32(s + i), sub)
        token = J.jnp.argmax(logits[:, 0], axis=-1)[:, None].astype(J.jnp.int32)
    return np.concatenate(out, axis=1)


@torch.inference_mode()
def _torch_loop(model, tcfg, prompts, n, seed, spec):
    from repro_torch.models import cache as t_cache, lm as t_lm

    b, s = prompts.shape
    cache = t_cache.init_cache(tcfg, b, s + n, device="cpu")
    key, sub = prng.split(prng.PRNGKey(seed))
    logits, cache, _ = t_lm.forward(model, torch.tensor(prompts), tcfg, cache=cache, cache_index=0, link_key=sub,
                                    link_mode="serve", link_spec=spec)
    token = torch.argmax(logits[:, -1], dim=-1)[:, None].to(torch.int32)
    out = []
    for i in range(n):
        out.append(token)
        key, sub = prng.split(key)
        logits, cache, _ = t_lm.forward(model, token, tcfg, cache=cache, cache_index=s + i, link_key=sub,
                                        link_mode="serve", link_spec=spec)
        token = torch.argmax(logits[:, 0], dim=-1)[:, None].to(torch.int32)
    return torch.cat(out, dim=1).numpy()


@pytest.mark.parametrize("channel", ["iid", "ge"])
def test_slice_greedy_tokens_match_reference(J, channel):
    """Batch 2, prompt 8, 6 tokens, loss 0.3, the reference's weights: the
    prefill-plus-decode loop through ``forward(link_spec=LinkSpec(
    use_kernel=True))`` gives the reference loop's greedy tokens."""
    jcfg, tcfg, params, model = _model(channel)
    jspec, tspec = _kernel_specs(J, channel)
    prompts = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 8)).astype(np.int32)
    want = _jax_loop(J, params, jcfg, prompts, 6, 7, jspec)
    got = _torch_loop(model, tcfg, prompts, 6, 7, tspec)
    assert got.shape == (2, 6)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("channel", ["iid", "ge"])
@pytest.mark.parametrize("loss_rate", [None, 0.5])
def test_slotwise_link_fn_matches_reference(J, channel, loss_rate):
    """``make_slotwise_link_fn(..., loss_rate, link_spec)``: row for row the
    reference's (iid: its egress kernel, within 1e-5; GE: bit for bit), and
    bit for bit the port's batch-1 round under each row's key."""
    from repro.models import lm as j_lm
    from repro_torch.models import lm as t_lm

    jcfg, tcfg, params, model = _model(channel)
    jspec, tspec = _kernel_specs(J, channel)
    x = (np.random.default_rng(5).standard_normal((4, 1, tcfg.d_model)) * 3).astype(np.float32)
    jkeys = J.jax.random.split(J.jax.random.PRNGKey(9), 4)
    tkeys = torch.tensor(np.asarray(jkeys).astype(np.int64))
    want = j_lm.make_slotwise_link_fn(jcfg, params["link"], jkeys, "serve", loss_rate=loss_rate,
                                      link_spec=jspec)(J.jnp.asarray(x))
    got = t_lm.make_slotwise_link_fn(tcfg, model, tkeys, "serve", loss_rate=loss_rate, link_spec=tspec)(torch.tensor(x))
    if channel == "iid":
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL["float32"])
    else:
        _bits_equal(want, got)
    for i in range(4):
        row = t_lm.make_link_fn(tcfg, model, tkeys[i], "serve", loss_rate=loss_rate, link_spec=tspec)(
            torch.tensor(x[i:i + 1]))
        _bits_equal(row.numpy(), got[i:i + 1])


# ---------------------------------------------------------------------------
# On the card: each kernel against its plain version, bit for bit
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_egress_matches_plain(dtype):
    """The keyed kernel equals ``lossy_link_egress_keyed_ref`` bit for bit,
    and the draw on the card equals the draw on the CPU."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for (t, d), bits, loss in (((4, 1024), 8, 0.1), ((257, 513), 4, 0.8), ((1, 7), 1, 0.0), ((8, 1024), 16, 0.3)):
        key = prng.fold_in(prng.PRNGKey(5, "cuda"), t * d)
        x = (torch.randn((t, d), generator=gen, device="cuda") * 3).to(_tdtype(dtype))
        smin = torch.full((d,), -4.0, device="cuda") + torch.rand((d,), generator=gen, device="cuda") * 0.2
        smax = torch.full((d,), 4.0, device="cuda")
        before = cuda_kernel.egress_launch_count
        got = cuda_kernel.lossy_link_egress(key, x, smin, smax, bits=bits, loss_rate=loss)
        want = lossy_link_egress_keyed_ref(key, x, smin, smax, bits=bits, loss_rate=loss)
        torch.cuda.synchronize()
        assert cuda_kernel.egress_launch_count == before + 1
        assert torch.equal(got, want), (t, d, bits, loss)
        assert torch.equal(prng.uniform(key, (t, d)).cpu(), prng.uniform(key.cpu(), (t, d)))


@pytest.mark.usefixtures("hopper")
def test_cuda_burst_mask_matches_plain():
    gen = torch.Generator(device="cuda").manual_seed(1)
    for r, n in ((1, 164), (32, 164), (17, 256), (5, 130), (1, 1), (40, 600), (3, 31), (1, 33), (2, 4097)):
        ui, ul, ut = (torch.rand(s, generator=gen, device="cuda") for s in ((r,), (r, n), (r, n)))
        for kw in (GE, MAIN_GE):
            got = cuda_kernel.burst_mask(ui, ul, ut, **kw)
            want = burst_mask_ref(ui, ul, ut, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (r, n, kw)
            assert torch.equal(got, burst_mask_scan_ref(ui, ul, ut, **kw)), (r, n, kw)


@pytest.mark.usefixtures("hopper")
def test_cuda_dispatch_launches_the_kernels():
    key = prng.PRNGKey(3, "cuda")
    q = TQuantSpec(8, torch.full((64,), -3.0, device="cuda"), torch.full((64,), 3.0, device="cuda"))
    before = (cuda_kernel.egress_launch_count, cuda_kernel.burst_launch_count)
    x = torch.randn(2, 1, 64, device="cuda")
    got = lossy_link_egress(key, x, q, 0.2)
    m = burst_mask(key, 3, 50, p_gb=0.1, p_bg=0.3)
    assert (cuda_kernel.egress_launch_count, cuda_kernel.burst_launch_count) == (before[0] + 1, before[1] + 1)
    cpu = lossy_link_egress(key.cpu(), x.cpu(), TQuantSpec(8, q.s_min.cpu(), q.s_max.cpu()), 0.2)
    assert torch.equal(got.cpu(), cpu)
    assert torch.equal(m.cpu(), burst_mask(key.cpu(), 3, 50, p_gb=0.1, p_bg=0.3))
