"""The flash-attention backward: the plain version
(``flash_attention_bwd_ref``) against ``jax.vjp`` of the reference's
``repro.kernels.flash_attention.ref.flash_attention_ref`` and against
torch autograd of the plain forward in f64, the plumbing of
``FlashAttentionFunction`` by ``torch.autograd.gradcheck`` in f64, and, on
an sm_90 card only, the CUDA backward kernel against its plain version.

Bars:
  * against the reference's gradient in f32, ``atol=2e-5`` (the forward's
    own f32 bar, ``tests/test_kernels.py``); the differences are sums in
    another order, ~1e-6 of gradients of magnitude ~1-10;
  * against torch autograd in f64, ``atol=1e-12`` (one function, two
    orders of f64 operations);
  * on the card, each gradient within 8x the plain backward's own f32
    max error against f64 (``chip_smoke.py``'s ``BWD_F32_FACTOR``), and
    bf16 within one bf16 ulp of the plain backward in f32 plus 8x that
    noise; the bf16 tensor-core body's arithmetic (bf16 operands, exact
    products summed in f32, P and dS as bf16 hi + lo, the forward's m and
    l), emulated here, meets that bf16 bar, and without the lo terms
    misses it;
  * the plain backward fed the forward's statistics equals it without, to
    f32 rounding (``atol`` 2e-5, the f32 bar above).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    FlashAttentionFunction,
    cuda_kernel,
    flash_attention,
    flash_attention_bwd_ref,
    gqa_flash_attention_ref,
)
from test_torch_flash_attention import BF16_REL, CHIP_GRID, ZERO_FILL, _emulate_wgmma_body, zero_fill  # noqa: E402

# (sq, skv, hd, causal, window, q_offset): the forward tests' grid.
GRID = [
    (256, 256, 64, True, 0, 0),
    (256, 256, 64, True, 64, 0),
    (200, 200, 32, True, 0, 0),
    (1, 384, 64, True, 0, 383),      # decode
    (1, 384, 64, True, 128, 383),    # windowed decode
    (128, 128, 128, False, 0, 0),
]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread, and restore the count
    after: its steps are many small ops, which torch's per-process thread
    pool makes slower, not faster, when several test workers share the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def J():
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import ref

    return dataclasses.make_dataclass("J", ["jax", "jnp", "ref"])(jax, jnp, ref)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (the kernels are built for sm_90a)")


def _case(seed, b, sq, skv, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd), (b, sq, h, hd))]


def _jax_gqa(J, q, k, v, kw):
    """The reference's ref on the (B, S, H, hd) layout, KV heads repeated
    (as ``ops.py``), so its vjp sums dK and dV over each group."""
    b, sq, h, hd = q.shape
    g = h // k.shape[2]
    k, v = J.jnp.repeat(k, g, axis=2), J.jnp.repeat(v, g, axis=2)
    fold = lambda x: J.jnp.transpose(x, (0, 2, 1, 3)).reshape(b * h, -1, hd)
    out = J.ref.flash_attention_ref(fold(q), fold(k), fold(v), **kw)
    return J.jnp.transpose(out.reshape(b, h, sq, hd), (0, 2, 1, 3))


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset", GRID)
def test_bwd_ref_matches_reference_grad(J, sq, skv, hd, causal, window, q_offset, softcap, g):
    q, k, v, do = _case(sq + hd + g, 2, sq, skv, 2 * g, 2, hd)
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    _, vjp = J.jax.vjp(lambda a, b, c: _jax_gqa(J, a, b, c, kw), *(J.jnp.asarray(x) for x in (q, k, v)))
    want = vjp(J.jnp.asarray(do))
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    got = flash_attention_bwd_ref(tq, tk, tv, gqa_flash_attention_ref(tq, tk, tv, **kw), tdo, **kw)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == torch.float32 and tuple(a.shape) == w.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=0, atol=2e-5, err_msg=name)


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset,g", [
    (40, 40, 16, True, 0, 0, 2),
    (24, 40, 8, True, 12, 16, 1),     # q_offset, window, ragged against Skv
    (33, 17, 8, False, 0, 0, 3),
])
def test_bwd_ref_matches_autograd_f64(sq, skv, hd, causal, window, q_offset, g, softcap):
    q, k, v, do = (torch.tensor(x, dtype=torch.float64) for x in _case(sq * skv, 2, sq, skv, 2 * g, 2, hd))
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = gqa_flash_attention_ref(*leaves, **kw)
    want = torch.autograd.grad(out, leaves, do)
    got = flash_attention_bwd_ref(q, k, v, out.detach(), do, **kw)
    for a, w in zip(got, want):
        assert a.dtype == torch.float64
        torch.testing.assert_close(a, w, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kw,g", [
    (dict(causal=True), 2),
    (dict(causal=True, window=3, q_offset=4, softcap=5.0), 1),
    (dict(causal=False, softcap=2.0), 3),
])
def test_function_gradcheck_f64(kw, g):
    """``FlashAttentionFunction`` on the CPU: its backward is
    ``flash_attention_bwd_ref``, held to finite differences."""
    gen = torch.Generator().manual_seed(g)
    mk = lambda *s: torch.randn(s, generator=gen, dtype=torch.float64, requires_grad=True)
    q, k, v = mk(2, 6, 2 * g, 4), mk(2, 7, 2, 4), mk(2, 7, 2, 4)
    assert torch.autograd.gradcheck(lambda a, b, c: flash_attention(a, b, c, **kw), (q, k, v))


def test_function_double_backward_raises():
    q, k, v = (torch.randn(1, 5, 2, 4, dtype=torch.float64, requires_grad=True) for _ in range(3))
    out = FlashAttentionFunction.apply(q, k, v, True, 0, 0, 0.0)
    # square(): the output's gradient depends on q, so the graph goes on.
    (gq,) = torch.autograd.grad(out.square().sum(), q, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        gq.sum().backward()


def _emulate_kernel_dq(q, k, v, o, do, *, q_offset, window, softcap, tile):
    """One head's dQ as ``csrc/flash_attention_bwd.cu`` computes it, in f32:
    dot products as one FMA chain over hd, the row max and sum over 64-key
    tiles, p = exp(s - m) / l, D = dO . O, and dQ summed over ``tile``
    keys apart before each tile's sum joins the running one."""
    hd = q.shape[-1]
    chain = lambda a, b: sum((a[:, d:d + 1] * b[None, :, d] for d in range(1, hd)), a[:, :1] * b[None, :, 0])
    scale = torch.tensor(1.0 / np.sqrt(np.float32(hd)), dtype=torch.float32)
    x = chain(q, k) * scale
    t = torch.tanh(x / softcap)
    s = t * softcap
    qp, kp = q_offset + torch.arange(q.shape[0])[:, None], torch.arange(k.shape[0])[None, :]
    ok = (kp <= qp) & (qp - kp < window)
    s = torch.where(ok, s, torch.tensor(-1e30))
    m = torch.full((q.shape[0], 1), -1e30)
    l = torch.zeros((q.shape[0], 1))
    for c0 in range(0, k.shape[0], 64):
        blk = s[:, c0:c0 + 64]
        m_new = torch.maximum(m, blk.amax(-1, keepdim=True))
        l = l * torch.exp(m - m_new) + torch.where(ok[:, c0:c0 + 64], torch.exp(blk - m_new), 0.0).sum(-1, keepdim=True)
        m = m_new
    p = torch.where(ok, torch.exp(s - m) / l, 0.0)
    ds = p * (chain(do, v) - (do * o).sum(-1, keepdim=True)) * (1 - t * t)
    acc = torch.zeros_like(q)
    for c0 in range(0, k.shape[0], tile):
        part = torch.zeros_like(q)
        for c in range(c0, min(c0 + tile, k.shape[0])):
            part = part + ds[:, c:c + 1] * k[c]
        acc = acc + part
    return acc * scale


def test_bwd_kernel_arithmetic_meets_the_f32_bar():
    """The card's f32 bar for the backward (``chip_smoke.py``: each gradient
    within 8x the plain backward's own f32 max error against f64), on the
    kernel's dQ arithmetic emulated here at the decode-shaped grid case
    (Sq 1 over 384 keys, window 128, softcap 30) over 40 seeds.  Two
    maxima over 64 elements make a heavy-tailed ratio: correct f32
    arithmetic passes 4x somewhere among the seeds, so the bar is 8x; and
    the tiled sums keep the median near the plain backward's, where one
    FMA chain over the row's keys does not."""
    kw = dict(causal=True, window=128, q_offset=383, softcap=30.0)
    ratios = {64: [], 384: []}
    for seed in range(40):
        q, k, v, do = (torch.tensor(x)[0, :, 0] for x in _case(seed, 1, 1, 384, 1, 1, 64))
        Q, K, V, DO = (x[None, :, None, :] for x in (q, k, v, do))
        o = gqa_flash_attention_ref(Q, K, V, **kw)
        g32 = flash_attention_bwd_ref(Q, K, V, o, DO, **kw)[0][0, :, 0].double()
        g64 = flash_attention_bwd_ref(*(x.double() for x in (Q, K, V, o, DO)), **kw)[0][0, :, 0]
        noise = float((g32 - g64).abs().max())
        for tile in ratios:
            got = _emulate_kernel_dq(q, k, v, o[0, :, 0], do, q_offset=383, window=128, softcap=30.0, tile=tile)
            ratios[tile].append(float((got.double() - g64).abs().max()) / noise)
    tiled, chained = np.asarray(ratios[64]), np.asarray(ratios[384])
    assert tiled.max() <= 8.0 and np.median(tiled) <= 1.5
    assert tiled.max() > 4.0
    assert np.median(chained) > np.median(tiled)


def test_bwd_wrapper_rejects_cpu_and_bad_shapes():
    """The backward wrapper takes CUDA tensors only, checks the output and
    its gradient against q, and keeps the autograd guard."""
    q, k = torch.zeros((1, 4, 4, 32)), torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_kernel.flash_attention_bwd(q, k, k, q, q)
    with pytest.raises(ValueError, match="4-d"):
        cuda_kernel.flash_attention_bwd(q[0], k, k, q, q)
    with pytest.raises(RuntimeError, match="^flash_attention_bwd: .*gradient is not ported; "):
        cuda_kernel.flash_attention_bwd(q, k, k, q, q.clone().requires_grad_(True))


# ---------------------------------------------------------------------------
# The bf16 tensor-core backward (csrc/flash_attention_bwd_wgmma.cu), emulated
# ---------------------------------------------------------------------------

BWD_F32_FACTOR = 8.0   # chip_smoke.py's: the bf16 bar's noise multiple


def _hi_lo(x, lo=True):
    """x as bf16 hi + lo (lo = bf16(x - hi)), as the body's fragments hold
    P and dS; ``lo=False`` keeps hi alone."""
    hi = x.bfloat16().float()
    return hi, ((x - hi).bfloat16().float() if lo else torch.zeros_like(x))


def _emulate_wgmma_bwd(q, k, v, out, dout, stats, *, causal, window, q_offset, softcap, lo=True, width=None):
    """The wgmma backward's arithmetic in torch on the CPU: bf16 operands,
    their products exact and summed in f32; p = exp2(x - m) * (1 / l) from
    the forward's statistics with the forward's score arithmetic (x = s *
    scale * log2(e), or tanh(s * scale / cap) * cap * log2(e)); D =
    rowsum(dO * O) in f32; dS = p (dP - D) (1 - t^2); dV, dK and dQ each
    from P or dS as bf16 hi + lo (``lo=False`` drops lo), dK and dV summed
    over the group, scale applied to dK and dQ, each rounded once to bf16.
    ``width``: the operands zero-filled up to it, as the body runs a head
    dim below its width; the scale stays the true hd's and the gradients
    keep the true hd columns."""
    b, sq, h, hd = q.shape
    if width is not None:
        q, k, v, out, dout = (zero_fill(x, width) for x in (q, k, v, out, dout))
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    f = lambda x: x.float().transpose(1, 2)                                   # (B, heads, S, hd)
    qf, of, dof = f(q), f(out), f(dout)
    kf, vf = f(k).repeat_interleave(g, 1), f(v).repeat_interleave(g, 1)
    scale = np.float32(1.0 / np.sqrt(np.float32(hd)))
    s = qf @ kf.transpose(-1, -2)
    t = torch.tanh(s * scale / softcap) if softcap > 0 else torch.zeros_like(s)
    x = t * softcap * np.float32(np.log2(np.e)) if softcap > 0 else s * (scale * np.float32(np.log2(np.e)))
    m, l = (y.reshape(b, h, sq, 1) for y in stats)
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= qp - kp < window
    p = torch.where(ok, torch.exp2(x - torch.where(ok, m, 0.0)) * (1.0 / l), 0.0)
    d = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - d) * (1 - t * t)
    p_hi, p_lo = _hi_lo(p, lo)
    ds_hi, ds_lo = _hi_lo(ds, lo)
    dv = p_hi.transpose(-1, -2) @ dof + p_lo.transpose(-1, -2) @ dof
    dk = (ds_hi.transpose(-1, -2) @ qf + ds_lo.transpose(-1, -2) @ qf) * scale
    dq = (ds_hi @ kf + ds_lo @ kf) * scale
    group = lambda y: y.reshape(b, kvh, g, skv, -1).sum(2).transpose(1, 2)[..., :hd].bfloat16()
    return dq.transpose(1, 2)[..., :hd].bfloat16(), group(dk), group(dv)


def _bwd_bar_ratio(got, q, k, v, out, dout, kw):
    """Each gradient's worst |got - plain f32| over the bf16 bar (one bf16
    ulp of the plain f32 value + ``BWD_F32_FACTOR`` x the plain f32's max
    error against f64), as chip_smoke.py holds the kernel."""
    w32 = flash_attention_bwd_ref(*(x.float() for x in (q, k, v, out, dout)), **kw)
    w64 = flash_attention_bwd_ref(*(x.double() for x in (q, k, v, out, dout)), **kw)
    ratios = []
    for a, x32, x64 in zip(got, w32, w64):
        noise = float((x32.double() - x64).abs().max())
        ratios.append(float(((a.float() - x32).abs() / (BF16_REL * x32.abs() + BWD_F32_FACTOR * noise)).max()))
    return ratios


def _bf16_case(seed, sq, skv, hd, g):
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen).bfloat16()
    return mk(2, sq, 2 * g, hd), mk(2, skv, 2, hd), mk(2, skv, 2, hd), mk(2, sq, 2 * g, hd)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset", [c for c in CHIP_GRID if c[2] in (64, 128, 256)])
def test_wgmma_bwd_arithmetic_meets_the_bf16_bar(sq, skv, hd, causal, window, q_offset, g):
    """The design shown on the CPU: the wgmma backward's arithmetic, fed
    the wgmma forward's output and statistics (both emulated), keeps dQ,
    dK and dV within the bf16 bar phase 2 of chip_smoke.py holds the
    kernel to, over phase 2's grid at the body's head dims, G 1 and 2,
    softcap 0 and 30."""
    q, k, v, do = _bf16_case(sq + skv + hd + g, sq, skv, hd, g)
    for softcap in (0.0, 30.0):
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        out, stats = _emulate_wgmma_body(q, k, v, stats=True, **kw)
        got = _emulate_wgmma_bwd(q, k, v, out, do, stats, **kw)
        ratios = _bwd_bar_ratio(got, q, k, v, out, do, kw)
        assert max(ratios) <= 1.0, (softcap, ratios)


def test_wgmma_bwd_needs_the_lo_terms():
    """The check has teeth: with P and dS rounded once to bf16 (no lo
    parts) the same arithmetic misses the bar by far."""
    q, k, v, do = _bf16_case(5, 256, 256, 64, 1)
    kw = dict(causal=True, window=0, q_offset=0, softcap=0.0)
    out, stats = _emulate_wgmma_body(q, k, v, stats=True, **kw)
    assert max(_bwd_bar_ratio(_emulate_wgmma_bwd(q, k, v, out, do, stats, **kw), q, k, v, out, do, kw)) <= 1.0
    assert max(_bwd_bar_ratio(_emulate_wgmma_bwd(q, k, v, out, do, stats, lo=False, **kw), q, k, v, out, do,
                              kw)) > 4.0


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset,g", [
    (256, 256, 64, True, 64, 0, 2),
    (1, 384, 64, True, 128, 383, 1),
    (130, 130, 128, False, 0, 0, 1),
])
def test_bwd_ref_with_the_forwards_stats(sq, skv, hd, causal, window, q_offset, g, softcap):
    """``flash_attention_bwd_ref`` fed the wgmma forward's statistics
    (emulated: m in log2 units, l) equals it without, to f32 rounding."""
    q, k, v, do = (x.float() for x in _bf16_case(sq * g + hd, sq, skv, hd, g))
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    out, stats = _emulate_wgmma_body(q.bfloat16(), k.bfloat16(), v.bfloat16(), stats=True, **kw)
    out = out.float()
    assert stats.dtype == torch.float32 and tuple(stats.shape) == (2, 2 * 2 * g * sq)
    want = flash_attention_bwd_ref(q, k, v, out, do, **kw)
    got = flash_attention_bwd_ref(q, k, v, out, do, stats=stats, **kw)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256, 36])
def test_bwd_body_for(dtype, hd):
    """Every backward body is on the tensor cores: at every head dim up to
    256 (36 zero-filled to 40 by the wrapper) bf16 takes the wgmma body,
    which reads the forward's statistics, and f32 the same body in six
    bf16 products ("bf16x6"), which reads the bf16x6 forward's statistics
    up to hd 128 and forms its own past it.  A dtype no body takes raises;
    the CUDA-core body keeps its counter key but no route."""
    dt = getattr(torch, dtype)
    if dtype == "float16":
        with pytest.raises(ValueError):
            cuda_kernel.bwd_body_for(dt, hd)
        return
    want = "wgmma" if dtype == "bfloat16" else "bf16x6"
    assert cuda_kernel.bwd_body_for(dt, hd) == want
    assert cuda_kernel.bwd_reads_stats(dt, hd) == (dtype == "bfloat16" or cuda_kernel.padded_head_dim(hd) <= 128)
    assert set(cuda_kernel.bwd_body_launch_count) == {"wgmma", "bf16x6", "simt"}


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset", [c for c in CHIP_GRID if c[2] in ZERO_FILL])
def test_wgmma_bwd_zero_filled_equals_true_width(sq, skv, hd, causal, window, q_offset, g):
    """bf16 at hd 32 and kimi-k2's 112 runs on the wgmma backward at widths
    64 and 128, zero-filled past hd, fed the zero-filled forward's output
    and statistics: zeros add exactly 0 to every product, so the gradients
    are the bits of the same arithmetic at the true width, within the bf16
    bar of phase 2."""
    q, k, v, do = _bf16_case(sq + skv + hd + g, sq, skv, hd, g)
    for softcap in (0.0, 30.0):
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        out, stats = _emulate_wgmma_body(q, k, v, stats=True, width=ZERO_FILL[hd], **kw)
        got = _emulate_wgmma_bwd(q, k, v, out, do, stats, width=ZERO_FILL[hd], **kw)
        want = _emulate_wgmma_bwd(q, k, v, out, do, stats, **kw)
        assert all(a.shape == w.shape and torch.equal(a, w) for a, w in zip(got, want))
        assert max(_bwd_bar_ratio(got, q, k, v, out, do, kw)) <= 1.0, softcap


# ---------------------------------------------------------------------------
# The f32 tensor-core backward (the same body in six bf16 products), emulated
# ---------------------------------------------------------------------------

# The plane pairs (A, B) of a product, in the body's order: the small ones
# first, hi * hi last.  Six: mid mid, hi lo, lo hi, hi mid, mid hi, hi hi;
# three keep hi mid, mid hi and hi hi alone.
PAIRS6 = ((1, 1), (0, 2), (2, 0), (0, 1), (1, 0), (0, 0))
PAIRS3 = ((0, 1), (1, 0), (0, 0))
BWD_PATH_FACTOR = 2.0   # chip_smoke.py's bar for the backward kernel on the training path


def _planes(x):
    """f32 x as three bf16 planes (as f32 tensors): hi = bf16(x), mid =
    bf16(x - hi), lo = bf16(x - hi - mid), the differences exact."""
    hi = x.bfloat16().float()
    mid = (x - hi).bfloat16().float()
    return hi, mid, (x - hi - mid).bfloat16().float()


def _mm_planes(a, b, pairs):
    """``a @ b`` as the f32 body forms it: bf16 plane products (exact in
    f32) summed in f32, the small pairs first, then hi * hi."""
    pa, pb = _planes(a), _planes(b)
    small = torch.zeros(())
    for i, j in pairs[:-1]:
        small = small + pa[i] @ pb[j]
    return small + pa[pairs[-1][0]] @ pb[pairs[-1][1]]


def _emulate_bf16x6_bwd(q, k, v, out, dout, *, causal, window, q_offset, softcap, pairs=PAIRS6, width=None):
    """The f32 backward body's arithmetic in torch on the CPU: every product
    in bf16 planes (``pairs``; six by default), its own row statistics from
    that S (m in log2 units over the visible keys, l = sum exp2(x - m)), p
    = exp2(x - m) * (1 / l), D = rowsum(dO * O) in f32, dS = p (dP - D) (1
    - t^2), dV, dK and dQ in planes too, dK and dV summed over the group.
    exp2 is taken in f64 and rounded to f32, so no f32 ``torch.exp`` runs
    here (ROADMAP fault C2).  ``width``: the operands zero-filled up to it,
    as the body runs a head dim below its width; the scale stays the true
    hd's and the gradients keep the true hd columns."""
    b, sq, h, hd = q.shape
    if width is not None:
        q, k, v, out, dout = (zero_fill(x, width) for x in (q, k, v, out, dout))
        dq, dk, dv = _emulate_bf16x6_bwd_at(q, k, v, out, dout, causal=causal, window=window, q_offset=q_offset,
                                            softcap=softcap, pairs=pairs, scale_hd=hd)
        return dq[..., :hd], dk[..., :hd], dv[..., :hd]
    return _emulate_bf16x6_bwd_at(q, k, v, out, dout, causal=causal, window=window, q_offset=q_offset,
                                  softcap=softcap, pairs=pairs, scale_hd=hd)


def _emulate_bf16x6_bwd_at(q, k, v, out, dout, *, causal, window, q_offset, softcap, pairs, scale_hd):
    """``_emulate_bf16x6_bwd`` at the operands' width, the scale taken at
    ``scale_hd``."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    f = lambda x: x.float().transpose(1, 2)
    qf, of, dof = f(q), f(out), f(dout)
    kf, vf = f(k).repeat_interleave(g, 1), f(v).repeat_interleave(g, 1)
    mm = lambda a, c: _mm_planes(a, c, pairs)
    exp2 = lambda x: torch.exp2(x.double()).float()
    scale = np.float32(1.0 / np.sqrt(np.float32(scale_hd)))
    log2e = np.float32(np.log2(np.e))
    s = mm(qf, kf.transpose(-1, -2))
    t = torch.tanh(s * scale / softcap) if softcap > 0 else torch.zeros_like(s)
    x = t * softcap * log2e if softcap > 0 else s * (scale * log2e)
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(skv)[None, :]
    ok = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= qp - kp < window
    m = torch.where(ok, x, -torch.inf).amax(-1, keepdim=True)
    m = torch.where(torch.isinf(m), 0.0, m)
    e = torch.where(ok, exp2(x - m), 0.0)
    p = e * (1.0 / torch.clamp(e.sum(-1, keepdim=True), min=1e-20))
    d = (dof * of).sum(-1, keepdim=True)
    ds = p * (mm(dof, vf.transpose(-1, -2)) - d) * (1 - t * t)
    dv = mm(p.transpose(-1, -2), dof)
    dk = mm(ds.transpose(-1, -2), qf) * scale
    dq = mm(ds, kf) * scale
    group = lambda y: y.reshape(b, kvh, g, skv, hd).sum(2).transpose(1, 2)
    return dq.transpose(1, 2), group(dk), group(dv)


def _f32_bar_ratios(got, q, k, v, out, dout, kw):
    """Each gradient's max error against the plain backward in f64, over the
    plain backward's own f32 max error against f64 (phase 2's f32 bar)."""
    w32 = flash_attention_bwd_ref(q, k, v, out, dout, **kw)
    w64 = flash_attention_bwd_ref(*(x.double() for x in (q, k, v, out, dout)), **kw)
    return [float((a.double() - x64).abs().max()) / float((x32.double() - x64).abs().max())
            for a, x32, x64 in zip(got, w32, w64)]


def _f32_case(seed, b, sq, skv, h, kvh, hd):
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen)
    return mk(b, sq, h, hd), mk(b, skv, kvh, hd), mk(b, skv, kvh, hd), mk(b, sq, h, hd)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset", [c for c in CHIP_GRID if c[2] <= 128])
def test_bf16x6_bwd_arithmetic_meets_the_f32_bar(sq, skv, hd, causal, window, q_offset, g):
    """The f32 design shown on the CPU: six bf16 products a product, fed
    the plain forward's output, keeps dQ, dK and dV within
    ``BWD_F32_FACTOR`` x the plain backward's own f32 error against f64,
    the bar phase 2 of chip_smoke.py holds the kernel to, over phase 2's
    grid at the body's head dims, G 1 and 2, softcap 0 and 30."""
    q, k, v, do = _f32_case(sq + skv + hd + g, 2, sq, skv, 2 * g, 2, hd)
    for softcap in (0.0, 30.0):
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        out = gqa_flash_attention_ref(q, k, v, **kw)
        ratios = _f32_bar_ratios(_emulate_bf16x6_bwd(q, k, v, out, do, **kw), q, k, v, out, do, kw)
        assert max(ratios) <= BWD_F32_FACTOR, (softcap, ratios)


# The training path's attention (B 4, H = KV = 16, hd 64, S 1024, causal),
# cut for the CPU: B 1, H = KV = 2, S 256.
TRAIN_CPU = (1, 256, 2, 64)


def test_bf16x6_bwd_meets_the_path_bar():
    """At the training path's attention shape, cut for the CPU, the six
    products keep each gradient within ``BWD_PATH_FACTOR`` (2.0) of the
    plain backward's f32 error against f64: f32 accuracy, not just 8x."""
    b, s, h, hd = TRAIN_CPU
    q, k, v, do = _f32_case(21, b, s, s, h, h, hd)
    out = gqa_flash_attention_ref(q, k, v)
    ratios = _f32_bar_ratios(_emulate_bf16x6_bwd(q, k, v, out, do, causal=True, window=0, q_offset=0, softcap=0.0),
                             q, k, v, out, do, {})
    assert max(ratios) <= BWD_PATH_FACTOR, ratios


def test_bf16x6_bwd_needs_the_second_order_terms():
    """The check has teeth: three products (hi hi, hi mid, mid hi) drop hi
    lo, lo hi and mid mid, of order 2**-16, and on the same inputs, where
    six meet the path bar, every gradient misses it and dQ misses phase 2's
    8x too (dV least: its plain f32 error is mostly P's, carried from S)."""
    b, s, h, hd = TRAIN_CPU
    q, k, v, do = _f32_case(21, b, s, s, h, h, hd)
    out = gqa_flash_attention_ref(q, k, v)
    kw = dict(causal=True, window=0, q_offset=0, softcap=0.0)
    six = _f32_bar_ratios(_emulate_bf16x6_bwd(q, k, v, out, do, **kw), q, k, v, out, do, {})
    three = _f32_bar_ratios(_emulate_bf16x6_bwd(q, k, v, out, do, pairs=PAIRS3, **kw), q, k, v, out, do, {})
    assert max(six) <= BWD_PATH_FACTOR, six
    assert min(three) > BWD_PATH_FACTOR and max(three) > 2 * BWD_F32_FACTOR, three


def test_function_cpu_saves_no_stats():
    """On the CPU ``FlashAttentionFunction`` runs the plain versions: the
    backward recomputes P by a softmax (no statistics saved) and matches
    autograd of the plain forward."""
    gen = torch.Generator().manual_seed(4)
    q, k, v = (torch.randn((1, 70, 2, 64), generator=gen, requires_grad=True) for _ in range(3))
    out = flash_attention(q, k, v, window=16)
    assert out.grad_fn.saved_tensors[4] is None
    gq, gk, gv = torch.autograd.grad(out.square().sum(), (q, k, v))
    leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
    want = torch.autograd.grad(gqa_flash_attention_ref(*leaves, window=16).square().sum(), leaves)
    for a, w in zip((gq, gk, gv), want):
        torch.testing.assert_close(a, w, rtol=0, atol=2e-5)


# ---------------------------------------------------------------------------
# On the card: the backward kernel against its plain version
# ---------------------------------------------------------------------------

def _forward_for_bwd(q, k, v, kw):
    """The forward kernel's output and, where the backward reads them, its
    row statistics, as ``FlashAttentionFunction`` saves them."""
    with torch.no_grad():
        if cuda_kernel.bwd_reads_stats(q.dtype, q.shape[-1]):
            return cuda_kernel.flash_attention(q, k, v, return_stats=True, **kw)
        return cuda_kernel.flash_attention(q, k, v, **kw), None


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_bwd_kernel_matches_plain(dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    tdt = getattr(torch, dtype)
    cases = [(sq, skv, hd, 1, c, w, o) for sq, skv, hd, c, w, o in GRID]
    cases += [(1000, 1000, 64, 2, True, 0, 0), (300, 300, 256, 2, True, 128, 0), (130, 130, 256, 1, False, 0, 0)]
    for sq, skv, hd, g, causal, window, q_offset in cases:
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(tdt)
        q, k, v, do = mk(2, sq, 2 * g, hd), mk(2, skv, 2, hd), mk(2, skv, 2, hd), mk(2, sq, 2 * g, hd)
        for softcap in (0.0, 30.0):
            kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
            out, stats = _forward_for_bwd(q, k, v, kw)
            before = cuda_kernel.bwd_launch_count
            got = cuda_kernel.flash_attention_bwd(q, k, v, out, do, stats=stats, **kw)
            assert cuda_kernel.bwd_launch_count == before + 1
            w32 = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out, do)), **kw)
            w64 = flash_attention_bwd_ref(*(t.double() for t in (q, k, v, out, do)), **kw)
            for a, x32, x64 in zip(got, w32, w64):
                noise = float((x32.double() - x64).abs().max())
                assert a.dtype == tdt
                if tdt == torch.float32:
                    assert float((a.double() - x64).abs().max()) <= 8.0 * noise, (sq, skv, hd, g, kw)
                else:
                    bar = 2.0 ** -7 * x32.abs() + 8.0 * noise
                    assert bool(((a.float() - x32).abs() <= bar).all()), (sq, skv, hd, g, kw)


@pytest.mark.usefixtures("hopper")
def test_cuda_function_runs_both_kernels():
    """A sequence that requires grad on the card runs the forward and the
    backward kernel through ``FlashAttentionFunction``, one launch each."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (torch.randn((2, 600, 4, 64), generator=gen, device="cuda", requires_grad=True) for _ in range(3))
    fwd, bwd = cuda_kernel.launch_count, cuda_kernel.bwd_launch_count
    out = flash_attention(q, k, v)
    out.square().sum().backward()
    assert (cuda_kernel.launch_count - fwd, cuda_kernel.bwd_launch_count - bwd) == (1, 1)
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cuda_wgmma_bwd_matches_plain(hd):
    """bf16 at hd 64 / 128 / 256 runs the wgmma backward (its counter
    moves, the CUDA-core body's does not) on the forward's statistics, and
    dQ, dK, dV stay within the bf16 bar of the plain backward in f32:
    causal ragged, windowed with softcap, decode-shaped, non-causal, GQA,
    a 1000-token prompt, a q_offset past Skv's reach."""
    gen = torch.Generator(device="cuda").manual_seed(hd)
    for sq, skv, g, causal, window, q_offset, softcap in (
            (300, 300, 2, True, 0, 0, 0.0), (300, 300, 1, True, 128, 0, 30.0), (1, 384, 2, True, 128, 383, 0.0),
            (130, 130, 1, False, 0, 0, 0.0), (1000, 1000, 2, True, 0, 0, 0.0), (70, 200, 1, True, 40, 100, 0.0)):
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
        q, k, v, do = mk(2, sq, 2 * g, hd), mk(2, skv, 2, hd), mk(2, skv, 2, hd), mk(2, sq, 2 * g, hd)
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        out, stats = _forward_for_bwd(q, k, v, kw)
        assert stats.shape == (2, 2 * 2 * g * sq) and bool(torch.isfinite(stats[1]).all())
        before = dict(cuda_kernel.bwd_body_launch_count)
        got = cuda_kernel.flash_attention_bwd(q, k, v, out, do, stats=stats, **kw)
        assert cuda_kernel.bwd_body_launch_count == {**before, "wgmma": before["wgmma"] + 1}
        torch.cuda.synchronize()
        ratios = _bwd_bar_ratio(got, q, k, v, out, do, kw)
        assert max(ratios) <= 1.0, (sq, skv, g, kw, ratios)


@pytest.mark.usefixtures("hopper")
def test_cuda_wgmma_bwd_is_deterministic():
    """No atomics: two calls on the same inputs give the same bits."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    q, k, v, do = mk(2, 700, 4, 64), mk(2, 700, 2, 64), mk(2, 700, 2, 64), mk(2, 700, 4, 64)
    out, stats = _forward_for_bwd(q, k, v, {})
    first = cuda_kernel.flash_attention_bwd(q, k, v, out, do, stats=stats)
    second = cuda_kernel.flash_attention_bwd(q, k, v, out, do, stats=stats)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.usefixtures("hopper")
def test_cuda_wgmma_forward_stats_match_plain():
    """The wgmma forward's m (log2 units) and l against the same row
    statistics of the plain scores in f32; serving (no statistics) gives
    the same output bits."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
    q, k, v = mk(2, 300, 4, 64), mk(2, 300, 2, 64), mk(2, 300, 2, 64)
    kw = dict(causal=True, window=100)
    out, stats = cuda_kernel.flash_attention(q, k, v, return_stats=True, **kw)
    assert torch.equal(out, cuda_kernel.flash_attention(q, k, v, **kw))
    qf, kf = q.float().transpose(1, 2), k.float().repeat_interleave(2, 2).transpose(1, 2)
    pos = torch.arange(300, device="cuda")
    ok = (pos[None, :] <= pos[:, None]) & (pos[:, None] - pos[None, :] < 100)
    x = torch.where(ok, qf @ kf.transpose(-1, -2) / 8.0 * np.log2(np.e), -torch.inf)
    m = x.amax(-1)
    l = torch.exp2(x - m[..., None]).sum(-1)
    torch.testing.assert_close(stats[0], m.reshape(-1), rtol=0, atol=1e-4)
    torch.testing.assert_close(stats[1], l.reshape(-1), rtol=1e-4, atol=0)


@pytest.mark.usefixtures("hopper")
def test_cuda_function_bf16_uses_the_forwards_stats():
    """A bf16 sequence that requires grad runs the wgmma forward with
    statistics and the wgmma backward through ``FlashAttentionFunction``;
    under no_grad the forward writes none."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((2, 600, 4, 64), generator=gen, device="cuda").bfloat16().requires_grad_(True)
               for _ in range(3))
    before = dict(cuda_kernel.bwd_body_launch_count)
    out = flash_attention(q, k, v)
    assert out.grad_fn.saved_tensors[4].shape == (2, 2 * 4 * 600)
    out.float().square().sum().backward()
    assert cuda_kernel.bwd_body_launch_count == {**before, "wgmma": before["wgmma"] + 1}
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    with torch.no_grad():
        assert flash_attention(q, k, v).grad_fn is None


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("hd", sorted(ZERO_FILL))
def test_cuda_wgmma_bwd_zero_filled(hd):
    """bf16 at hd 32 and kimi-k2's 112 runs the wgmma backward, zero-filled
    to its next width, on the forward's statistics (its counter moves, the
    CUDA-core body's does not), within the bf16 bar of the plain backward
    in f32."""
    gen = torch.Generator(device="cuda").manual_seed(hd)
    for b, sq, h, kvh, causal, window, q_offset, softcap in (
            (2, 300, 4, 2, True, 0, 0, 0.0), (2, 300, 2, 2, True, 128, 0, 30.0), (2, 1, 4, 2, True, 128, 383, 0.0),
            (2, 130, 2, 2, False, 0, 0, 0.0), (1, 1024, 64, 8, True, 0, 0, 0.0)):
        skv = 384 if q_offset else sq
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda").bfloat16()
        q, k, v, do = mk(b, sq, h, hd), mk(b, skv, kvh, hd), mk(b, skv, kvh, hd), mk(b, sq, h, hd)
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        out, stats = _forward_for_bwd(q, k, v, kw)
        before = dict(cuda_kernel.bwd_body_launch_count)
        got = cuda_kernel.flash_attention_bwd(q, k, v, out, do, stats=stats, **kw)
        assert cuda_kernel.bwd_body_launch_count == {**before, "wgmma": before["wgmma"] + 1}
        torch.cuda.synchronize()
        assert all(a.shape == t.shape for a, t in zip(got, (q, k, v)))
        ratios = _bwd_bar_ratio(got, q, k, v, out, do, kw)
        assert max(ratios) <= 1.0, (b, sq, h, kvh, kw, ratios)


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("hd", [32, 64, 112, 128])
def test_cuda_bf16x6_bwd_matches_plain(hd):
    """f32 at hd 32 / 64 / 112 / 128 runs the six-product tensor-core
    backward (its counter moves, no other does) on the bf16x6 forward's
    statistics, each gradient within ``BWD_F32_FACTOR`` x the plain
    backward's own f32 error against f64, and a second call gives the same
    bits."""
    gen = torch.Generator(device="cuda").manual_seed(100 + hd)
    for sq, skv, g, causal, window, q_offset, softcap in (
            (300, 300, 2, True, 0, 0, 0.0), (300, 300, 1, True, 128, 0, 30.0), (1, 384, 2, True, 128, 383, 0.0),
            (130, 130, 1, False, 0, 0, 0.0), (1000, 1000, 2, True, 0, 0, 0.0), (70, 200, 1, True, 40, 100, 0.0)):
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda")
        q, k, v, do = mk(2, sq, 2 * g, hd), mk(2, skv, 2, hd), mk(2, skv, 2, hd), mk(2, sq, 2 * g, hd)
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        out, stats = _forward_for_bwd(q, k, v, kw)
        assert stats is not None and stats.shape == (2, 2 * 2 * g * sq)
        before = dict(cuda_kernel.bwd_body_launch_count)
        got = cuda_kernel.flash_attention_bwd(q, k, v, out, do, stats=stats, **kw)
        assert cuda_kernel.bwd_body_launch_count == {**before, "bf16x6": before["bf16x6"] + 1}
        again = cuda_kernel.flash_attention_bwd(q, k, v, out, do, stats=stats, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        ratios = _f32_bar_ratios(got, q, k, v, out, do, kw)
        assert max(ratios) <= BWD_F32_FACTOR, (sq, skv, g, kw, ratios)


@pytest.mark.usefixtures("hopper")
def test_cuda_tensor_map_kernels_on_a_fresh_thread():
    """A host thread that has made no CUDA call has no current context, as
    autograd's device thread may not when a backward's first CUDA work is
    the kernel and the allocator serves from cache; the tensor-map encoder
    then failed with CUDA_ERROR_INVALID_CONTEXT.  The TMA bodies' C entry
    points, called first thing on a new thread with buffers made on this
    one, bind the device's context and give this thread's bits."""
    import threading

    gen = torch.Generator(device="cuda").manual_seed(6)
    b, s, h, kvh, hd = 2, 300, 4, 2, 64
    bf = lambda *sh: torch.randn(sh, generator=gen, device="cuda").bfloat16()
    q, k, v, do = bf(b, s, h, hd), bf(b, s, kvh, hd), bf(b, s, kvh, hd), bf(b, s, h, hd)
    q32, k32, v32, do32 = (x.float() for x in (q, k, v, do))
    out, stats = cuda_kernel.flash_attention(q, k, v, return_stats=True)
    out32, stats32 = cuda_kernel.flash_attention(q32, k32, v32, return_stats=True)
    want = (cuda_kernel.flash_attention(q, k, v), *cuda_kernel.flash_attention_bwd(q, k, v, out, do, stats=stats),
            *cuda_kernel.flash_attention_bwd(q32, k32, v32, out32, do32, stats=stats32), out32, stats32)
    lib = cuda_kernel._library()
    rec = torch.empty(lib.flash_attention_bwd_wgmma_scratch(b, h, s), dtype=torch.float32, device="cuda")
    scratch = torch.empty(lib.flash_attention_bwd_bf16x6_scratch(b, s, s, h, kvh, hd), dtype=torch.uint8,
                          device="cuda")
    fwd_scratch = torch.empty(lib.flash_attention_bf16x6_scratch(b, s, s, h, kvh, hd), dtype=torch.uint8,
                              device="cuda")
    got = [torch.empty_like(x) for x in want]
    stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    dims, flags = (b, s, s, h, kvh, hd, hd), (1, 0, 0, 0.0, stream)
    errs = []

    def run():
        ptr = lambda x: x.data_ptr()
        errs.append(lib.flash_attention_wgmma_launch(ptr(q), ptr(k), ptr(v), ptr(got[0]), None, *dims, *flags))
        errs.append(lib.flash_attention_bwd_wgmma_launch(
            ptr(q), ptr(k), ptr(v), ptr(out), ptr(do), ptr(stats), ptr(rec), *map(ptr, got[1:4]), *dims, *flags))
        errs.append(lib.flash_attention_bwd_bf16x6_launch(
            ptr(q32), ptr(k32), ptr(v32), ptr(out32), ptr(do32), ptr(stats32), ptr(scratch), *map(ptr, got[4:7]),
            *dims, *flags))
        errs.append(lib.flash_attention_bf16x6_launch(ptr(q32), ptr(k32), ptr(v32), ptr(got[7]), ptr(got[8]),
                                                      ptr(fwd_scratch), *dims, *flags))

    worker = threading.Thread(target=run)
    worker.start()
    worker.join()
    torch.cuda.synchronize()
    assert errs == [0, 0, 0, 0], [lib.flash_attention_bwd_wgmma_error_string(e).decode() for e in errs]
    assert all(torch.equal(a, w) for a, w in zip(got, want))
