"""The f32 flash-attention forward of the training path (the ``bf16x6``
body, ``csrc/flash_attention_bf16x6.cu``): its arithmetic emulated in torch
on the CPU, and, on an sm_90 card only, the kernel against its plain
version.

The body splits q, k and v into three bf16 planes (hi, mid, lo), forms S =
Q K^T as six bf16 products a product (the small plane pairs first, hi hi
last), runs the online softmax over tiles of the body's keys (64 at width
64, 32 at width 128) with the backward statistics kernel's arithmetic, and
forms each tile's P V as six products of P's three planes with V's.

Bars:
  * against the plain forward in f64, the f32 ``atol`` 2e-5 (the
    reference's kernel-vs-ref tolerance) and ``F32_FACTOR`` x the plain
    forward's own f32 distance from f64 over phase 2's grid, 2x at the
    training path's shape (``chip_smoke.py``'s ``F32_PATH_FACTOR``); three
    products (hi hi, hi mid, mid hi) miss the 2x bar;
  * its row statistics are, bit for bit, what the backward's statistics
    arithmetic forms on the same inputs, and within f32 rounding of the
    plain statistics in f64;
  * on the card: the ``atol`` against the plain version in f64, the same
    bits on a second call.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import cuda_kernel, gqa_flash_attention_ref  # noqa: E402
from test_torch_flash_attention import CHIP_GRID, TOL, zero_fill  # noqa: E402
from test_torch_flash_attention_bwd import PAIRS3, PAIRS6, _mm_planes  # noqa: E402

F32_FACTOR = 8.0        # phase 2's f32 bar (chip_smoke.py BWD_F32_FACTOR)
F32_PATH_FACTOR = 2.0   # chip_smoke.py phase 13's bar for the f32 path
LOG2E = np.float32(np.log2(np.e))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread, and restore the count
    after: its emulations are many small ops, which torch's per-process
    thread pool makes slower when several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (the kernels are built for sm_90a)")


def _exp2(x):
    """exp2 in f64, rounded to f32: no f32 ``torch.exp`` runs here (ROADMAP
    fault C2)."""
    return torch.exp2(x.double()).float()


def _tile(width):
    """Keys of a streamed tile: the forward's and the statistics kernel's."""
    return 64 if width <= 64 else 32


def _fold(q, k, v):
    g = q.shape[2] // k.shape[2]
    return (q.float().transpose(1, 2), k.float().repeat_interleave(g, 2).transpose(1, 2),
            v.float().repeat_interleave(g, 2).transpose(1, 2))


def _scales(hd):
    scale = np.float32(1.0) / np.sqrt(np.float32(hd))   # 1.0f / sqrtf(hd)
    return np.float32(scale), np.float32(scale * LOG2E)


def _visible(sq, k0, k1, causal, window, q_offset):
    qp = q_offset + torch.arange(sq)[:, None]
    kp = torch.arange(k0, k1)[None, :]
    ok = torch.ones((sq, k1 - k0), dtype=torch.bool)
    if causal:
        ok &= kp <= qp
    if window > 0:
        ok &= qp - kp < window
    return ok


def _logit2(s, scale, scale2, softcap):
    """The scaled, capped score in log2 units (the kernels' ``logit2``)."""
    if softcap > 0:
        return torch.tanh(s * scale / softcap) * np.float32(softcap) * LOG2E
    return s * scale2


def _p(s, m, scale, scale2, softcap):
    """exp2 of one FFMA s * scale2 - m (rounded once, as fmaf), or of the
    capped logit minus m (the kernels' ``prob``)."""
    if softcap > 0:
        return _exp2(_logit2(s, scale, scale2, softcap) - m)
    return _exp2(s.double() * float(scale2) - m.double())


def _emulate_bf16x6_fwd(q, k, v, *, causal, window, q_offset, softcap, pairs=PAIRS6, width=None):
    """The bf16x6 body's arithmetic in torch on the CPU: S = Q K^T in bf16
    planes (``pairs``; six by default) over each tile of the body's keys,
    the row max of the visible logits, l moved to it, p = exp2(x - m) of
    each visible element added into l, O moved to the new max and the
    tile's P V (P split into planes too) added, then O / max(l, 1e-20).
    ``width``: q, k and v zero-filled up to it, as the body runs a head dim
    below its width; the scale stays the true hd's.  Returns the output
    (B, Sq, H, hd) f32 and the statistics (2, B * H * Sq): m in log2 units
    (-inf for a row that sees no key) and l."""
    b, sq, h, hd = q.shape
    if width is not None:
        q, k, v = (zero_fill(x, width) for x in (q, k, v))
    skv = k.shape[1]
    qf, kf, vf = _fold(q, k, v)
    scale, scale2 = _scales(hd)
    tile = _tile(q.shape[-1])
    m = torch.full((b, h, sq), -torch.inf)
    l = torch.zeros((b, h, sq))
    o = torch.zeros((b, h, sq, q.shape[-1]))
    for k0 in range(0, skv, tile):
        k1 = min(k0 + tile, skv)
        s = _mm_planes(qf, kf[:, :, k0:k1].transpose(-1, -2), pairs)
        ok = _visible(sq, k0, k1, causal, window, q_offset)
        m_new = torch.maximum(m, torch.where(ok, _logit2(s, scale, scale2, softcap), -torch.inf).amax(-1))
        seen = m_new > -torch.inf
        corr = torch.where(seen, _exp2(m - m_new), 1.0)
        l = torch.where(seen, l * corr, l)
        p = torch.where(ok, _p(s, m_new[..., None], scale, scale2, softcap), 0.0)
        l = l + p.sum(-1)
        o = o * corr[..., None] + _mm_planes(p, vf[:, :, k0:k1], pairs)
        m = m_new
    l = torch.clamp(l, min=1e-20)
    out = (o / l[..., None]).transpose(1, 2)[..., :hd]
    return out, torch.stack([m.reshape(-1), l.reshape(-1)])


def _emulate_bwd_stats(q, k, *, causal, window, q_offset, softcap, width=None):
    """The backward statistics kernel's arithmetic (``fa_bwd_stats_bf16x6
    _kernel``), which the f32 backward ran before the forward wrote the
    statistics: S in six plane products over each of its key tiles; a
    tile's max of the visible logits; where the new max is finite, l times
    exp2(m - m_new); then each visible p = exp2(x - m) added.  Returns (2,
    B * H * Sq) f32."""
    b, sq, h, hd = q.shape
    if width is not None:
        q, k = (zero_fill(x, width) for x in (q, k))
    skv = k.shape[1]
    qf, kf, _ = _fold(q, k, k)
    scale, scale2 = _scales(hd)
    tile = _tile(q.shape[-1])
    m = torch.full((b, h, sq), -torch.inf)
    l = torch.zeros((b, h, sq))
    for k0 in range(0, skv, tile):
        k1 = min(k0 + tile, skv)
        s = _mm_planes(qf, kf[:, :, k0:k1].transpose(-1, -2), PAIRS6)
        ok = _visible(sq, k0, k1, causal, window, q_offset)
        x = torch.where(ok, _logit2(s, scale, scale2, softcap), -torch.inf)
        m_new = torch.maximum(m, x.amax(-1))
        fin = torch.isfinite(m_new)
        l = torch.where(fin, l * _exp2(m - m_new), l)
        l = l + torch.where(ok, _p(s, m_new[..., None], scale, scale2, softcap), 0.0).sum(-1)
        m = m_new
    return torch.stack([m.reshape(-1), torch.clamp(l, min=1e-20).reshape(-1)])


def _plain_stats64(q, k, *, causal, window, q_offset, softcap):
    """Each row's m (log2 units) and l of the plain scores in f64."""
    b, sq, h, hd = q.shape
    qf = q.double().transpose(1, 2)
    kf = k.double().repeat_interleave(h // k.shape[2], 2).transpose(1, 2)
    s = qf @ kf.transpose(-1, -2) / np.sqrt(hd)
    if softcap > 0:
        s = torch.tanh(s / softcap) * softcap
    x = torch.where(_visible(sq, 0, k.shape[1], causal, window, q_offset), s * np.log2(np.e), -torch.inf)
    m = x.amax(-1)
    l = torch.exp2(x - torch.where(torch.isfinite(m), m, 0.0)[..., None]).sum(-1)
    return m.reshape(-1), l.reshape(-1)


def _ratio(got, q, k, v, kw):
    """The output's max error against the plain forward in f64, and that
    over the plain forward's own f32 error against f64."""
    want64 = gqa_flash_attention_ref(q.double(), k.double(), v.double(), **kw)
    want32 = gqa_flash_attention_ref(q, k, v, **kw)
    err = float((got.double() - want64).abs().max())
    return err, err / float((want32.double() - want64).abs().max())


def _case(seed, b, sq, skv, h, kvh, hd):
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen)
    return mk(b, sq, h, hd), mk(b, skv, kvh, hd), mk(b, skv, kvh, hd)


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset", [c for c in CHIP_GRID if c[2] <= 128])
def test_bf16x6_fwd_arithmetic_meets_the_f32_bar(sq, skv, hd, causal, window, q_offset, g):
    """Over phase 2's grid at the body's head dims (hd 32 and 112 zero-
    filled to 64 and 128), G 1 and 2, softcap 0 and 30, the six products
    keep the output within the f32 ``atol`` of the plain forward in f64 and
    within ``F32_FACTOR`` x the plain f32 forward's own error."""
    q, k, v = _case(sq + skv + hd + g, 2, sq, skv, 2 * g, 2, hd)
    width = 64 if hd <= 64 else 128
    for softcap in (0.0, 30.0):
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        out, _ = _emulate_bf16x6_fwd(q, k, v, width=width if width != hd else None, **kw)
        err, ratio = _ratio(out, q, k, v, kw)
        assert err <= TOL["float32"] and ratio <= F32_FACTOR, (softcap, err, ratio)


# The training path's attention (B 4, H = KV = 16, hd 64, S 1024, causal),
# cut for the CPU: B 1, H = KV = 2, S 256.
TRAIN_CPU = (1, 256, 2, 64)


def test_bf16x6_fwd_meets_the_path_bar():
    """At the training path's attention shape, cut for the CPU, the six
    products keep the output within ``F32_PATH_FACTOR`` (2.0) of the plain
    forward's f32 error against f64: f32 accuracy."""
    b, s, h, hd = TRAIN_CPU
    q, k, v = _case(31, b, s, s, h, h, hd)
    kw = dict(causal=True, window=0, q_offset=0, softcap=0.0)
    err, ratio = _ratio(_emulate_bf16x6_fwd(q, k, v, **kw)[0], q, k, v, kw)
    assert ratio <= F32_PATH_FACTOR, (err, ratio)


def test_bf16x6_fwd_needs_the_second_order_terms():
    """The check has teeth: three products (hi hi, hi mid, mid hi) drop hi
    lo, lo hi and mid mid, of order 2**-16, and on the same inputs, where
    six meet the path bar (0.35x), they miss it more than four times over
    (12x)."""
    b, s, h, hd = TRAIN_CPU
    q, k, v = _case(31, b, s, s, h, h, hd)
    kw = dict(causal=True, window=0, q_offset=0, softcap=0.0)
    six = _ratio(_emulate_bf16x6_fwd(q, k, v, **kw)[0], q, k, v, kw)[1]
    three = _ratio(_emulate_bf16x6_fwd(q, k, v, pairs=PAIRS3, **kw)[0], q, k, v, kw)[1]
    assert six <= F32_PATH_FACTOR and three > 4 * F32_PATH_FACTOR, (six, three)


@pytest.mark.parametrize("hd,causal,window,q_offset,softcap", [
    (64, True, 0, 0, 0.0), (64, True, 100, 0, 30.0), (128, True, 0, 0, 0.0), (128, False, 0, 0, 30.0),
    (40, True, 64, 0, 0.0), (64, True, 128, 383, 0.0)])
def test_bf16x6_fwd_stats_equal_the_backward_statistics(hd, causal, window, q_offset, softcap):
    """The forward's m and l are the bits the backward's statistics
    arithmetic forms on the same inputs (the same six products, tiles and
    online steps, now beside O), so the backward can read them in place of
    its statistics kernel; and both are within f32 rounding of the plain
    statistics in f64 (a row that sees no key: m -inf in both)."""
    sq = 1 if q_offset else 300
    q, k, _ = _case(hd + window + q_offset, 2, sq, 384 if q_offset else 300, 4, 2, hd)
    v = torch.randn(k.shape, generator=torch.Generator().manual_seed(5))
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    width = 64 if hd <= 64 else 128
    _, stats = _emulate_bf16x6_fwd(q, k, v, width=width, **kw)
    assert torch.equal(stats, _emulate_bwd_stats(q, k, width=width, **kw))
    m64, l64 = _plain_stats64(q, k, **kw)
    seen = torch.isfinite(m64)
    assert torch.equal(torch.isfinite(stats[0]), seen)
    torch.testing.assert_close(stats[0][seen].double(), m64[seen], rtol=0, atol=1e-5)
    torch.testing.assert_close(stats[1][seen].double(), l64[seen], rtol=1e-5, atol=0)


def test_bf16x6_fwd_rows_that_see_no_key():
    """A window past a short query's keys leaves rows that see no key: the
    output is 0 there, m -inf and l 1e-20, as the statistics kernel writes
    them, and the other rows are unchanged."""
    q, k, v = _case(8, 1, 4, 8, 2, 2, 64)
    kw = dict(causal=True, window=2, q_offset=20, softcap=0.0)
    out, stats = _emulate_bf16x6_fwd(q, k, v, **kw)
    assert bool((out == 0).all()) and bool(torch.isinf(stats[0]).all()) and bool((stats[1] == 1e-20).all())
    assert torch.equal(stats, _emulate_bwd_stats(q, k, **kw))


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("hd", [36, 64, 112, 128])
def test_cuda_bf16x6_fwd_matches_plain(hd):
    """f32 asked for the row statistics runs the bf16x6 body (its counter
    moves, no other does; hd 36 zero-filled to 40 by the wrapper) within
    the f32 ``atol`` of the plain version in f64, its statistics within
    f32 rounding of the plain ones, and a second call gives the same bits:
    causal ragged, windowed with softcap, decode-shaped, non-causal, GQA, a
    1000-token prompt."""
    gen = torch.Generator(device="cuda").manual_seed(200 + hd)
    for sq, skv, g, causal, window, q_offset, softcap in (
            (300, 300, 2, True, 0, 0, 0.0), (300, 300, 1, True, 128, 0, 30.0), (1, 384, 2, True, 128, 383, 0.0),
            (130, 130, 1, False, 0, 0, 0.0), (1000, 1000, 2, True, 0, 0, 0.0), (70, 200, 1, True, 40, 100, 0.0)):
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda")
        q, k, v = mk(2, sq, 2 * g, hd), mk(2, skv, 2, hd), mk(2, skv, 2, hd)
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        before = dict(cuda_kernel.body_launch_count)
        got, stats = cuda_kernel.flash_attention(q, k, v, return_stats=True, **kw)
        assert cuda_kernel.body_launch_count == {**before, "bf16x6": before["bf16x6"] + 1}
        again, stats2 = cuda_kernel.flash_attention(q, k, v, return_stats=True, **kw)
        want64 = gqa_flash_attention_ref(q.double(), k.double(), v.double(), **kw)
        torch.cuda.synchronize()
        assert got.shape == q.shape and torch.equal(got, again) and torch.equal(stats, stats2)
        torch.testing.assert_close(got.double(), want64, rtol=0, atol=TOL["float32"],
                                   msg=lambda m: f"{(sq, skv, g, kw)}: {m}")
        m64, l64 = (x.cuda() for x in _plain_stats64(q.cpu(), k.cpu(), **kw))
        seen = torch.isfinite(m64)
        assert torch.equal(torch.isfinite(stats[0]), seen)
        torch.testing.assert_close(stats[0][seen].double(), m64[seen], rtol=0, atol=1e-5)
        torch.testing.assert_close(stats[1][seen].double(), l64[seen], rtol=1e-5, atol=0)


@pytest.mark.usefixtures("hopper")
def test_cuda_function_f32_takes_bf16x6_with_a_gradient():
    """An f32 sequence that requires grad runs the bf16x6 forward with
    statistics and the bf16x6 backward on them through
    ``FlashAttentionFunction``; under no_grad the forward is the serving
    body, 3xTF32, and writes none."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v = (torch.randn((2, 600, 4, 64), generator=gen, device="cuda").requires_grad_(True) for _ in range(3))
    before, bwd_before = dict(cuda_kernel.body_launch_count), dict(cuda_kernel.bwd_body_launch_count)
    from repro_torch.kernels.flash_attention import flash_attention

    out = flash_attention(q, k, v)
    assert out.grad_fn.saved_tensors[4].shape == (2, 2 * 4 * 600)
    out.square().sum().backward()
    assert cuda_kernel.body_launch_count == {**before, "bf16x6": before["bf16x6"] + 1}
    assert cuda_kernel.bwd_body_launch_count == {**bwd_before, "bf16x6": bwd_before["bf16x6"] + 1}
    assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v))
    before = dict(cuda_kernel.body_launch_count)
    with torch.no_grad():
        flash_attention(q, k, v)
    assert cuda_kernel.body_launch_count == {**before, "tf32x3": before["tf32x3"] + 1}
