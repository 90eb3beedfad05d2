"""Flash attention at head dims that are not multiples of 8 (the
``repro_torch.kernels.flash_attention`` wrapper's zero fill): TMA and the
16-byte copies need rows whose stride is a multiple of 16 bytes, so the
wrapper copies q, k and v (and, for the backward, the output and its
gradient) into zero-filled tensors at the next multiple of 8 and runs the
tensor-core bodies there with the true head dim's scale; zero columns add
exactly 0 to every product.

On the CPU: the wrapper's width and copy, and each body's arithmetic at the
padded route (hd 36 zero-filled to 40 by the wrapper, then to the body's
width 64 by the tensor maps) equal the same arithmetic at the true width
with the true hd's scale -- bf16 on the wgmma forward and backward, f32 on
the bf16x6 forward and backward -- and meet their bars against the plain
versions.  "Equal" up to the order in which the CPU's BLAS sums a product
at another width: within 16 f32 ulps of each tensor's largest value, and
bf16 values within one bf16 ulp (the card's kernel runs hd 36 at width 64
either way).  On an sm_90 card only: the wrapper's padded
route against the plain versions, forward and backward, and f32 at hd 256
backward (gemma3-12b's head dim: the slab kernels).
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    cuda_kernel,
    flash_attention,
    flash_attention_bwd_ref,
    gqa_flash_attention_ref,
)
from test_torch_flash_attention import TOL, _emulate_wgmma_body, _ulp_ratio, zero_fill  # noqa: E402
from test_torch_flash_attention_bf16x6_fwd import _emulate_bf16x6_fwd, _ratio  # noqa: E402
from test_torch_flash_attention_bwd import (  # noqa: E402
    BWD_F32_FACTOR,
    _bwd_bar_ratio,
    _emulate_bf16x6_bwd,
    _emulate_wgmma_bwd,
    _f32_bar_ratios,
)

PAD_HD = 36      # no model has it; the wrapper zero-fills it to 40, the maps to the body's 64
BODY_WIDTH = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run this module's torch ops on one thread, and restore the count
    after (many small ops; see the other emulation modules)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (the kernels are built for sm_90a)")


@pytest.mark.parametrize("hd,want", [(1, 8), (8, 8), (20, 24), (36, 40), (64, 64), (100, 104), (112, 112),
                                     (129, 136), (250, 256), (256, 256)])
def test_padded_head_dim(hd, want):
    """The width a call runs at: the next multiple of 8, 16-byte rows in
    bf16 and f32."""
    assert cuda_kernel.padded_head_dim(hd) == want
    assert (want * 2) % 16 == 0


@pytest.mark.parametrize("hd", [PAD_HD, 35, 20, 1])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_zero_fill_copies_into_zero_columns(dtype, hd):
    """The wrapper's copy (whole integer words: 8 bytes at hd 36, 2 or 4 at
    hd 35) keeps every value and appends zero columns, so the maps' own zero
    fill up to the body's width continues it, also from a tensor that starts
    inside another's storage; the true columns come back bit for bit."""
    gen = torch.Generator().manual_seed(hd)
    x = torch.randn((2, 5, 3, hd), generator=gen).to(getattr(torch, dtype))
    inner = torch.randn((3, 2, 5, 3, hd), generator=gen).to(x.dtype)[1]
    width = cuda_kernel.padded_head_dim(hd)
    for src in (x, inner):
        y = cuda_kernel._zero_fill(src, width)
        assert y.shape == (2, 5, 3, width) and y.dtype == src.dtype and y.is_contiguous()
        assert torch.equal(y[..., :hd], src) and not bool(y[..., hd:].any())
        assert torch.equal(zero_fill(y, BODY_WIDTH), zero_fill(src, BODY_WIDTH))
        back = cuda_kernel._true_columns(y, hd)
        assert back.is_contiguous() and back.dtype == src.dtype and torch.equal(back, src)


def _same(got, want):
    """``got`` is ``want`` up to the CPU's summation order: f32 within 16
    f32 ulps of the tensor's largest value, bf16 within one bf16 ulp of
    each value (an f32 sum an ulp apart can round to the neighbouring bf16
    value)."""
    assert got.shape == want.shape and got.dtype == want.dtype
    scale = float(want.float().abs()[torch.isfinite(want)].max())
    if want.dtype == torch.bfloat16:
        torch.testing.assert_close(got.float(), want.float(), rtol=2.0 ** -8, atol=16 * 2.0 ** -24 * scale)
    else:
        torch.testing.assert_close(got, want, rtol=0, atol=16 * 2.0 ** -24 * scale)


def _case(seed, sq, skv, h, kvh, hd, dtype):
    gen = torch.Generator().manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=gen).to(dtype)
    return mk(2, sq, h, hd), mk(2, skv, kvh, hd), mk(2, skv, kvh, hd), mk(2, sq, h, hd)


# (sq, skv, H, KV, causal, window, q_offset, softcap)
PAD_CASES = [(200, 200, 4, 2, True, 0, 0, 0.0), (200, 200, 2, 2, True, 64, 0, 30.0), (1, 384, 4, 2, True, 128, 383, 0.0),
             (130, 130, 2, 2, False, 0, 0, 0.0)]


@pytest.mark.parametrize("sq,skv,h,kvh,causal,window,q_offset,softcap", PAD_CASES)
def test_bf16_padded_route_equals_true_width(sq, skv, h, kvh, causal, window, q_offset, softcap):
    """bf16 at hd 36: the wgmma forward and backward at width 64 (the
    wrapper's 40, then the maps' fill) give the same arithmetic's values at
    the true width with hd 36's scale, within one bf16 ulp of the plain
    forward in f32 and the bf16 bar of the plain backward."""
    q, k, v, do = _case(sq + h + window, sq, skv, h, kvh, PAD_HD, torch.bfloat16)
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    out, stats = _emulate_wgmma_body(q, k, v, stats=True, width=BODY_WIDTH, **kw)
    out_true, stats_true = _emulate_wgmma_body(q, k, v, stats=True, **kw)
    for a, w in ((out, out_true), (stats[0], stats_true[0]), (stats[1], stats_true[1])):
        _same(a, w)
    assert _ulp_ratio(out, gqa_flash_attention_ref(q.float(), k.float(), v.float(), **kw)) <= 1.0
    got = _emulate_wgmma_bwd(q, k, v, out, do, stats, width=BODY_WIDTH, **kw)
    for a, w in zip(got, _emulate_wgmma_bwd(q, k, v, out, do, stats, **kw)):
        _same(a, w)
    assert max(_bwd_bar_ratio(got, q, k, v, out, do, kw)) <= 1.0


@pytest.mark.parametrize("sq,skv,h,kvh,causal,window,q_offset,softcap", PAD_CASES)
def test_f32_padded_route_equals_true_width(sq, skv, h, kvh, causal, window, q_offset, softcap):
    """f32 at hd 36 on the training path: the bf16x6 forward and backward at
    width 64 give the same arithmetic's values at the true width with hd
    36's scale; the forward within the f32 ``atol`` of the plain forward in
    f64, the gradients within ``BWD_F32_FACTOR`` x the plain backward's f32
    error."""
    q, k, v, do = _case(sq + h + window + 1, sq, skv, h, kvh, PAD_HD, torch.float32)
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    out, stats = _emulate_bf16x6_fwd(q, k, v, width=BODY_WIDTH, **kw)
    out_true, stats_true = _emulate_bf16x6_fwd(q, k, v, **kw)
    for a, w in ((out, out_true), (stats[0], stats_true[0]), (stats[1], stats_true[1])):
        _same(a, w)
    assert _ratio(out, q, k, v, kw)[0] <= TOL["float32"]
    got = _emulate_bf16x6_bwd(q, k, v, out, do, width=BODY_WIDTH, **kw)
    for a, w in zip(got, _emulate_bf16x6_bwd(q, k, v, out, do, **kw)):
        _same(a, w)
    assert max(_f32_bar_ratios(got, q, k, v, out, do, kw)) <= BWD_F32_FACTOR


# ---------------------------------------------------------------------------
# On the card: the wrapper's padded route, and f32 at hd 256 backward
# ---------------------------------------------------------------------------

@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_padded_route_matches_plain(dtype):
    """Through ``FlashAttentionFunction`` (operands that require grad) at hd
    36 and 20: one forward and one backward launch on the tensor-core
    bodies (bf16: wgmma; f32: bf16x6), none on the CUDA cores; the output
    within the reference's ``atol`` of the plain version, the gradients
    within phase 2's bar of the plain backward; the gradients have the
    true head dim."""
    tdt = getattr(torch, dtype)
    gen = torch.Generator(device="cuda").manual_seed(36)
    for hd in (PAD_HD, 20):
        for sq, skv, h, kvh, causal, window, q_offset, softcap in PAD_CASES:
            mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(tdt)
            q, k, v, do = mk(2, sq, h, hd), mk(2, skv, kvh, hd), mk(2, skv, kvh, hd), mk(2, sq, h, hd)
            kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            fwd, bwd = dict(cuda_kernel.body_launch_count), dict(cuda_kernel.bwd_body_launch_count)
            out = flash_attention(*leaves, **kw)
            out.backward(do)
            body = "wgmma" if tdt == torch.bfloat16 else "bf16x6"
            assert cuda_kernel.body_launch_count == {**fwd, body: fwd[body] + 1}
            assert cuda_kernel.bwd_body_launch_count == {**bwd, body: bwd[body] + 1}
            out = out.detach()
            torch.testing.assert_close(out.float(), gqa_flash_attention_ref(q, k, v, **kw).float(), rtol=0,
                                       atol=TOL[dtype], msg=lambda m: f"{(hd, sq, skv, h, kvh, kw)}: {m}")
            w32 = flash_attention_bwd_ref(*(t.float() for t in (q, k, v, out, do)), **kw)
            w64 = flash_attention_bwd_ref(*(t.double() for t in (q, k, v, out, do)), **kw)
            for a, x32, x64 in zip(leaves, w32, w64):
                assert a.grad.shape == a.shape
                noise = float((x32.double() - x64).abs().max())
                if tdt == torch.float32:
                    assert float((a.grad.double() - x64).abs().max()) <= BWD_F32_FACTOR * noise, (hd, kw)
                else:
                    bar = 2.0 ** -7 * x32.abs() + BWD_F32_FACTOR * noise
                    assert bool(((a.grad.float() - x32).abs() <= bar).all()), (hd, kw)


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("hd", [136, 192, 256])
def test_cuda_bf16x6_bwd_past_hd_128_matches_plain(hd):
    """f32 past hd 128 (gemma3-12b's 256; 136 and 192 zero-filled to 256)
    runs the bf16x6 backward's slab kernels on statistics of its own (its
    counter moves, no other does; the forward is the 3xTF32 body and writes
    none), each gradient within ``BWD_F32_FACTOR`` x the plain backward's
    own f32 error against f64, and a second call gives the same bits:
    causal ragged, windowed with softcap, decode-shaped, non-causal, GQA."""
    gen = torch.Generator(device="cuda").manual_seed(300 + hd)
    for sq, skv, g, causal, window, q_offset, softcap in (
            (300, 300, 2, True, 0, 0, 0.0), (300, 300, 1, True, 128, 0, 30.0), (1, 384, 2, True, 128, 383, 0.0),
            (130, 130, 1, False, 0, 0, 0.0), (70, 200, 1, True, 40, 100, 0.0)):
        mk = lambda *s: torch.randn(s, generator=gen, device="cuda")
        q, k, v, do = mk(2, sq, 2 * g, hd), mk(2, skv, 2, hd), mk(2, skv, 2, hd), mk(2, sq, 2 * g, hd)
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        assert not cuda_kernel.bwd_reads_stats(q.dtype, hd)
        out = cuda_kernel.flash_attention(q, k, v, **kw)
        before = dict(cuda_kernel.bwd_body_launch_count)
        got = cuda_kernel.flash_attention_bwd(q, k, v, out, do, **kw)
        assert cuda_kernel.bwd_body_launch_count == {**before, "bf16x6": before["bf16x6"] + 1}
        again = cuda_kernel.flash_attention_bwd(q, k, v, out, do, **kw)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, again))
        ratios = _f32_bar_ratios(got, q, k, v, out, do, kw)
        assert max(ratios) <= BWD_F32_FACTOR, (sq, skv, g, kw, ratios)
