"""The port's whole-sequence attention (``repro_torch.kernels.flash_attention``)
and the model's ``_blockwise_attn`` against the reference, on inputs made
from a seed with numpy; and, on an sm_90 card only, the CUDA kernel against
its plain version.

Bars (the reference's own, ``tests/test_kernels.py``):
  * ``flash_attention_ref`` against the reference's ``ref.py`` and its
    interpret-mode Pallas kernel over the reference test's grid plus a
    softcap, ``atol=2e-5`` in f32 (the kernel-vs-ref tolerance there); bf16
    outputs ``atol=2e-2``;
  * the GQA dispatch against ``ops.flash_attention``, ``atol=2e-5``;
  * the port's ``_blockwise_attn`` against the reference's, f32 within
    ``2e-6`` (both walk the same blocks; the sums differ in order only);
    bf16 is mostly bit-equal, but a score a few f32 ulps apart (torch's and
    XLA's ``tanh`` differ) can round a probability to the neighbouring
    bf16 value before the PV product, so bf16 takes one bf16 ulp of a
    unit-scale output (``atol=2**-8``, ``rtol=2**-7``);
  * the f32 tensor-core body's arithmetic (3xTF32: each operand split into
    TF32 hi and lo parts, hi*hi + hi*lo + lo*hi summed in f32), emulated
    here, against the plain version and the reference's ops at the f32
    ``atol=2e-5``; one TF32 product alone misses it by more than 10x;
  * on the card, the kernel against ``flash_attention_ref``: ``atol=2e-5``
    in f32 and ``2e-2`` in bf16.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import (  # noqa: E402
    cuda_kernel,
    flash_attention,
    flash_attention_ref,
    gqa_flash_attention_ref,
    grouped_flash_attention,
)
from repro_torch.models import attention as t_attention  # noqa: E402

# (sq, skv, hd, causal, window, q_offset): the reference test's grid.
GRID = [
    (256, 256, 64, True, 0, 0),
    (256, 256, 64, True, 64, 0),
    (200, 200, 32, True, 0, 0),
    (1, 384, 64, True, 0, 383),      # decode
    (1, 384, 64, True, 128, 383),    # windowed decode
    (128, 128, 128, False, 0, 0),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.fixture
def J():
    """The reference package, imported where it is needed so the card-only
    tests run where jax is absent."""
    pytest.importorskip("jax")
    import jax
    import jax.numpy as jnp

    from repro.kernels.flash_attention import kernel, ops, ref
    from repro.models import attention

    return dataclasses.make_dataclass("J", ["jax", "jnp", "kernel", "ops", "ref", "attention"])(
        jax, jnp, kernel, ops, ref, attention)


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (the kernels are built for sm_90a)")


def _normal(seed, *shapes):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset", GRID)
def test_ref_matches_reference(J, sq, skv, hd, causal, window, q_offset, softcap):
    q, k, v = _normal(sq * 7 + skv + hd, (2, sq, hd), (2, skv, hd), (2, skv, hd))
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    jq, jk, jv = (J.jnp.asarray(a) for a in (q, k, v))
    want_ref = np.asarray(J.ref.flash_attention_ref(jq, jk, jv, **kw))
    want_ker = np.asarray(J.kernel.flash_attention_kernel(jq, jk, jv, block_q=64, block_kv=64, interpret=True,
                                                          **kw))
    got = flash_attention_ref(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, sq, hd)
    np.testing.assert_allclose(got.numpy(), want_ref, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), want_ker, atol=2e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ref_dtype_sweep(J, dtype):
    """The reference's dtype sweep (1 x 128 x 64): output in q's dtype."""
    q, k, v = _normal(5, (1, 128, 64), (1, 128, 64), (1, 128, 64))
    jdt = getattr(J.jnp, dtype)
    want = J.kernel.flash_attention_kernel(*(J.jnp.asarray(a).astype(jdt) for a in (q, k, v)),
                                           block_q=64, block_kv=64, interpret=True)
    got = flash_attention_ref(*(torch.tensor(a).to(getattr(torch, dtype)) for a in (q, k, v)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=TOL[dtype])


@pytest.mark.parametrize("kv,window,softcap", [(2, 0, 0.0), (2, 48, 30.0), (8, 0, 0.0)])
def test_gqa_dispatch_matches_reference_ops(J, kv, window, softcap):
    """``dispatch.flash_attention`` (KV heads < query heads) against the
    reference's ``ops.flash_attention`` (the ``:104-119`` case and two more)."""
    b, s, h, hd = 2, 128, 8, 32
    q, k, v = _normal(kv + window, (b, s, h, hd), (b, s, kv, hd), (b, s, kv, hd))
    kw = dict(window=window, softcap=softcap)
    want = J.ops.flash_attention(*(J.jnp.asarray(a) for a in (q, k, v)), block_q=64, block_kv=64, **kw)
    got = flash_attention(torch.tensor(q), torch.tensor(k), torch.tensor(v), **kw)
    assert tuple(got.shape) == (b, s, h, hd)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    grouped = grouped_flash_attention(torch.tensor(q).reshape(b, s, kv, h // kv, hd), torch.tensor(k),
                                      torch.tensor(v), **kw)
    assert torch.equal(grouped.reshape(b, s, h, hd), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s,kv,g,hd,window,softcap,block", [
    (256, 4, 1, 32, 64, 0.0, 64),     # the reference's :121-140 case
    (40, 2, 2, 16, 0, 0.0, 16),       # three ragged query blocks, GQA
    (200, 2, 1, 32, 0, 30.0, 64),     # ragged KV tail, softcap
    (96, 2, 2, 16, 24, 0.0, 32),      # window shorter than a block
])
def test_blockwise_matches_reference(J, dtype, s, kv, g, hd, window, softcap, block):
    q, k, v = _normal(s + hd, (1, s, kv, g, hd), (1, s, kv, hd), (1, s, kv, hd))
    kw = dict(causal=True, window=window, q_offset=0, block_q=block, block_kv=block, softcap=softcap)
    jdt = getattr(J.jnp, dtype)
    want = J.attention._blockwise_attn(*(J.jnp.asarray(a).astype(jdt) for a in (q, k, v)), **kw)
    got = t_attention._blockwise_attn(*(torch.tensor(a).to(getattr(torch, dtype)) for a in (q, k, v)), **kw)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == q.shape
    tol = dict(rtol=0, atol=2e-6) if dtype == "float32" else dict(rtol=2.0 ** -7, atol=2.0 ** -8)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(J.jnp.float32)), **tol)


def test_blockwise_equals_kernel_function():
    """The model's recurrence and the kernel's plain version compute one
    function (the reference's ``test_window_equals_model_blockwise_attn``)."""
    b, s, h, hd = 1, 256, 4, 32
    q, k, v = (torch.tensor(a) for a in _normal(9, (b, s, h, hd), (b, s, h, hd), (b, s, h, hd)))
    out_model = t_attention._blockwise_attn(q.reshape(b, s, h, 1, hd), k, v, causal=True, window=64, q_offset=0,
                                            block_q=64, block_kv=64, softcap=0.0).reshape(b, s, h, hd)
    torch.testing.assert_close(out_model, flash_attention(q, k, v, window=64), rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256, 36, 264])
def test_body_for(dtype, hd):
    """Every forward body is on the tensor cores: at every head dim up to
    256 (one that is not a multiple of 8 zero-filled by the wrapper to the
    next one, 36 to 40), bf16 takes the wgmma body, f32 the 3xTF32 body,
    and f32 asked for the row statistics (a gradient wanted) the bf16x6
    body up to hd 128; no f32 body writes statistics past it.  A dtype or
    head dim no body takes raises; nothing routes to the CUDA cores."""
    dt = getattr(torch, dtype)
    if dtype == "float16" or hd > 256:
        for stats in (False, True):
            with pytest.raises(ValueError):
                cuda_kernel.body_for(dt, hd, stats=stats)
        return
    assert cuda_kernel.padded_head_dim(hd) == -(-hd // 8) * 8
    if dtype == "bfloat16":
        assert cuda_kernel.body_for(dt, hd) == cuda_kernel.body_for(dt, hd, stats=True) == "wgmma"
        return
    assert cuda_kernel.body_for(dt, hd) == "tf32x3"
    if cuda_kernel.padded_head_dim(hd) <= 128:
        assert cuda_kernel.body_for(dt, hd, stats=True) == "bf16x6"
    else:
        with pytest.raises(ValueError, match="statistics"):
            cuda_kernel.body_for(dt, hd, stats=True)


# Phase 2's grid in chip_smoke.py (FLASH_GRID): the reference test's grid,
# the slice's 1000-token prompt, gemma3's hd 256 and a causal ragged hd 128.
CHIP_GRID = GRID + [
    (1000, 1000, 64, True, 0, 0),
    (300, 300, 256, True, 128, 0),
    (200, 200, 256, False, 0, 0),
    (300, 300, 128, True, 0, 0),
    (300, 300, 112, True, 0, 0),      # kimi-k2's head dim: two 64-column boxes, the second zero-filled past 48
]
# Head dims the body runs zero-filled at its next width, and that width.
ZERO_FILL = {32: 64, 112: 128}


def zero_fill(x, width):
    """x padded with zero columns (the last axis) up to ``width``, as the
    tensor maps fill a box past the tensor's true hd."""
    return torch.nn.functional.pad(x, (0, width - x.shape[-1]))
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-5   # one bf16 ulp of the f32 value, f32 noise


def _emulate_wgmma_body(q, k, v, *, causal, window, q_offset, softcap, p_lo=True, stats=False, width=None):
    """The tensor-core body's arithmetic in torch on the CPU: bf16 Q K^T
    summed in f32 over KV tiles of the body's 64 keys, scale, softcap and
    mask, the online softmax in f32, P split into bf16 hi and lo parts
    (``p_lo=False`` drops lo), both multiplied by bf16 V and summed in f32,
    ``acc / max(l, 1e-20)`` rounded once to bf16.  ``stats=True`` also
    returns the rows' statistics as the body writes them for the backward:
    f32 (2, B * H * Sq), m in log2 units (-inf for a row that sees no key)
    and l clamped to 1e-20.  ``width``: q, k and v zero-filled up to it, as
    the body runs a head dim below its width; the scale stays the true
    hd's and the output keeps the true hd columns."""
    b, sq, h, hd = q.shape
    if width is not None:
        q, k, v = (zero_fill(x, width) for x in (q, k, v))
    skv, g = k.shape[1], h // k.shape[2]
    bkv = 64
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
    scale = 1.0 / np.sqrt(hd)
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, qf.shape[-1]))
    qp = q_offset + torch.arange(sq)
    for k0 in range(0, skv, bkv):
        kp = torch.arange(k0, min(k0 + bkv, skv))
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kf[:, :, k0:k0 + bkv]) * scale
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        ok = torch.ones((sq, kp.numel()), dtype=torch.bool)
        if causal:
            ok &= kp[None] <= qp[:, None]
        if window > 0:
            ok &= qp[:, None] - kp[None] < window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, torch.exp(s - m_new[..., None]), 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float() if p_lo else torch.zeros_like(p)
        acc = acc * corr[..., None] + hi @ vf[:, :, k0:k0 + bkv] + lo @ vf[:, :, k0:k0 + bkv]
        m = m_new
    out = (acc / torch.clamp(l, min=1e-20)[..., None]).transpose(1, 2)[..., :hd].bfloat16()
    if not stats:
        return out
    m2 = torch.where(m <= -1e30, -torch.inf, m * np.float32(np.log2(np.e)))
    return out, torch.stack([m2.reshape(-1), torch.clamp(l, min=1e-20).reshape(-1)])


def _ulp_ratio(got, want32):
    return float(((got.float() - want32).abs() / (BF16_REL * want32.abs() + BF16_ABS)).max())


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset", [c for c in CHIP_GRID if c[2] in (64, 128, 256)])
def test_wgmma_body_arithmetic_meets_the_bf16_bar(sq, skv, hd, causal, window, q_offset, g):
    """The design shown on the CPU: the body's arithmetic on bf16 inputs
    sits within one bf16 ulp + 1e-5 of the plain version computed in f32,
    the check phase 2 of chip_smoke.py holds the kernel to; and within the
    reference's bf16 ``atol`` of the bf16 plain version."""
    gen = torch.Generator().manual_seed(sq + skv + hd + g)
    mk = lambda *s: torch.randn(s, generator=gen).bfloat16()
    q, k, v = mk(2, sq, 2 * g, hd), mk(2, skv, 2, hd), mk(2, skv, 2, hd)
    for softcap in (0.0, 30.0):
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        got = _emulate_wgmma_body(q, k, v, **kw)
        want32 = gqa_flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        assert _ulp_ratio(got, want32) <= 1.0, (softcap, _ulp_ratio(got, want32))
        np.testing.assert_allclose(got.float().numpy(), gqa_flash_attention_ref(q, k, v, **kw).float().numpy(),
                                   atol=TOL["bfloat16"])


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset",
                         [c for c in CHIP_GRID if c[2] in ZERO_FILL] + [(130, 130, 32, False, 0, 0)])
def test_wgmma_body_zero_filled_equals_true_width(sq, skv, hd, causal, window, q_offset, g):
    """hd 32 and kimi-k2's 112 run on the wgmma body at widths 64 and 128,
    the columns past hd zero-filled: zeros add exactly 0 to every Q K^T, so
    the zero-filled arithmetic gives the bits of the same arithmetic at the
    true width, and both meet the bf16 bar of phase 2."""
    gen = torch.Generator().manual_seed(sq + hd + g)
    mk = lambda *s: torch.randn(s, generator=gen).bfloat16()
    q, k, v = mk(2, sq, 2 * g, hd), mk(2, skv, 2, hd), mk(2, skv, 2, hd)
    for softcap in (0.0, 30.0):
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        got, stats = _emulate_wgmma_body(q, k, v, width=ZERO_FILL[hd], stats=True, **kw)
        want, want_stats = _emulate_wgmma_body(q, k, v, stats=True, **kw)
        assert got.shape == q.shape and torch.equal(got, want) and torch.equal(stats, want_stats)
        assert _ulp_ratio(got, gqa_flash_attention_ref(q.float(), k.float(), v.float(), **kw)) <= 1.0


def test_wgmma_body_needs_p_lo():
    """The check has teeth: with P rounded once to bf16 (no lo part) the
    same arithmetic misses the one-ulp bar by far."""
    gen = torch.Generator().manual_seed(3)
    mk = lambda *s: torch.randn(s, generator=gen).bfloat16()
    q, k, v = mk(2, 256, 2, 64), mk(2, 256, 2, 64), mk(2, 256, 2, 64)
    kw = dict(causal=True, window=0, q_offset=0, softcap=0.0)
    want32 = gqa_flash_attention_ref(q.float(), k.float(), v.float(), **kw)
    assert _ulp_ratio(_emulate_wgmma_body(q, k, v, **kw), want32) <= 1.0
    assert _ulp_ratio(_emulate_wgmma_body(q, k, v, p_lo=False, **kw), want32) > 4.0


def _tf32(x):
    """Round f32 to TF32 (10 explicit mantissa bits), to nearest with ties
    away from zero, as ``cvt.rna.tf32.f32`` does: add half of the dropped
    13 bits' unit to the magnitude and clear them."""
    a = np.ascontiguousarray(x.numpy()).view(np.uint32)
    return torch.from_numpy(((a + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32))


def _mm3(a, b, lo_terms=True):
    """``a @ b`` as the body forms it: hi*hi + hi*lo + lo*hi of the TF32
    splits, summed in f32 (``lo_terms=False``: one TF32 product)."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    out = a_hi @ b_hi
    if lo_terms:
        out = out + a_hi @ _tf32(b - b_hi) + _tf32(a - a_hi) @ b_hi
    return out


def _emulate_tf32x3_body(q, k, v, *, causal, window, q_offset, softcap, lo_terms=True):
    """The f32 tensor-core body's arithmetic in torch on the CPU: S = Q K^T
    in 3xTF32 over KV tiles of the body's keys (32 at hd <= 64, 16 above),
    scale, softcap and mask, the online softmax in f32, P V in 3xTF32,
    ``acc / max(l, 1e-20)``.  exp is taken in f64 and rounded to f32, so no
    f32 ``torch.exp`` runs here (ROADMAP fault C2)."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    bkv = 32 if hd <= 64 else 16
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
    scale = np.float32(1.0 / np.sqrt(np.float32(hd)))
    exp = lambda x: torch.exp(x.double()).float()
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, hd))
    qp = q_offset + torch.arange(sq)
    for k0 in range(0, skv, bkv):
        kp = torch.arange(k0, min(k0 + bkv, skv))
        s = _mm3(qf, kf[:, :, k0:k0 + bkv].transpose(-1, -2), lo_terms) * scale
        if softcap > 0:
            s = torch.tanh(s / softcap) * softcap
        ok = torch.ones((sq, kp.numel()), dtype=torch.bool)
        if causal:
            ok &= kp[None] <= qp[:, None]
        if window > 0:
            ok &= qp[:, None] - kp[None] < window
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(ok, exp(s - m_new[..., None]), 0.0)
        corr = exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + _mm3(p, vf[:, :, k0:k0 + bkv], lo_terms)
        m = m_new
    return (acc / torch.clamp(l, min=1e-20)[..., None]).transpose(1, 2)


def _f32_case(seed, sq, skv, hd, g):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((2, sq, 2 * g, hd), generator=gen), torch.randn((2, skv, 2, hd), generator=gen),
            torch.randn((2, skv, 2, hd), generator=gen))


def test_tf32_rounding_is_nearest_ties_away():
    """``_tf32`` keeps 10 mantissa bits and rounds a tie away from zero."""
    ulp = 2.0 ** -10
    x = torch.tensor([1.0, 1.0 + ulp / 2, -(1.0 + ulp / 2), 1.0 + ulp / 2 - 2.0 ** -23, 1.0 + 1.5 * ulp, 3.0e-3],
                     dtype=torch.float32)
    got = _tf32(x)
    assert got[:5].tolist() == [1.0, 1.0 + ulp, -(1.0 + ulp), 1.0, 1.0 + 2 * ulp]
    assert (got.numpy().view(np.uint32) & 0x1FFF == 0).all() and abs(float(got[5]) - 3.0e-3) <= 3.0e-3 * 2 ** -11


@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("sq,skv,hd,causal,window,q_offset", [c for c in CHIP_GRID if c[2] in (64, 128, 256)])
def test_tf32x3_body_arithmetic_meets_the_f32_bar(sq, skv, hd, causal, window, q_offset, g):
    """The design shown on the CPU: the 3xTF32 body's arithmetic on f32
    inputs sits within the f32 ``atol`` 2e-5 of the plain version, the bar
    phase 2 of chip_smoke.py holds the kernel to."""
    q, k, v = _f32_case(sq + skv + hd + g, sq, skv, hd, g)
    for softcap in (0.0, 30.0):
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        got = _emulate_tf32x3_body(q, k, v, **kw)
        np.testing.assert_allclose(got.numpy(), gqa_flash_attention_ref(q, k, v, **kw).numpy(), rtol=0,
                                   atol=TOL["float32"], err_msg=str(softcap))


@pytest.mark.parametrize("s,kv,g,hd,window,softcap", [
    (256, 2, 1, 64, 64, 0.0),     # the reference test's windowed case
    (200, 2, 2, 128, 0, 30.0),    # ragged tiles, GQA, softcap
    (128, 1, 2, 256, 0, 0.0),     # gemma3's head dim
])
def test_tf32x3_body_matches_reference_ops(J, s, kv, g, hd, window, softcap):
    """The same arithmetic against the reference's ``ops.flash_attention``
    (its Pallas kernel in interpret mode on the CPU), ``atol=2e-5``."""
    q, k, v = _f32_case(s + hd, s, s, hd, g)
    q = q[:, :, :kv * g]
    k, v = k[:, :, :kv], v[:, :, :kv]
    kw = dict(window=window, softcap=softcap)
    want = J.ops.flash_attention(*(J.jnp.asarray(x.numpy()) for x in (q, k, v)), block_q=64, block_kv=64, **kw)
    got = _emulate_tf32x3_body(q, k, v, causal=True, q_offset=0, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL["float32"])


def test_tf32x3_needs_the_lo_terms():
    """The check has teeth: one TF32 product (hi*hi alone) misses the f32
    bar by more than 10x on the same inputs; with the lo terms it holds."""
    q, k, v = _f32_case(3, 256, 256, 64, 1)
    kw = dict(causal=True, window=0, q_offset=0, softcap=0.0)
    want = gqa_flash_attention_ref(q, k, v, **kw)
    assert float((_emulate_tf32x3_body(q, k, v, **kw) - want).abs().max()) <= TOL["float32"]
    assert float((_emulate_tf32x3_body(q, k, v, lo_terms=False, **kw) - want).abs().max()) > 10 * TOL["float32"]


def test_wrapper_rejects_cpu_and_bad_shapes():
    """The CUDA wrapper takes CUDA tensors only and checks its inputs
    before anything is built or launched."""
    q = torch.zeros((1, 4, 4, 32))
    k = torch.zeros((1, 4, 2, 32))
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_kernel.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="4-d"):
        cuda_kernel.flash_attention(q[0], k, k)
    assert cuda_kernel.flash_attention_launch_count() == cuda_kernel.launch_count


# ---------------------------------------------------------------------------
# On the card: the kernel against its plain version
# ---------------------------------------------------------------------------

def _cuda_case(gen, b, sq, skv, h, kvh, hd, dtype):
    mk = lambda *s: torch.randn(s, generator=gen, device="cuda").to(dtype)
    return mk(b, sq, h, hd), mk(b, skv, kvh, hd), mk(b, skv, kvh, hd)


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain(dtype):
    gen = torch.Generator(device="cuda").manual_seed(0)
    tdt = getattr(torch, dtype)
    cases = [(sq, skv, hd, 1, c, w, o) for sq, skv, hd, c, w, o in GRID]
    cases += [(1000, 1000, 64, 2, True, 0, 0), (300, 300, 256, 2, True, 128, 0), (130, 130, 256, 1, False, 0, 0)]
    for sq, skv, hd, g, causal, window, q_offset in cases:
        q, k, v = _cuda_case(gen, 2, sq, skv, 2 * g, 2, hd, tdt)
        for softcap in (0.0, 30.0):
            kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
            before = cuda_kernel.launch_count
            got = flash_attention(q, k, v, **kw)
            assert cuda_kernel.launch_count == before + 1
            want = gqa_flash_attention_ref(q, k, v, **kw)
            torch.cuda.synchronize()
            assert got.dtype == tdt
            torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype],
                                       msg=lambda m: f"{(sq, skv, hd, g, kw)}: {m}")


@pytest.mark.usefixtures("hopper")
def test_cuda_model_prefill_takes_the_kernel():
    """A prefill past ``attn_block_q`` on the card launches the kernel once
    per attention layer."""
    from repro_torch.configs import get_config
    from repro_torch.models import cache as cache_lib, lm

    cfg = get_config("qwen1.5-0.5b").reduced(attn_impl="flash_decode", attn_block_q=16)
    model = lm.init_lm(cfg, seed=0, device="cuda")
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device="cuda", dtype=torch.int32)
    before = cuda_kernel.launch_count
    with torch.inference_mode():
        cache = cache_lib.init_cache(cfg, 2, 48, device="cuda")
        logits, _, _ = lm.forward(model, tokens, cfg, cache=cache, cache_index=0)
    assert cuda_kernel.launch_count - before == cfg.num_layers
    assert bool(torch.isfinite(logits).all())


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("hd", [64, 128, 256])
def test_cuda_wgmma_body_matches_plain(hd):
    """bf16 at hd 64 / 128 / 256 runs on the wgmma body (its counter moves,
    no other does) and stays within one bf16 ulp +
    1e-5 of the plain version computed in f32: causal ragged, windowed with
    softcap, decode-shaped, non-causal, GQA."""
    gen = torch.Generator(device="cuda").manual_seed(hd)
    for sq, skv, g, causal, window, q_offset, softcap in (
            (300, 300, 2, True, 0, 0, 0.0), (300, 300, 1, True, 128, 0, 30.0), (1, 384, 2, True, 128, 383, 0.0),
            (130, 130, 1, False, 0, 0, 0.0), (1000, 1000, 2, True, 0, 0, 0.0)):
        q, k, v = _cuda_case(gen, 2, sq, skv, 2 * g, 2, hd, torch.bfloat16)
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        before = dict(cuda_kernel.body_launch_count)
        got = flash_attention(q, k, v, **kw)
        assert cuda_kernel.body_launch_count == {**before, "wgmma": before["wgmma"] + 1}
        want32 = gqa_flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        assert _ulp_ratio(got, want32) <= 1.0, (sq, skv, g, kw)


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("hd", [8, 32, 64, 96, 128, 256])
def test_cuda_tf32x3_body_matches_plain(hd):
    """f32 at head dims that are multiples of 8 runs on the 3xTF32 body
    (its counter moves, no other does) and stays within the f32 ``atol``
    2e-5 of the plain version: causal ragged, windowed with softcap,
    decode-shaped, non-causal, GQA, a 1000-token prompt."""
    gen = torch.Generator(device="cuda").manual_seed(hd)
    for sq, skv, g, causal, window, q_offset, softcap in (
            (300, 300, 2, True, 0, 0, 0.0), (300, 300, 1, True, 128, 0, 30.0), (1, 384, 2, True, 128, 383, 0.0),
            (130, 130, 1, False, 0, 0, 0.0), (1000, 1000, 2, True, 0, 0, 0.0)):
        q, k, v = _cuda_case(gen, 2, sq, skv, 2 * g, 2, hd, torch.float32)
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        before = dict(cuda_kernel.body_launch_count)
        got = flash_attention(q, k, v, **kw)
        assert cuda_kernel.body_launch_count == {**before, "tf32x3": before["tf32x3"] + 1}
        want = gqa_flash_attention_ref(q, k, v, **kw)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=0, atol=TOL["float32"], msg=lambda m: f"{(sq, skv, g, kw)}: {m}")


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype,hd", [("float32", 36), ("float32", 20), ("bfloat16", 36)])
def test_cuda_simt_body_takes_the_rest(dtype, hd):
    """Head dims that are not multiples of 8, which the CUDA-core body took
    before, now run on the tensor-core bodies, zero-filled by the wrapper
    to the next multiple of 8 (bf16 on the wgmma body, f32 on the 3xTF32
    body, and with statistics on the bf16x6 body): the CUDA-core body's
    counter does not move, and the output keeps the true hd's columns
    within the reference's ``atol``."""
    gen = torch.Generator(device="cuda").manual_seed(hd)
    dt = getattr(torch, dtype)
    q, k, v = _cuda_case(gen, 2, 200, 200, 4, 2, hd, dt)
    want = gqa_flash_attention_ref(q, k, v)
    for stats in (False, True):
        body = cuda_kernel.body_for(dt, hd, stats=stats)
        assert body != "simt"
        before = dict(cuda_kernel.body_launch_count)
        got = cuda_kernel.flash_attention(q, k, v, return_stats=stats)
        got = got[0] if stats else got
        assert cuda_kernel.body_launch_count == {**before, body: before[body] + 1}
        torch.cuda.synchronize()
        assert got.shape == q.shape
        torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("hd", sorted(ZERO_FILL))
def test_cuda_wgmma_body_zero_filled(hd):
    """bf16 at hd 32 and kimi-k2's 112 (64 query heads over 8 KV heads)
    runs on the wgmma body, zero-filled to its next width (its counter
    moves, the CUDA-core body's does not), within one bf16 ulp + 1e-5 of
    the plain version in f32."""
    gen = torch.Generator(device="cuda").manual_seed(hd)
    for b, sq, h, kvh, causal, window, q_offset, softcap in (
            (2, 300, 4, 2, True, 0, 0, 0.0), (2, 300, 2, 2, True, 128, 0, 30.0), (2, 1, 4, 2, True, 128, 383, 0.0),
            (2, 130, 2, 2, False, 0, 0, 0.0), (1, 1000, 64, 8, True, 0, 0, 0.0)):
        skv = 384 if q_offset else sq
        q, k, v = _cuda_case(gen, b, sq, skv, h, kvh, hd, torch.bfloat16)
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        before = dict(cuda_kernel.body_launch_count)
        got = flash_attention(q, k, v, **kw)
        assert cuda_kernel.body_launch_count == {**before, "wgmma": before["wgmma"] + 1}
        want32 = gqa_flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        assert got.shape == q.shape and _ulp_ratio(got, want32) <= 1.0, (b, sq, h, kvh, kw)
