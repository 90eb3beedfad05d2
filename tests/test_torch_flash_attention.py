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
@pytest.mark.parametrize("hd", [16, 32, 64, 96, 128, 256])
def test_body_for(dtype, hd):
    """bf16 at head dims 64, 128 and 256 takes the tensor-core body; f32
    (TF32 would break f32 parity) and every other head dim the CUDA cores."""
    want = "wgmma" if dtype == "bfloat16" and hd in (64, 128, 256) else "simt"
    assert cuda_kernel.body_for(getattr(torch, dtype), hd) == want


# Phase 2's grid in chip_smoke.py (FLASH_GRID): the reference test's grid,
# the slice's 1000-token prompt, gemma3's hd 256 and a causal ragged hd 128.
CHIP_GRID = GRID + [
    (1000, 1000, 64, True, 0, 0),
    (300, 300, 256, True, 128, 0),
    (200, 200, 256, False, 0, 0),
    (300, 300, 128, True, 0, 0),
]
BF16_REL, BF16_ABS = 2.0 ** -7, 1e-5   # one bf16 ulp of the f32 value, f32 noise


def _emulate_wgmma_body(q, k, v, *, causal, window, q_offset, softcap, p_lo=True):
    """The tensor-core body's arithmetic in torch on the CPU: bf16 Q K^T
    summed in f32 over KV tiles of the body's 64 keys, scale, softcap and
    mask, the online softmax in f32, P split into bf16 hi and lo parts
    (``p_lo=False`` drops lo), both multiplied by bf16 V and summed in f32,
    ``acc / max(l, 1e-20)`` rounded once to bf16."""
    b, sq, h, hd = q.shape
    skv, g = k.shape[1], h // k.shape[2]
    bkv = 64
    qf, kf, vf = (x.float().transpose(1, 2) for x in (q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
    scale = 1.0 / np.sqrt(hd)
    m = torch.full((b, h, sq), -1e30)
    l = torch.zeros((b, h, sq))
    acc = torch.zeros((b, h, sq, hd))
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
    return (acc / torch.clamp(l, min=1e-20)[..., None]).transpose(1, 2).bfloat16()


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
    """bf16 at hd 64 / 128 / 256 runs on the tensor-core body (its counter
    moves, the CUDA-core body's does not) and stays within one bf16 ulp +
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
        assert cuda_kernel.body_launch_count == {"wgmma": before["wgmma"] + 1, "simt": before["simt"]}
        want32 = gqa_flash_attention_ref(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        assert _ulp_ratio(got, want32) <= 1.0, (sq, skv, g, kw)


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype,hd", [("float32", 64), ("float32", 256), ("bfloat16", 32)])
def test_cuda_simt_body_takes_the_rest(dtype, hd):
    """f32 operands and other head dims run on the CUDA-core body."""
    gen = torch.Generator(device="cuda").manual_seed(hd)
    q, k, v = _cuda_case(gen, 2, 200, 200, 4, 2, hd, getattr(torch, dtype))
    before = dict(cuda_kernel.body_launch_count)
    got = flash_attention(q, k, v)
    assert cuda_kernel.body_launch_count == {"wgmma": before["wgmma"], "simt": before["simt"] + 1}
    want = gqa_flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=TOL[dtype])
