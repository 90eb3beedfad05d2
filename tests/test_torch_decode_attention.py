"""The port's decode attention (``repro_torch.kernels.decode_attention``)
against the reference's ``flash_decode_ref`` and its Pallas
``flash_decode_kernel`` run in interpret mode, on inputs made from a seed
with numpy; and, on an sm_90 card only, the CUDA kernel against the plain
version.

Tolerance: rtol = atol = 2e-6, the bound the reference pins between its
own kernel and ref (tests/test_decode_attention.py), for f32 caches.  int8
caches get 1e-5: their dequantized summands reach ~8 (codes up to 127 times
scales up to 0.06), where one f32 ulp is ~5e-7, and torch's einsum sums the
block in another order than XLA's dot, which leaves a few such ulps.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import runtime  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    cuda_kernel,
    decode_attention,
    decode_block_kv,
    flash_decode_ref,
    flash_decode_split_ref,
)

TOL = dict(rtol=2e-6, atol=2e-6)
TOL_INT8 = dict(rtol=1e-5, atol=1e-5)
BKV = 8


@pytest.fixture
def jref():
    """The reference package (decode attention), imported where it is needed
    so the card-only test runs where jax is absent."""
    pytest.importorskip("jax")
    from repro.kernels import decode_attention

    return decode_attention


@pytest.fixture
def hopper():
    if not torch.cuda.is_available() or torch.cuda.get_device_capability(0) != (9, 0):
        pytest.skip("needs an sm_90 CUDA device (the kernel is built for sm_90a)")


def _inputs(seed, b, c, kvh, g, hd, quantized):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, (b, c, kvh, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (b, c, kvh, hd)).astype(np.int8)
        ks = (rng.random((b, c, kvh)) * 0.05 + 0.01).astype(np.float32)
        vs = (rng.random((b, c, kvh)) * 0.05 + 0.01).astype(np.float32)
        return q, k, v, ks, vs
    k = rng.standard_normal((b, c, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((b, c, kvh, hd)).astype(np.float32)
    return q, k, v, None, None


def _jax_args(q, k, v, ks, vs):
    import jax.numpy as jnp

    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)
    return jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bf(ks), bf(vs)


def _torch_args(q, k, v, ks, vs):
    bf = lambda a: None if a is None else torch.tensor(a).to(torch.bfloat16)
    return torch.tensor(q), torch.tensor(k), torch.tensor(v), bf(ks), bf(vs)


@pytest.mark.parametrize("g", [1, 2, 4])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_ref_matches_reference_ref_and_kernel(jref, g, quantized, softcap):
    """Per-row n_valid in {0, 1, block-1, block, C}: empty rows give zeros,
    the ragged block and the full cache agree with both reference paths."""
    import jax.numpy as jnp

    c = 32
    raw = _inputs(g * 10 + quantized, 5, c, 2, g, 16, quantized)
    n = np.array([0, 1, BKV - 1, BKV, c], np.int32)[:, None]
    got = flash_decode_ref(*_torch_args(*raw), torch.tensor(n), block_kv=BKV, softcap=softcap).numpy()
    jargs = _jax_args(*raw) + (jnp.asarray(n),)
    want_ref = np.asarray(jref.flash_decode_ref(*jargs, block_kv=BKV, softcap=softcap))
    want_ker = np.asarray(jref.flash_decode_kernel(*jargs, block_kv=BKV, softcap=softcap, interpret=True))
    tol = TOL_INT8 if quantized else TOL
    np.testing.assert_allclose(got, want_ref, **tol)
    np.testing.assert_allclose(got, want_ker, **tol)
    np.testing.assert_array_equal(got[0], 0.0)


@pytest.mark.parametrize("hd,g", [(112, 8), (128, 7)], ids=["hd112-g8", "hd128-g7"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_ref_at_kimi_and_arctic_heads(jref, hd, g, quantized, softcap):
    """kimi-k2's decode heads (hd 112 = 7168 / 64, G 8) and arctic's group
    (G 7 = 56 / 8) at hd 128, against both reference paths, with n_valid 0,
    1, block edges and the full cache; the split arithmetic of the CUDA
    kernel at its planned split count for kimi-k2's 1,024-row shape (4)."""
    import jax.numpy as jnp

    c = 32
    raw = _inputs(hd + g + quantized, 5, c, 2, g, hd, quantized)
    n = np.array([0, 1, BKV - 1, BKV + 1, c], np.int32)
    targs = _torch_args(*raw)
    got = flash_decode_ref(*targs, torch.tensor(n)[:, None], block_kv=BKV, softcap=softcap).numpy()
    split = flash_decode_split_ref(*targs, torch.tensor(n), nsplit=4, softcap=softcap).numpy()
    jargs = _jax_args(*raw) + (jnp.asarray(n[:, None]),)
    want_ref = np.asarray(jref.flash_decode_ref(*jargs, block_kv=BKV, softcap=softcap))
    want_ker = np.asarray(jref.flash_decode_kernel(*jargs, block_kv=BKV, softcap=softcap, interpret=True))
    tol = TOL_INT8 if quantized else TOL
    for out in (got, split):
        np.testing.assert_allclose(out, want_ref, **tol)
        np.testing.assert_allclose(out, want_ker, **tol)
        np.testing.assert_array_equal(out[0], 0.0)


def test_kimi_heads_are_a_supported_shape():
    """The wrapper takes hd 112 (kimi-k2) and G up to 16; other head dims
    still raise before any launch."""
    assert 112 in cuda_kernel.HEAD_DIMS and cuda_kernel.MAX_GROUP >= 8
    assert cuda_kernel.decode_plan(4, 8, 8, 1024, sms=132) == dict(nsplit=4, rows_per_split=256, kernels=2)
    assert cuda_kernel.decode_plan(4, 8, 8, 64, sms=132) == dict(nsplit=1, rows_per_split=64, kernels=1)


@pytest.mark.parametrize("nsplit", [1, 2, 3, 7])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_split_ref_matches_reference(jref, nsplit, quantized, softcap):
    """The split-KV arithmetic of the contiguous CUDA kernel (per-split
    partials, then the merge) against ``flash_decode_ref`` and both
    reference paths.  C 32 in nsplit 7 gives splits of 5 rows, so n_valid
    0 and 1 leave six or seven splits with no row, which must merge to
    nothing (zeros for n_valid 0)."""
    import jax.numpy as jnp

    c = 32
    raw = _inputs(nsplit * 10 + quantized, 5, c, 2, 2, 16, quantized)
    n = np.array([0, 1, BKV - 1, 21, c], np.int32)
    targs = _torch_args(*raw)
    got = flash_decode_split_ref(*targs, torch.tensor(n), nsplit=nsplit, softcap=softcap).numpy()
    plain = flash_decode_ref(*targs, torch.tensor(n)[:, None], block_kv=BKV, softcap=softcap).numpy()
    jargs = _jax_args(*raw) + (jnp.asarray(n[:, None]),)
    want_ref = np.asarray(jref.flash_decode_ref(*jargs, block_kv=BKV, softcap=softcap))
    want_ker = np.asarray(jref.flash_decode_kernel(*jargs, block_kv=BKV, softcap=softcap, interpret=True))
    tol = TOL_INT8 if quantized else TOL
    np.testing.assert_allclose(got, plain, **tol)
    np.testing.assert_allclose(got, want_ref, **tol)
    np.testing.assert_allclose(got, want_ker, **tol)
    np.testing.assert_array_equal(got[0], 0.0)


@pytest.mark.parametrize("blocks,rows,want", [
    (64, 64, 1),          # the main path: B 4 x KV 16, 64 rows: one split, no merge
    (64, 1024, 4),        # the long path's decode: about a wave of 256-row splits
    (32, 1024, 8),        # gemma3's heads (B 4 x KV 8)
    (16, 4096, 16),       # B 1 x KV 16 at 4096 rows
    (64, 63, 1),          # fewer rows than one split's minimum
    (4, 100, 1),          # 100 rows: one split of at least 64
    (4, 200, 1),          # under SPLIT_FROM_ROWS: one split, no merge
    (4, 300, 3),          # 300 rows: three 128-row splits, the last ragged
    (128, 160, 1),        # the engine's 8 slots x 16 KV heads, 160 rows
    (1024, 4096, 1),      # the grid already fills a wave
])
def test_split_plan(blocks, rows, want):
    nsplit = cuda_kernel.split_plan(blocks, rows, sms=132)
    assert nsplit == want
    per = -(-rows // nsplit)
    assert nsplit == 1 or (per >= cuda_kernel.SPLIT_MIN_ROWS and (nsplit - 1) * per < rows)


@pytest.mark.parametrize("b,kvh,g,c,want", [
    (4, 16, 1, 64, dict(nsplit=1, rows_per_split=64, kernels=1)),
    (4, 16, 1, 1024, dict(nsplit=4, rows_per_split=256, kernels=2)),
    (4, 8, 2, 1024, dict(nsplit=8, rows_per_split=128, kernels=2)),   # G 2 in one tile of 4
    (2, 4, 8, 1024, dict(nsplit=16, rows_per_split=64, kernels=2)),  # G 8: two tiles, 16 blocks
])
def test_decode_plan(b, kvh, g, c, want):
    plan = cuda_kernel.decode_plan(b, kvh, g, c, sms=132)
    assert plan == want
    assert plan["nsplit"] * plan["rows_per_split"] >= c


@pytest.mark.parametrize("c", [65, 100])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_dispatch_pad_path(jref, c, quantized):
    """Cache lengths with no usable divisor of the block are padded to a
    block multiple on the CPU path, as the reference's ``decode_attention``."""
    import jax.numpy as jnp

    q, k, v, ks, vs = _inputs(c, 3, c, 2, 2, 16, quantized)
    nv = np.array([1, 40, c], np.int32)
    tq, tk, tv, tks, tvs = _torch_args(q, k, v, ks, vs)
    jq, jk, jv, jks, jvs = _jax_args(q, k, v, ks, vs)
    tcache = {"k": tk, "v": tv}
    jcache = {"k": jk, "v": jv}
    if quantized:
        tcache.update(k_scale=tks, v_scale=tvs)
        jcache.update(k_scale=jks, v_scale=jvs)
    got = decode_attention(tq[:, None], tcache, torch.tensor(nv), block_kv=64).numpy()
    for impl in ("ref", "kernel"):
        want = jref.decode_attention(jq[:, None], jcache, jnp.asarray(nv), block_kv=64, impl=impl,
                                     interpret=True)
        np.testing.assert_allclose(got, np.asarray(want), **(TOL_INT8 if quantized else TOL))


@pytest.mark.parametrize("c", [8, 16, 32, 64, 65, 96, 100, 128, 1000, 1024])
def test_decode_block_kv_matches_reference(jref, c):
    for block in (8, 16, 64, 128):
        assert decode_block_kv(c, block) == jref.decode_block_kv(c, block)


def test_scalar_n_valid_broadcasts():
    q, k, v, _, _ = _inputs(0, 3, 32, 2, 1, 16, False)
    tq, tk, tv, _, _ = _torch_args(q, k, v, None, None)
    cache = {"k": tk, "v": tv}
    a = decode_attention(tq[:, None], cache, 11, block_kv=BKV)
    b = decode_attention(tq[:, None], cache, torch.full((3,), 11, dtype=torch.int32), block_kv=BKV)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_device_policy():
    """CPU tensors take the plain version; devices without a kernel raise."""
    assert runtime.use_kernel(torch.zeros(1)) is False
    with pytest.raises(RuntimeError):
        runtime.use_kernel(torch.zeros(1, device="meta"))


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_cuda_kernel_matches_plain(dtype):
    """The CUDA kernel against the plain version on the card, at the main
    path's head shape, gemma3's (G = 2, hd = 256), kimi-k2's (G 8, hd 112:
    a row's loads on a power of two of lanes, the rest idle) at 64 and
    1,024 rows, and arctic's G 7 at hd 128; ragged n_valid rows."""
    from repro_torch.kernels.decode_attention import cuda_kernel

    gen = torch.Generator(device="cuda").manual_seed(0)
    for b, kvh, g, hd, c in ((4, 16, 1, 64, 64), (2, 8, 2, 256, 1024), (4, 8, 8, 112, 64), (4, 8, 8, 112, 1024),
                             (4, 8, 7, 128, 1024)):
        qdt = torch.float32 if dtype == "float32" else torch.bfloat16
        q = torch.randn((b, kvh, g, hd), generator=gen, device="cuda").to(qdt)
        if dtype == "int8":
            k = torch.randint(-127, 128, (b, c, kvh, hd), generator=gen, device="cuda", dtype=torch.int8)
            v = torch.randint(-127, 128, (b, c, kvh, hd), generator=gen, device="cuda", dtype=torch.int8)
            ks = (torch.rand((b, c, kvh), generator=gen, device="cuda") * 0.05 + 0.01).bfloat16()
            vs = (torch.rand((b, c, kvh), generator=gen, device="cuda") * 0.05 + 0.01).bfloat16()
        else:
            k = torch.randn((b, c, kvh, hd), generator=gen, device="cuda").to(qdt)
            v = torch.randn((b, c, kvh, hd), generator=gen, device="cuda").to(qdt)
            ks = vs = None
        n = torch.tensor(([0, 1, 63, c] * b)[:b], dtype=torch.int32, device="cuda")
        for softcap in (0.0, 30.0):
            got = cuda_kernel.flash_decode(q, k, v, ks, vs, n, softcap=softcap).float()
            want = flash_decode_ref(q, k, v, ks, vs, n[:, None], block_kv=64, softcap=softcap).float()
            tol = 2e-5 if qdt == torch.float32 else 2.0 ** -7
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_cuda_split_kernel_matches_plain(dtype):
    """Caches long enough to split across blocks (nsplit > 1, the merge
    kernel after the split kernel), n_valid 0 / 1 / 63 / 65 leaving most
    splits empty, against ``flash_decode_ref`` and ``flash_decode_split_ref``
    with the plan's split count."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for b, kvh, g, hd, c, rows in ((4, 16, 1, 64, 1024, [0, 1, 63, 65]), (1, 16, 1, 64, 4096, [4001]),
                                   (4, 8, 2, 256, 1024, [1024, 65, 1, 0])):
        plan = cuda_kernel.decode_plan(b, kvh, g, c, sms)
        assert plan["nsplit"] > 1
        qdt = torch.float32 if dtype == "float32" else torch.bfloat16
        q = torch.randn((b, kvh, g, hd), generator=gen, device="cuda").to(qdt)
        if dtype == "int8":
            k = torch.randint(-127, 128, (b, c, kvh, hd), generator=gen, device="cuda", dtype=torch.int8)
            v = torch.randint(-127, 128, (b, c, kvh, hd), generator=gen, device="cuda", dtype=torch.int8)
            ks = (torch.rand((b, c, kvh), generator=gen, device="cuda") * 0.05 + 0.01).bfloat16()
            vs = (torch.rand((b, c, kvh), generator=gen, device="cuda") * 0.05 + 0.01).bfloat16()
        else:
            k = torch.randn((b, c, kvh, hd), generator=gen, device="cuda").to(qdt)
            v = torch.randn((b, c, kvh, hd), generator=gen, device="cuda").to(qdt)
            ks = vs = None
        n = torch.tensor(rows, dtype=torch.int32, device="cuda")
        before = cuda_kernel.launch_count
        got = cuda_kernel.flash_decode(q, k, v, ks, vs, n).float()
        assert cuda_kernel.launch_count == before + 1
        tol = 2e-5 if qdt == torch.float32 else 2.0 ** -7
        for want in (flash_decode_ref(q, k, v, ks, vs, n[:, None], block_kv=64),
                     flash_decode_split_ref(q, k, v, ks, vs, n, nsplit=plan["nsplit"])):
            torch.testing.assert_close(got, want.float(), rtol=tol, atol=tol)
        assert torch.all(got[n == 0] == 0)
