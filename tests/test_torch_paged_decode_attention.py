"""The port's paged decode attention (``paged_flash_decode_ref``,
``paged_flash_decode_split_ref`` and ``paged_decode_attention``) against the
reference's ``paged_flash_decode_ref`` and its Pallas
``paged_flash_decode_kernel`` run in interpret mode, on inputs made from a
seed with numpy; paged against contiguous on the gathered cache (the split
versions bit for bit at one plan, since both pools run one CUDA body);
invariance to where the blocks lie in the pool; the windowed table slice;
the split plan at the engine's shape; and, on an sm_90 card only, the CUDA
kernel against the plain versions and against the contiguous kernel.

Tolerances as in tests/test_torch_decode_attention.py: 2e-6 for f32 pools
(the bound the reference pins between its own kernel and ref), 1e-5 for
int8 pools, whose dequantized summands reach ~8 and which torch's einsum
sums in another order than XLA's dot.
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import (  # noqa: E402
    cuda_kernel,
    flash_decode_ref,
    flash_decode_split_ref,
    paged_decode_attention,
    paged_flash_decode_ref,
    paged_flash_decode_split_ref,
)

TOL = dict(rtol=2e-6, atol=2e-6)
TOL_INT8 = dict(rtol=1e-5, atol=1e-5)
BS = 8


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


def _pool(seed, b, n_blocks, bs, kvh, g, hd, quantized):
    """q (B, KV, G, hd) f32 and a block pool as numpy arrays."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, kvh, g, hd)).astype(np.float32)
    shape = (n_blocks, bs, kvh, hd)
    if quantized:
        k = rng.integers(-127, 128, shape).astype(np.int8)
        v = rng.integers(-127, 128, shape).astype(np.int8)
        ks = (rng.random(shape[:3]) * 0.05 + 0.01).astype(np.float32)
        vs = (rng.random(shape[:3]) * 0.05 + 0.01).astype(np.float32)
        return q, k, v, ks, vs
    return q, rng.standard_normal(shape).astype(np.float32), rng.standard_normal(shape).astype(np.float32), None, None


def _table(seed, b, j, n_blocks):
    """(b, j) distinct physical ids drawn from 1..n_blocks-1 (never trash 0)."""
    ids = np.random.RandomState(seed).permutation(np.arange(1, n_blocks))[: b * j]
    return ids.reshape(b, j).astype(np.int32)


def _torch(q, k, v, ks, vs):
    bf = lambda a: None if a is None else torch.tensor(a).to(torch.bfloat16)
    return torch.tensor(q), torch.tensor(k), torch.tensor(v), bf(ks), bf(vs)


def _jax(q, k, v, ks, vs):
    import jax.numpy as jnp

    bf = lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16)
    return jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), bf(ks), bf(vs)


def _gathered(k, v, ks, vs, bt):
    """Request-major contiguous caches holding the table's rows."""
    b, j = bt.shape
    idx = torch.as_tensor(bt, dtype=torch.int64).reshape(-1)
    take = lambda a: None if a is None else a[idx].reshape((b, j * a.shape[1]) + tuple(a.shape[2:]))
    return take(k), take(v), take(ks), take(vs)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_ref_matches_reference_ref_and_kernel(jref, g, quantized, softcap):
    """Per-row n_valid in {0, 1, bs-1, bs, bs+1, J*bs} over a shuffled table:
    empty rows give zeros, ragged and full walks agree with both reference
    paths."""
    import jax.numpy as jnp

    b, j, kvh, hd, nblk = 6, 4, 2, 16, 32
    raw = _pool(g * 10 + quantized, b, nblk, BS, kvh, g, hd, quantized)
    bt = _table(g, b, j, nblk)
    n = np.array([0, 1, BS - 1, BS, BS + 1, j * BS], np.int32)
    got = paged_flash_decode_ref(*_torch(*raw), torch.tensor(bt), torch.tensor(n), block_size=BS,
                                 softcap=softcap).numpy()
    jargs = _jax(*raw) + (jnp.asarray(bt), jnp.asarray(n))
    want_ref = np.asarray(jref.paged_flash_decode_ref(*jargs, block_size=BS, softcap=softcap))
    want_ker = np.asarray(jref.paged_flash_decode_kernel(*jargs, block_size=BS, softcap=softcap, interpret=True))
    tol = TOL_INT8 if quantized else TOL
    np.testing.assert_allclose(got, want_ref, **tol)
    np.testing.assert_allclose(got, want_ker, **tol)
    np.testing.assert_array_equal(got[0], 0.0)


@pytest.mark.parametrize("hd,g", [(112, 8), (128, 7)], ids=["hd112-g8", "hd128-g7"])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_ref_at_kimi_and_arctic_heads(jref, hd, g, quantized, softcap):
    """The paged walk at kimi-k2's decode heads (hd 112, G 8) and arctic's
    G 7 at hd 128, over a shuffled table, against both reference paths;
    the split arithmetic at three splits equals the plain walk."""
    import jax.numpy as jnp

    b, j, kvh, nblk = 6, 4, 2, 32
    raw = _pool(hd + g + quantized, b, nblk, BS, kvh, g, hd, quantized)
    bt = _table(hd, b, j, nblk)
    n = np.array([0, 1, BS - 1, BS, BS + 1, j * BS], np.int32)
    targs = _torch(*raw) + (torch.tensor(bt), torch.tensor(n))
    got = paged_flash_decode_ref(*targs, block_size=BS, softcap=softcap).numpy()
    split = paged_flash_decode_split_ref(*targs, block_size=BS, nsplit=3, softcap=softcap).numpy()
    jargs = _jax(*raw) + (jnp.asarray(bt), jnp.asarray(n))
    want_ref = np.asarray(jref.paged_flash_decode_ref(*jargs, block_size=BS, softcap=softcap))
    want_ker = np.asarray(jref.paged_flash_decode_kernel(*jargs, block_size=BS, softcap=softcap, interpret=True))
    tol = TOL_INT8 if quantized else TOL
    for out in (got, split):
        np.testing.assert_allclose(out, want_ref, **tol)
        np.testing.assert_allclose(out, want_ker, **tol)
        np.testing.assert_array_equal(out[0], 0.0)


@pytest.mark.parametrize("g", [1, 4])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("n_valid", [1, BS - 1, BS, 4 * BS])
def test_paged_matches_contiguous_on_gathered_cache(g, quantized, n_valid):
    """The paged walk over shuffled blocks equals the contiguous flash decode
    over the same rows gathered into request-major caches."""
    b, j, kvh, hd = 2, 4, 2, 16
    q, k, v, ks, vs = _torch(*_pool(7, b, 16, BS, kvh, g, hd, quantized))
    bt = torch.tensor(_table(7, b, j, 16))
    n = torch.full((b,), n_valid, dtype=torch.int32)
    paged = paged_flash_decode_ref(q, k, v, ks, vs, bt, n, block_size=BS)
    contiguous = flash_decode_ref(q, *_gathered(k, v, ks, vs, bt), n[:, None], block_kv=BS)
    torch.testing.assert_close(paged, contiguous, **TOL)


SPLIT_J = 6                                   # 48 logical rows a request


def _split_lengths(nsplit):
    """n_valid per request: 0, 1, bs - 1, bs, bs + 1, each split boundary
    - 1 / 0 / + 1, and the full table."""
    rows = SPLIT_J * BS
    per = -(-rows // nsplit)
    edges = [e + d for e in range(per, rows, per) for d in (-1, 0, 1)]
    return np.array(sorted({0, 1, BS - 1, BS, BS + 1, rows, *edges}), np.int32)


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_split_ref_matches_reference(jref, g, quantized, softcap):
    """The split-KV arithmetic the paged CUDA body runs (per-split partials
    over the table's rows, then the merge) against both reference paths and
    ``paged_flash_decode_ref``, at 1, 2 and 3 splits of 48 rows (G 8 is two
    group tiles on the card).  Splits past a request's n_valid see no row
    and merge to nothing (zeros for n_valid 0)."""
    import jax.numpy as jnp

    kvh, hd = 2, 16
    for nsplit in (1, 2, 3):
        n = _split_lengths(nsplit)
        b = n.size
        raw = _pool(100 * g + 10 * nsplit + quantized, b, b * SPLIT_J + 1, BS, kvh, g, hd, quantized)
        bt = _table(nsplit, b, SPLIT_J, b * SPLIT_J + 1)
        targs = _torch(*raw) + (torch.tensor(bt), torch.tensor(n))
        got = paged_flash_decode_split_ref(*targs, block_size=BS, nsplit=nsplit, softcap=softcap).numpy()
        plain = paged_flash_decode_ref(*targs, block_size=BS, softcap=softcap).numpy()
        jargs = _jax(*raw) + (jnp.asarray(bt), jnp.asarray(n))
        want_ref = np.asarray(jref.paged_flash_decode_ref(*jargs, block_size=BS, softcap=softcap))
        want_ker = np.asarray(jref.paged_flash_decode_kernel(*jargs, block_size=BS, softcap=softcap, interpret=True))
        tol = TOL_INT8 if quantized else TOL
        for want in (plain, want_ref, want_ker):
            np.testing.assert_allclose(got, want, **tol, err_msg=f"nsplit={nsplit}")
        np.testing.assert_array_equal(got[0], 0.0)


@pytest.mark.parametrize("g", [1, 2, 8])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("nsplit", [1, 2, 3])
def test_split_ref_equals_contiguous_split_on_gathered_cache(g, quantized, nsplit):
    """At one plan the paged split arithmetic over a shuffled table is the
    contiguous one over the same rows gathered in logical order, bit for
    bit: what lets both engine pools give the same tokens."""
    n = _split_lengths(nsplit)
    b = n.size
    q, k, v, ks, vs = _torch(*_pool(7 * g + nsplit, b, b * SPLIT_J + 1, BS, 2, g, 16, quantized))
    bt = torch.tensor(_table(g + nsplit, b, SPLIT_J, b * SPLIT_J + 1))
    for softcap in (0.0, 30.0):
        paged = paged_flash_decode_split_ref(q, k, v, ks, vs, bt, torch.tensor(n), block_size=BS, nsplit=nsplit,
                                             softcap=softcap)
        contiguous = flash_decode_split_ref(q, *_gathered(k, v, ks, vs, bt), torch.tensor(n), nsplit=nsplit,
                                            softcap=softcap)
        assert torch.equal(paged, contiguous)


def test_decode_plan_at_the_engine_shape():
    """The engine's main path (8 slots, 16 KV heads, G 1, a 10-block table
    of 16 rows = max_seq 160) walks its rows in one split, no merge, the
    plan the contiguous pool's 160-row slot cache takes too; a 20-block
    table (320 rows) splits in three."""
    assert cuda_kernel.decode_plan(8, 16, 1, 10 * 16, sms=132) == dict(nsplit=1, rows_per_split=160, kernels=1)
    assert cuda_kernel.decode_plan(8, 16, 1, 20 * 16, sms=132) == dict(nsplit=3, rows_per_split=107, kernels=2)


def test_physical_permutation_invariance():
    """The same logical rows under two physical placements give bitwise
    equal outputs: the walk follows the table in logical order."""
    b, j, kvh, g, hd = 2, 4, 2, 2, 16
    q, k, v, ks, vs = _torch(*_pool(9, b, 16, BS, kvh, g, hd, True))
    bt1, bt2 = torch.tensor(_table(1, b, j, 16)), torch.tensor(_table(2, b, j, 16))
    moved = []
    for a in (k, v, ks, vs):
        out = torch.zeros_like(a)
        out[bt2.reshape(-1).long()] = a[bt1.reshape(-1).long()]
        moved.append(out)
    n = torch.tensor([5, 3 * BS + 2], dtype=torch.int32)
    a = paged_flash_decode_ref(q, k, v, ks, vs, bt1, n, block_size=BS)
    b_ = paged_flash_decode_ref(q, *moved, bt2, n, block_size=BS)
    assert torch.equal(a, b_)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_windowed_layer_slices_table(jref, impl):
    """``paged_decode_attention(seq_len=...)`` walks only the layer's own
    ``ceil(seq_len / bs)`` table entries: out-of-range ids in the tail of a
    wider row never reach the walk, and the result equals the reference's
    ``paged_decode_attention`` and the contiguous walk over the first blocks."""
    import jax.numpy as jnp

    b, j, kvh, g, hd = 2, 4, 2, 2, 16
    raw = _pool(11, b, 16, BS, kvh, g, hd, False)
    q, k, v, _, _ = _torch(*raw)
    bt = _table(11, b, j, 16)
    wide = bt.copy()
    wide[:, 2:] = 10_000                                  # would fault if walked
    seq_len = BS + 3                                      # cache_len of a window-11 layer
    for n_valid in (1, BS, seq_len):
        n = np.full((b,), n_valid, np.int32)
        got = paged_decode_attention(q[:, None], {"k": k, "v": v}, torch.tensor(wide), torch.tensor(n),
                                     seq_len=seq_len, block_size=BS)[:, 0]
        jq, jk, jv, _, _ = _jax(*raw)
        want = jref.paged_decode_attention(jq[:, None], {"k": jk, "v": jv}, jnp.asarray(bt), jnp.asarray(n),
                                           seq_len=seq_len, block_size=BS, impl=impl, interpret=True)[:, 0]
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL, err_msg=f"n_valid={n_valid}")
        gk, gv, _, _ = _gathered(k, v, None, None, torch.tensor(bt[:, :2]))
        contiguous = flash_decode_ref(q, gk, gv, None, None, torch.tensor(n)[:, None], block_kv=BS)
        torch.testing.assert_close(got, contiguous, **TOL)


def _card_pool(gen, b, j, bs, kvh, g, hd, dtype):
    """q, a pool of ``b * j + 1`` blocks and a shuffled (b, j) table on the card."""
    qdt = torch.float32 if dtype == "float32" else torch.bfloat16
    nblk = b * j + 1
    q = torch.randn((b, kvh, g, hd), generator=gen, device="cuda").to(qdt)
    shape = (nblk, bs, kvh, hd)
    if dtype == "int8":
        k = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        v = torch.randint(-127, 128, shape, generator=gen, device="cuda", dtype=torch.int8)
        ks = (torch.rand(shape[:3], generator=gen, device="cuda") * 0.05 + 0.01).bfloat16()
        vs = (torch.rand(shape[:3], generator=gen, device="cuda") * 0.05 + 0.01).bfloat16()
    else:
        k = torch.randn(shape, generator=gen, device="cuda").to(qdt)
        v = torch.randn(shape, generator=gen, device="cuda").to(qdt)
        ks = vs = None
    bt = (torch.randperm(b * j, generator=gen, device="cuda") + 1).reshape(b, j).to(torch.int32)
    return q, k, v, ks, vs, bt


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_cuda_kernel_matches_plain(dtype):
    """The paged CUDA kernel against its plain versions on the card, at the
    engine's main head shape, gemma3's (G = 2, hd = 256), kimi-k2's (G 8,
    hd 112) and arctic's G 7 at hd 128, over a shuffled
    table with n_valid rows 0, 1, bs-1, bs, bs+1 and the full table; the
    160-row table is one split, the 320-row one splits (the merge kernel
    after the split kernel)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    bs = 16
    for (b, kvh, g, hd), j in itertools.product(((6, 16, 1, 64), (6, 8, 2, 256), (6, 8, 8, 112), (6, 8, 7, 128)),
                                                (10, 20)):
        q, k, v, ks, vs, bt = _card_pool(gen, b, j, bs, kvh, g, hd, dtype)
        nsplit = cuda_kernel.decode_plan(b, kvh, g, j * bs, sms)["nsplit"]
        assert (nsplit > 1) == (j == 20)
        n = torch.tensor([0, 1, bs - 1, bs, bs + 1, j * bs], dtype=torch.int32, device="cuda")
        for softcap in (0.0, 30.0):
            got = cuda_kernel.paged_flash_decode(q, k, v, ks, vs, bt, n, softcap=softcap).float()
            tol = 2e-5 if q.dtype == torch.float32 else 2.0 ** -7
            for want in (paged_flash_decode_ref(q, k, v, ks, vs, bt, n, block_size=bs, softcap=softcap),
                         paged_flash_decode_split_ref(q, k, v, ks, vs, bt, n, block_size=bs, nsplit=nsplit,
                                                      softcap=softcap)):
                torch.testing.assert_close(got, want.float(), rtol=tol, atol=tol)
            assert torch.all(got[0] == 0)


@pytest.mark.usefixtures("hopper")
@pytest.mark.parametrize("dtype", ["bfloat16", "int8", "float32"])
def test_cuda_paged_equals_contiguous_kernel(dtype):
    """One CUDA body serves both pools: the paged kernel over a shuffled
    table equals the contiguous kernel over the same rows gathered in
    logical order, bit for bit, at the engine's shape (one split) and at
    twice its rows (three splits)."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, bs = 8, 16
    for j in (10, 20):
        q, k, v, ks, vs, bt = _card_pool(gen, b, j, bs, 16, 1, 64, dtype)
        n = torch.tensor([22, 30, 46, 78, 144, j * bs, 107, 108], dtype=torch.int32, device="cuda")
        gk, gv, gks, gvs = _gathered(k, v, ks, vs, bt)
        paged = cuda_kernel.paged_flash_decode(q, k, v, ks, vs, bt, n)
        contiguous = cuda_kernel.flash_decode(q, gk, gv, gks, gvs, n)
        assert torch.equal(paged, contiguous)
