"""Context-parallel decode's fold (``fold_partials_ref``): a rank's S
split partials folded into one unnormalised entry a row before the
all-gather, then the cross-rank merge (``merge_partials_ref``) over the R
ranks' entries, on inputs made from a seed with numpy.

At R in {2, 4} row shards of S in {1, 2, 3} splits each, with f32 and int8
caches, the fold then the merge is held to the merge of all R x S splits,
to the port's whole-cache ``flash_decode_ref`` and to the reference's
(``repro/kernels/decode_attention/ref.py``).  Every n_valid from 1 to C is
a row of the batch, so ranks past the valid prefix hold no valid row: their
fold is (m, l, acc) = (-1e30, 0, 0) exactly.  The fold of one split is that
split bit for bit, and one rank's fold then the merge is
``flash_decode_split_ref`` bit for bit (a world of one, in plain form).
On the CPU, ``decode_attention_partials`` gives one entry a row (S = 1) as
views of one flat buffer, the layout the card's fold writes.

Tolerance: rtol = atol = 2e-6 for f32 caches, 1e-5 for int8, as
``tests/test_torch_decode_partials.py`` (the partials add the rows in
another order than the reference's 8-row blocks).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_partials,
    flash_decode_partials_ref,
    flash_decode_ref,
    flash_decode_split_ref,
    fold_partials_ref,
    merge_partials_ref,
    partials_buffer,
)

TOL = dict(rtol=2e-6, atol=2e-6)
TOL_INT8 = dict(rtol=1e-5, atol=1e-5)
C, KV, G, HD, BKV = 24, 2, 4, 32, 8


def _inputs(seed, quantized):
    """Request b attends over n_valid b + 1 of its C rows (every count)."""
    rng = np.random.default_rng(seed)
    b = C
    q = rng.standard_normal((b, KV, G, HD)).astype(np.float32)
    n = np.arange(1, C + 1, dtype=np.int32)
    if quantized:
        k = rng.integers(-127, 128, (b, C, KV, HD)).astype(np.int8)
        v = rng.integers(-127, 128, (b, C, KV, HD)).astype(np.int8)
        # Scales as the cache stores them: bf16 values.
        ks = (rng.random((b, C, KV)) * 0.05 + 0.01).astype(np.float32)
        vs = (rng.random((b, C, KV)) * 0.05 + 0.01).astype(np.float32)
        return q, k, v, ks, vs, n
    k = rng.standard_normal((b, C, KV, HD)).astype(np.float32)
    v = rng.standard_normal((b, C, KV, HD)).astype(np.float32)
    return q, k, v, None, None, n


def _torch(raw):
    q, k, v = (torch.tensor(a) for a in raw[:3])
    ks, vs = (None if a is None else torch.tensor(a).to(torch.bfloat16) for a in raw[3:5])
    return q, k, v, ks, vs, torch.tensor(raw[5])


@functools.lru_cache(maxsize=None)
def _reference(quantized):
    """The reference's whole-cache decode of ``_inputs(quantized)``."""
    import jax.numpy as jnp

    from repro.kernels.decode_attention import ref as jref

    raw = _inputs(quantized, quantized)
    bf = (lambda a: None if a is None else jnp.asarray(a, jnp.bfloat16))
    return np.asarray(jref.flash_decode_ref(jnp.asarray(raw[0]), jnp.asarray(raw[1]), jnp.asarray(raw[2]),
                                            bf(raw[3]), bf(raw[4]), jnp.asarray(raw[5][:, None]), block_kv=BKV))


def _rank_partials(q, k, v, ks, vs, n, r, ranks, nsplit):
    """Rank ``r``'s S partials over its rows, at its local n_valid."""
    rows = C // ranks
    sl = slice(r * rows, (r + 1) * rows)
    return flash_decode_partials_ref(q, k[:, sl], v[:, sl], None if ks is None else ks[:, sl],
                                     None if vs is None else vs[:, sl], torch.clamp(n - r * rows, 0, rows),
                                     nsplit=nsplit)


@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("ranks", [2, 4])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_fold_then_merge_matches_whole_cache(quantized, ranks, nsplit):
    q, k, v, ks, vs, n = _torch(_inputs(quantized, quantized))
    tol = TOL_INT8 if quantized else TOL
    parts = [_rank_partials(q, k, v, ks, vs, n, r, ranks, nsplit) for r in range(ranks)]
    folded = [fold_partials_ref(a, m) for a, m in parts]
    for a, m in folded:
        assert a.shape == (C, KV, G, 1, HD) and m.shape == (C, KV, G, 1, 2)
        assert not (torch.isnan(a).any() or torch.isnan(m).any())
    got = merge_partials_ref(torch.stack([a for a, _ in folded]), torch.stack([m for _, m in folded]), torch.float32)
    assert not torch.isnan(got).any()
    every = merge_partials_ref(torch.stack([a for a, _ in parts]), torch.stack([m for _, m in parts]), torch.float32)
    np.testing.assert_allclose(got.numpy(), every.numpy(), **tol, err_msg="R entries against R x S splits")
    whole = flash_decode_ref(q, k, v, ks, vs, n[:, None], block_kv=BKV).numpy()
    np.testing.assert_allclose(got.numpy(), whole, **tol, err_msg="against the port's whole cache")
    np.testing.assert_allclose(got.numpy(), _reference(quantized), **tol, err_msg="against the reference")


@pytest.mark.parametrize("nsplit", [1, 2, 3])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_fold_of_an_empty_rank_is_exact(quantized, nsplit):
    """Rank r of 4 holds no valid row for a request whose n_valid stops
    before its rows: its fold is (-1e30, 0, 0) exactly, and so adds
    nothing to the merge."""
    q, k, v, ks, vs, n = _torch(_inputs(10 + quantized, quantized))
    ranks, rows = 4, C // 4
    for r in range(1, ranks):
        acc, ml = fold_partials_ref(*_rank_partials(q, k, v, ks, vs, n, r, ranks, nsplit))
        empty = n <= r * rows
        assert bool(empty.any())
        assert bool((ml[empty][..., 0] == -1.0e30).all() and (ml[empty][..., 1] == 0).all())
        assert bool((acc[empty] == 0).all())
        assert bool((ml[~empty][..., 1] > 0).all())


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_fold_of_one_split_is_the_identity(quantized):
    q, k, v, ks, vs, n = _torch(_inputs(20 + quantized, quantized))
    for r in range(2):
        acc, ml = _rank_partials(q, k, v, ks, vs, n, r, 2, 1)
        f_acc, f_ml = fold_partials_ref(acc, ml)
        assert torch.equal(f_acc, acc) and torch.equal(f_ml, ml)


@pytest.mark.parametrize("nsplit", [1, 2, 3, 7])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_world_of_one_fold_then_merge_is_the_split_decode(quantized, nsplit):
    """One rank holding the whole cache: its splits folded, then the merge
    over one entry, is ``flash_decode_split_ref`` at the same splits bit
    for bit (e^(M - M) = 1), the plain form of the card's claim that a
    world of one decodes as the one-call kernel does."""
    q, k, v, ks, vs, n = _torch(_inputs(30 + quantized, quantized))
    acc, ml = fold_partials_ref(*flash_decode_partials_ref(q, k, v, ks, vs, n, nsplit=nsplit))
    got = merge_partials_ref(acc[None], ml[None], torch.float32)
    assert torch.equal(got, flash_decode_split_ref(q, k, v, ks, vs, n, nsplit=nsplit))


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_cpu_partials_are_one_entry_in_one_buffer(quantized):
    """``decode_attention_partials`` on the CPU: S == 1, ``acc`` then
    ``ml`` in one flat buffer of B * KV * G * (hd + 2) floats (what one
    all-gather moves, R times that over R ranks), and the fold of that one
    entry is itself."""
    q, k, v, ks, vs, n = _torch(_inputs(40 + quantized, quantized))
    cache = {"k": k, "v": v}
    if quantized:
        cache.update(k_scale=ks, v_scale=vs)
    acc, ml = decode_attention_partials(q[:, None], cache, n)
    assert acc.shape == (C, KV, G, 1, HD) and ml.shape == (C, KV, G, 1, 2)
    buf = partials_buffer(acc, ml)
    assert buf.data_ptr() == acc.data_ptr() and buf.numel() == C * KV * G * (HD + 2)
    f_acc, f_ml = fold_partials_ref(acc, ml)
    assert torch.equal(f_acc, acc) and torch.equal(f_ml, ml)
