"""Context-parallel decode's halves (``repro_torch.kernels.decode_attention``):
a rank's flash-decode partials (``flash_decode_partials_ref``) and the merge
of R ranks' gathered partials (``merge_partials_ref``), on inputs made from
a seed with numpy, against the whole-cache ``flash_decode_ref`` of the port
and of the reference (``repro/kernels/decode_attention/ref.py``).

The cache of C rows is cut into R in {2, 4} row shards, as the data ranks
hold a KV sequence split over them; every n_valid from 1 to C is a row of
the batch, so ranks past the valid prefix hold no valid row (m = -1e30,
l = 0, acc = 0).  Each rank's partials come in S = 2 splits of its rows;
the merge over the R x S splits in rank order is held to the whole-cache
decode and to the merge of the ranks' pre-merged partials (one split a
rank), and nothing is NaN.

Tolerance: rtol = atol = 2e-6 for f32 caches, 1e-5 for int8 (ROADMAP
section C; tests/test_torch_decode_attention.py says why): the partials
add the rows in another order than the reference's 8-row blocks.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_partials,
    flash_decode_partials_ref,
    flash_decode_ref,
    merge_decode_partials,
    merge_partials_ref,
    partials_buffer,
    split_partials,
)

TOL = dict(rtol=2e-6, atol=2e-6)
TOL_INT8 = dict(rtol=1e-5, atol=1e-5)
C, KV, BKV, S = 32, 2, 8, 2
RANKS = (2, 4)


def _inputs(seed, g, hd, quantized):
    """Request b attends over n_valid b + 1 of its C rows (every count)."""
    rng = np.random.default_rng(seed)
    b = C
    q = rng.standard_normal((b, KV, g, hd)).astype(np.float32)
    n = np.arange(1, C + 1, dtype=np.int32)
    if quantized:
        k = rng.integers(-127, 128, (b, C, KV, hd)).astype(np.int8)
        v = rng.integers(-127, 128, (b, C, KV, hd)).astype(np.int8)
        # Scales as the cache stores them: bf16 values.
        ks = torch.tensor((rng.random((b, C, KV)) * 0.05 + 0.01).astype(np.float32)).to(torch.bfloat16)
        vs = torch.tensor((rng.random((b, C, KV)) * 0.05 + 0.01).astype(np.float32)).to(torch.bfloat16)
        return q, k, v, ks, vs, n
    k = rng.standard_normal((b, C, KV, hd)).astype(np.float32)
    v = rng.standard_normal((b, C, KV, hd)).astype(np.float32)
    return q, k, v, None, None, n


def _rank_partials(q, k, v, ks, vs, n, r, ranks, nsplit, softcap):
    """Rank ``r``'s partials over its rows, at its local n_valid."""
    rows = C // ranks
    sl = slice(r * rows, (r + 1) * rows)
    local = torch.clamp(n - r * rows, 0, rows).to(torch.int32)
    return flash_decode_partials_ref(q, k[:, sl], v[:, sl], None if ks is None else ks[:, sl],
                                     None if vs is None else vs[:, sl], local, nsplit=nsplit, softcap=softcap)


def _premerged(acc, ml):
    """A rank's S splits merged into one unnormalised partial."""
    m, l = ml[..., 0], ml[..., 1]
    big = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - big)
    return ((acc * w[..., None]).sum(dim=3, keepdim=True),
            torch.stack([big, (l * w).sum(dim=-1, keepdim=True)], dim=-1))


@pytest.mark.parametrize("softcap", [0.0, 30.0], ids=["nocap", "cap30"])
@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("hd", [64, 112])
@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_ranks_partials_merge_to_the_whole_cache(quantized, hd, g, softcap):
    import jax.numpy as jnp

    from repro.kernels.decode_attention import ref as jref

    raw = _inputs(hd * 10 + g + quantized, g, hd, quantized)
    q, k, v = (torch.tensor(a) for a in raw[:3])
    ks, vs, n = raw[3], raw[4], torch.tensor(raw[5])
    tol = TOL_INT8 if quantized else TOL
    whole = flash_decode_ref(q, k, v, ks, vs, n[:, None], block_kv=BKV, softcap=softcap).numpy()
    bf = (lambda a: None if a is None else jnp.asarray(a.float().numpy(), jnp.bfloat16))
    want = np.asarray(jref.flash_decode_ref(jnp.asarray(raw[0]), jnp.asarray(raw[1]), jnp.asarray(raw[2]), bf(ks),
                                            bf(vs), jnp.asarray(raw[5][:, None]), block_kv=BKV, softcap=softcap))
    for ranks in RANKS:
        parts = [_rank_partials(q, k, v, ks, vs, n, r, ranks, S, softcap) for r in range(ranks)]
        acc = torch.stack([a for a, _ in parts])                      # (R, B, KV, G, S, hd)
        ml = torch.stack([m for _, m in parts])
        for a, m in parts:
            assert not (torch.isnan(a).any() or torch.isnan(m).any())
        # A rank past the request's valid prefix holds the empty partial.
        rows = C // ranks
        for r in range(1, ranks):
            empty = n <= r * rows
            assert bool((ml[r][empty][..., 0] == -1.0e30).all() and (ml[r][empty][..., 1] == 0).all())
            assert bool((acc[r][empty] == 0).all())
        got = merge_partials_ref(acc, ml, torch.float32)
        assert not torch.isnan(got).any()
        np.testing.assert_allclose(got.numpy(), whole, **tol, err_msg=f"R {ranks} against the port's whole cache")
        np.testing.assert_allclose(got.numpy(), want, **tol, err_msg=f"R {ranks} against the reference")
        pre = [_premerged(a, m) for a, m in parts]
        by_rank = merge_partials_ref(torch.stack([a for a, _ in pre]), torch.stack([m for _, m in pre]),
                                     torch.float32)
        np.testing.assert_allclose(got.numpy(), by_rank.numpy(), **tol, err_msg=f"R {ranks}: R x S against R")


@pytest.mark.parametrize("quantized", [False, True], ids=["f32", "int8"])
def test_dispatch_partials_one_buffer_and_gathered_merge(quantized):
    """The model-facing entry points on the CPU: a rank's ``(acc, ml)`` are
    views of one flat buffer (what one all-gather moves), an all-gather's
    ``(R, n)`` stack of those buffers cut back into rank-strided views
    merges to the plain merge of the stacked partials, and the whole
    cache's decode."""
    raw = _inputs(5 + quantized, 4, 64, quantized)
    q, k, v = (torch.tensor(a) for a in raw[:3])
    ks, vs, n = raw[3], raw[4], torch.tensor(raw[5])
    ranks, rows = 4, C // 4
    bufs, parts = [], []
    for r in range(ranks):
        sl = slice(r * rows, (r + 1) * rows)
        cache = {"k": k[:, sl].contiguous(), "v": v[:, sl].contiguous()}
        if quantized:
            cache.update(k_scale=ks[:, sl].contiguous(), v_scale=vs[:, sl].contiguous())
        acc, ml = decode_attention_partials(q[:, None], cache, torch.clamp(n - r * rows, 0, rows))
        assert acc.shape == (C, KV, 4, 1, 64) and ml.shape == (C, KV, 4, 1, 2)
        buf = partials_buffer(acc, ml)
        assert buf.data_ptr() == acc.data_ptr() and buf.numel() == acc.numel() + ml.numel()
        bufs.append(buf)
        parts.append((acc.clone(), ml.clone()))
    gathered = torch.stack(bufs)                                       # (R, n), as the all-gather
    acc_all, ml_all = split_partials(gathered, (C, KV, 4, 1), 64)
    assert acc_all.stride(0) == ml_all.stride(0) == gathered.shape[1]
    got = merge_decode_partials(acc_all, ml_all, torch.float32)[:, 0]
    want = merge_partials_ref(torch.stack([a for a, _ in parts]), torch.stack([m for _, m in parts]), torch.float32)
    assert torch.equal(got, want)
    whole = flash_decode_ref(q, k, v, ks, vs, n[:, None], block_kv=BKV)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **(TOL_INT8 if quantized else TOL))
    with pytest.raises(ValueError, match="one partial buffer"):
        partials_buffer(parts[0][0], parts[0][1])
