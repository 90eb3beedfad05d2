"""Plain PyTorch flash decode: the port's twin of
``repro/kernels/decode_attention/ref.py`` (``flash_decode_ref`` and
``paged_flash_decode_ref``).

Both mirror the reference op for op: f32 dequantization of each KV block,
scores ``q . k * 1/sqrt(hd)``, optional ``tanh(s / cap) * cap``, the
``k_pos < n_valid`` mask applied as ``where(mask, s, -1e30)`` before the
max, ``exp`` then ``where(mask, p, 0)``, the online-softmax update, and
``acc / max(l, 1e-20)`` cast to q's dtype.  The reference vmaps a
``fori_loop`` over ``ceil(n_valid / block)`` blocks per (request, head);
here the block loop runs to the largest row's bound for all rows at once,
and a row whose own bound has passed keeps its carry (what the vmapped
loop does).  The contiguous version slices block ``kj`` of each row's
cache; the paged version fetches physical block ``block_table[b, kj]`` of
the shared pool.  They are the CPU path of ``dispatch`` and the plain
versions the CUDA kernels are held against on the card.

``flash_decode_split_ref`` is the plain version of the CUDA split-KV
body's arithmetic: per split of ``split_rows(C, nsplit)`` rows the partial
(m, l, acc), then the merge.  Both pools run that one body on the card, so
``paged_flash_decode_split_ref`` gathers the table's blocks into a
request-major cache and takes the same splits.  The tests hold both to
``flash_decode_ref`` / ``paged_flash_decode_ref`` and to the reference;
the model never calls them.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1.0e30


def _walk(q: torch.Tensor, n_valid: torch.Tensor, block: int, fetch, softcap: float) -> torch.Tensor:
    """The online softmax over ``ceil(n_valid / block)`` blocks per row.
    ``fetch(kj)`` returns block ``kj`` of every row as f32 ``(B, block, KV,
    hd)`` k and v, already dequantized."""
    b, kvh, g, hd = q.shape
    qf = q.float()
    scale = float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(hd))))
    nv = n_valid.reshape(b).to(torch.int64)
    n_blocks = (nv + block - 1) // block                             # (B,)
    acc = torch.zeros((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, kvh, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g), dtype=torch.float32, device=q.device)
    steps = int(n_blocks.max()) if b else 0
    iota = torch.arange(block, device=q.device)
    for kj in range(steps):
        kb, vb = fetch(kj)
        s = torch.einsum("bkgh,bskh->bkgs", qf, kb) * scale          # (B, KV, G, block)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        msk = ((kj * block + iota)[None, :] < nv[:, None])[:, None, None, :]
        s = torch.where(msk, s, NEG_INF)
        s_max = s.amax(dim=-1)
        m_new = torch.maximum(m, s_max)
        p = torch.exp(s - m_new[..., None])
        p = torch.where(msk, p, 0.0)
        corr = torch.exp(m - m_new)
        l_new = l * corr + p.sum(dim=-1)
        pv = torch.einsum("bkgs,bskh->bkgh", p, vb)
        acc_new = acc * corr[..., None] + pv
        live = (kj < n_blocks)[:, None, None]                        # (B, 1, 1)
        acc = torch.where(live[..., None], acc_new, acc)
        m = torch.where(live, m_new, m)
        l = torch.where(live, l_new, l)
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(q.dtype)                                           # (B, KV, G, hd)


def _dequant(x: torch.Tensor, scale: Optional[torch.Tensor]) -> torch.Tensor:
    x = x.float()
    return x if scale is None else x * scale.float()[..., None]


def flash_decode_ref(
    q: torch.Tensor,                     # (B, KV, G, hd)
    k: torch.Tensor,                     # (B, C, KV, hd)
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],     # (B, C, KV) or None
    v_scale: Optional[torch.Tensor],
    n_valid: torch.Tensor,               # (B, 1) int32
    *,
    block_kv: int = 64,
    softcap: float = 0.0,
) -> torch.Tensor:
    assert k.shape[1] % block_kv == 0, (k.shape, block_kv)
    quantized = k_scale is not None

    def fetch(kj):
        sl = slice(kj * block_kv, (kj + 1) * block_kv)
        return (_dequant(k[:, sl], k_scale[:, sl] if quantized else None),
                _dequant(v[:, sl], v_scale[:, sl] if quantized else None))

    return _walk(q, n_valid, block_kv, fetch, softcap)


def paged_flash_decode_ref(
    q: torch.Tensor,                     # (B, KV, G, hd)
    k: torch.Tensor,                     # (N, bs, KV, hd) block pool
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],     # (N, bs, KV) or None
    v_scale: Optional[torch.Tensor],
    block_table: torch.Tensor,           # (B, J) int32 physical block ids
    n_valid: torch.Tensor,               # (B,) int32
    *,
    block_size: int,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Paged twin of :func:`flash_decode_ref`: row ``b``'s logical block
    ``kj`` is pool block ``block_table[b, kj]``.  ``n_valid`` is clamped to
    the table's ``J * block_size`` rows, as the CUDA kernel clamps it."""
    assert k.shape[1] == block_size, (k.shape, block_size)
    quantized = k_scale is not None
    bt = block_table.to(torch.int64)
    n = torch.clamp(n_valid.reshape(-1), max=bt.shape[1] * block_size)

    def fetch(kj):
        pid = bt[:, kj]
        return (_dequant(k[pid], k_scale[pid] if quantized else None),
                _dequant(v[pid], v_scale[pid] if quantized else None))

    return _walk(q, n, block_size, fetch, softcap)


def split_rows(cache_len: int, nsplit: int) -> int:
    """Cache rows of each split: split ``s`` covers ``[s * r, (s + 1) * r)``."""
    return -(-cache_len // nsplit)


def flash_decode_split_ref(
    q: torch.Tensor,                     # (B, KV, G, hd)
    k: torch.Tensor,                     # (B, C, KV, hd)
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],     # (B, C, KV) or None
    v_scale: Optional[torch.Tensor],
    n_valid: torch.Tensor,               # (B,) or (B, 1) int32
    *,
    nsplit: int,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Split-KV decode attention: split ``s`` takes the valid rows of
    ``[s * r, (s + 1) * r)`` (``r = split_rows(C, nsplit)``) to
    ``m_s = max score`` (-1e30 when it sees none), ``l_s = sum e^(s - m_s)``
    and ``acc_s = sum e^(s - m_s) v``; then ``M = max m_s`` and
    ``out = sum acc_s e^(m_s - M) / max(sum l_s e^(m_s - M), 1e-20)``."""
    b, kvh, g, hd = q.shape
    c = k.shape[1]
    rows = split_rows(c, nsplit)
    scale = float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(hd))))
    kf = _dequant(k, k_scale)
    vf = _dequant(v, v_scale)
    s = torch.einsum("bkgh,bskh->bkgs", q.float(), kf) * scale       # (B, KV, G, C)
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    pad = nsplit * rows - c
    s = torch.nn.functional.pad(s, (0, pad), value=NEG_INF).reshape(b, kvh, g, nsplit, rows)
    vf = torch.nn.functional.pad(vf, (0, 0, 0, 0, 0, pad)).reshape(b, nsplit, rows, kvh, hd)
    nv = n_valid.reshape(b).to(torch.int64)
    msk = (torch.arange(nsplit * rows, device=q.device)[None, :] < nv[:, None]).reshape(b, 1, 1, nsplit, rows)
    s = torch.where(msk, s, NEG_INF)
    m = s.amax(dim=-1)                                              # (B, KV, G, nsplit)
    p = torch.where(msk, torch.exp(s - m[..., None]), 0.0)
    l = p.sum(dim=-1)
    acc = torch.einsum("bkgnr,bnrkh->bkgnh", p, vf)
    big = m.amax(dim=-1, keepdim=True)
    w = torch.exp(m - big)
    out = (acc * w[..., None]).sum(dim=3) / torch.clamp((l * w).sum(dim=-1), min=1e-20)[..., None]
    return out.to(q.dtype)


def paged_flash_decode_split_ref(
    q: torch.Tensor,                     # (B, KV, G, hd)
    k: torch.Tensor,                     # (N, bs, KV, hd) block pool
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],     # (N, bs, KV) or None
    v_scale: Optional[torch.Tensor],
    block_table: torch.Tensor,           # (B, J) int32 physical block ids
    n_valid: torch.Tensor,               # (B,) int32
    *,
    block_size: int,
    nsplit: int,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Paged twin of :func:`flash_decode_split_ref`: request ``b``'s logical
    row ``p`` is pool row ``block_table[b, p // bs] * bs + p % bs``, so the
    table's blocks gathered in order make a ``(B, J * bs, KV, hd)`` cache,
    split as the contiguous one is.  ``n_valid`` is clamped to the table's
    ``J * bs`` rows, as the CUDA kernel clamps it."""
    assert k.shape[1] == block_size, (k.shape, block_size)
    b, j = block_table.shape
    idx = block_table.to(torch.int64).reshape(-1)

    def take(a):
        return None if a is None else a[idx].reshape((b, j * block_size) + tuple(a.shape[2:]))

    n = torch.clamp(n_valid.reshape(-1), max=j * block_size)
    return flash_decode_split_ref(q, take(k), take(v), take(k_scale), take(v_scale), n, nsplit=nsplit,
                                  softcap=softcap)
