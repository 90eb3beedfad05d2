"""Decode-attention entry points: the port's twin of
``repro/kernels/decode_attention/ops.py``.

``decode_attention`` takes the model's grouped query ``(B, 1, KV, G, hd)``
and the rotating cache dict in its native ``(B, C, KV, hd)`` layout (int8
codes + bf16 scales, or float); ``paged_decode_attention`` takes the shared
``(N, bs, KV, hd)`` block pool and the requests' block tables.  A CUDA
tensor goes to the hand kernel, one split-KV body for both pools that walks
only the valid rows and masks the ragged tail itself; a CPU tensor goes to
the plain version, with the reference's block choice and pad path for
contiguous cache lengths that share no usable divisor with the block (65,
100, ...).

Context-parallel decode (the KV sequence split over ranks) takes the two
halves apart: ``decode_attention_partials`` gives a rank's one partial
entry a row over its rows (on the card the kernel's splits folded on the
rank, on the CPU one split), as views of one flat buffer
(``partials_buffer``) that one all-gather moves, and
``merge_decode_partials`` merges the ranks' gathered entries.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention import cuda_kernel
from repro_torch.kernels.decode_attention.cuda_kernel import split_partials
from repro_torch.kernels.decode_attention.torch_ref import (flash_decode_partials_ref, flash_decode_ref,
                                                           merge_partials_ref, paged_flash_decode_ref)


def decode_block_kv(cache_len: int, block_kv: int) -> int:
    """Effective KV block of the masked walk (``ops.py:54-67``): the largest
    common divisor of the cache length and ``block_kv`` when it is at least
    ``min(16, block)``, else ``block_kv`` itself (the cache is then padded)."""
    bkv = min(block_kv, cache_len)
    g = math.gcd(bkv, cache_len)
    return g if g >= min(16, bkv) else bkv


def _lengths(n_valid: Union[int, torch.Tensor], b: int, device) -> torch.Tensor:
    """(B,) int32 on ``device`` from a scalar or per-row count."""
    if isinstance(n_valid, int):
        return torch.full((b,), n_valid, dtype=torch.int32, device=device)
    return n_valid.to(device=device, dtype=torch.int32).reshape(-1).expand(b).contiguous()


def decode_attention(
    q: torch.Tensor,                     # (B, 1, KV, G, hd) grouped query
    cache: Dict[str, Any],               # k/v (B, C, KV, hd) [+ k/v_scale]
    n_valid: Union[int, torch.Tensor],   # scalar or (B,) live-slot count
    *,
    softcap: float = 0.0,
    block_kv: int = 64,
) -> torch.Tensor:
    """Length-masked decode attention over the rotating cache; returns
    ``(B, 1, KV, G, hd)`` in q's dtype."""
    b, s, kvh, g, hd = q.shape
    assert s == 1, f"decode attention is the s == 1 path, got S={s}"
    k, v = cache["k"], cache["v"]
    k_scale, v_scale = cache.get("k_scale"), cache.get("v_scale")
    n = _lengths(n_valid, b, q.device)
    qh = q[:, 0]                                             # (B, KV, G, hd)
    if runtime.use_kernel(q):
        out = cuda_kernel.flash_decode(qh, k, v, k_scale, v_scale, n, softcap=softcap)
        return out[:, None]
    c = k.shape[1]
    # On meta (shapes only) the walk takes the whole cache as one block.
    bkv = c if q.is_meta else decode_block_kv(c, block_kv)
    pad = (-c) % bkv
    if pad:
        # Padded rows sit at k_pos >= C >= n_valid, so the mask never reads them.
        grow = lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        k, v = grow(k), grow(v)
        if k_scale is not None:
            k_scale, v_scale = grow(k_scale), grow(v_scale)
    out = flash_decode_ref(qh, k, v, k_scale, v_scale, n[:, None], block_kv=bkv, softcap=softcap)
    return out[:, None]


def decode_attention_partials(
    q: torch.Tensor,                     # (B, 1, KV, G, hd) grouped query
    cache: Dict[str, Any],               # k/v (B, C_r, KV, hd) [+ k/v_scale]: this rank's rows
    n_valid: Union[int, torch.Tensor],   # scalar or (B,): valid rows among them
    *,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's decode partial over its cache rows, one unnormalised entry
    a row: ``acc`` (B, KV, G, 1, hd) and ``ml`` (B, KV, G, 1, 2) f32,
    views of one flat buffer (:func:`partials_buffer`), on every device
    type.  The card splits the rows as ``cuda_kernel.decode_plan`` says and
    folds the splits on the rank (``torch_ref.fold_partials_ref``); the CPU
    takes them as one split."""
    b, s, kvh, g, hd = q.shape
    assert s == 1, f"decode attention is the s == 1 path, got S={s}"
    k, v = cache["k"], cache["v"]
    k_scale, v_scale = cache.get("k_scale"), cache.get("v_scale")
    n = _lengths(n_valid, b, q.device)
    if runtime.use_kernel(q):
        return cuda_kernel.flash_decode_partials(q[:, 0], k, v, k_scale, v_scale, n, softcap=softcap)
    acc, ml = flash_decode_partials_ref(q[:, 0], k, v, k_scale, v_scale, n, nsplit=1, softcap=softcap)
    return split_partials(torch.cat([acc.reshape(-1), ml.reshape(-1)]), (b, kvh, g, 1), hd)


def partials_buffer(acc: torch.Tensor, ml: torch.Tensor) -> torch.Tensor:
    """The one flat f32 buffer a rank's ``acc`` and ``ml`` (from
    :func:`decode_attention_partials`) are views of, ``acc`` first; no
    copy."""
    if not (ml.storage_offset() == acc.storage_offset() + acc.numel() and acc.is_contiguous()
            and ml.is_contiguous()):
        raise ValueError("acc and ml are not views of one partial buffer")
    return acc.as_strided((acc.numel() + ml.numel(),), (1,), acc.storage_offset())


def merge_decode_partials(acc: torch.Tensor, ml: torch.Tensor, dtype) -> torch.Tensor:
    """R ranks' gathered partials ``acc`` (R, B, KV, G, S, hd) / ``ml`` (R,
    B, KV, G, S, 2) (S = 1 from :func:`decode_attention_partials`), merged
    over their R x S entries in rank order; returns ``(B, 1, KV, G, hd)``
    in ``dtype``."""
    if runtime.use_kernel(acc):
        out = cuda_kernel.merge_decode_partials(acc, ml, dtype)
    else:
        out = merge_partials_ref(acc, ml, dtype)
    return out[:, None]


def paged_decode_attention(
    q: torch.Tensor,                     # (B, 1, KV, G, hd) grouped query
    pool: Dict[str, Any],                # k/v (N, bs, KV, hd) [+ k/v_scale]
    block_table: torch.Tensor,           # (B, J_max) int32 physical blocks
    n_valid: torch.Tensor,               # (B,) live-row count per request
    *,
    seq_len: int,                        # this layer's rotating cache length
    block_size: int,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Length-masked decode attention over a shared block pool; returns
    ``(B, 1, KV, G, hd)`` in q's dtype.  The table is sliced to this
    layer's ``ceil(seq_len / block_size)`` walkable blocks, so windowed
    layers never index past their own rotation; ``n_valid <= seq_len``
    keeps a short last block's tail out of every softmax."""
    b, s, kvh, g, hd = q.shape
    assert s == 1, f"decode attention is the s == 1 path, got S={s}"
    k, v = pool["k"], pool["v"]
    k_scale, v_scale = pool.get("k_scale"), pool.get("v_scale")
    assert k.shape[1] == block_size, (k.shape, block_size)
    j_l = -(-seq_len // block_size)
    assert block_table.shape[1] >= j_l, (block_table.shape, j_l)
    bt = block_table[:, :j_l].to(device=q.device, dtype=torch.int32).contiguous()
    n = n_valid.to(device=q.device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    qh = q[:, 0]                                             # (B, KV, G, hd)
    if runtime.use_kernel(q):
        out = cuda_kernel.paged_flash_decode(qh, k, v, k_scale, v_scale, bt, n, softcap=softcap)
    else:
        out = paged_flash_decode_ref(qh, k, v, k_scale, v_scale, bt, n, block_size=block_size, softcap=softcap)
    return out[:, None]
