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
"""

from __future__ import annotations

import math
from typing import Any, Dict, Union

import torch
import torch.nn.functional as F

from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention import cuda_kernel
from repro_torch.kernels.decode_attention.torch_ref import flash_decode_ref, paged_flash_decode_ref


def decode_block_kv(cache_len: int, block_kv: int) -> int:
    """Effective KV block of the masked walk (``ops.py:54-67``): the largest
    common divisor of the cache length and ``block_kv`` when it is at least
    ``min(16, block)``, else ``block_kv`` itself (the cache is then padded)."""
    bkv = min(block_kv, cache_len)
    g = math.gcd(bkv, cache_len)
    return g if g >= min(16, bkv) else bkv


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
    if isinstance(n_valid, int):
        n = torch.full((b,), n_valid, dtype=torch.int32, device=q.device)
    else:
        n = n_valid.to(device=q.device, dtype=torch.int32).reshape(-1).expand(b).contiguous()
    qh = q[:, 0]                                             # (B, KV, G, hd)
    if runtime.use_kernel(q):
        out = cuda_kernel.flash_decode(qh, k, v, k_scale, v_scale, n, softcap=softcap)
        return out[:, None]
    c = k.shape[1]
    bkv = decode_block_kv(c, block_kv)
    pad = (-c) % bkv
    if pad:
        # Padded rows sit at k_pos >= C >= n_valid, so the mask never reads them.
        grow = lambda a: F.pad(a, (0, 0) * (a.dim() - 2) + (0, pad))
        k, v = grow(k), grow(v)
        if k_scale is not None:
            k_scale, v_scale = grow(k_scale), grow(v_scale)
    out = flash_decode_ref(qh, k, v, k_scale, v_scale, n[:, None], block_kv=bkv, softcap=softcap)
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
