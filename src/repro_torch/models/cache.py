"""Decode state (twin of ``repro/models/cache.py:22-53``): the contiguous
KV cache, one dict per layer in stack order.  Windowed layers allocate
``min(max_seq, window)`` rotating slots.  The slot and block pools of the
continuous engine wait for ROADMAP A5/A6."""

from __future__ import annotations

from typing import List

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention
from repro_torch.models.common import dtype_of


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> List[attention.Cache]:
    """Zeroed per-layer caches; layers write into them in place."""
    caches = []
    for spec in cfg.all_layers():
        if spec.kind != "attn":
            raise NotImplementedError(f"{spec.kind!r} decode state is not ported yet (ROADMAP A12)")
        caches.append(attention.init_kv_cache(
            batch, attention.cache_len(spec, max_seq), cfg.num_kv_heads, cfg.resolved_head_dim,
            dtype_of(cfg.dtype), kv_cache_dtype=cfg.kv_cache_dtype, device=device,
        ))
    return caches
