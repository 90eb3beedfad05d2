"""Decode state (twin of ``repro/models/cache.py``): the contiguous KV
cache, the continuous engine's slot pool and its paged block pool, and the
byte accounting of each.

The port keeps one dict per layer in stack order (``k``/``v`` plus
``k_scale``/``v_scale`` for int8), where the reference keeps a
prologue/units pytree.  Windowed layers allocate ``min(max_seq, window)``
rotating slots.  Every pool here is updated **in place** (the reference
returns new arrays): ``write_slot`` and ``write_prompt_blocks`` copy into
the pool's own tensors.
"""

from __future__ import annotations

import math
from typing import List

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.decode_attention import decode_block_kv
from repro_torch.models import attention
from repro_torch.models.common import dtype_of


def _attn_lengths(cfg: ModelConfig, max_seq: int) -> List[int]:
    """Each layer's rotating cache length; raises for layers without a KV
    cache, which the port does not build yet."""
    lengths = []
    for spec in cfg.all_layers():
        if spec.kind != "attn":
            raise NotImplementedError(f"{spec.kind!r} decode state is not ported yet (ROADMAP A12)")
        lengths.append(attention.cache_len(spec, max_seq))
    return lengths


def _kv_caches(cfg: ModelConfig, batch: int, lengths: List[int], device) -> List[attention.Cache]:
    return [attention.init_kv_cache(batch, length, cfg.num_kv_heads, cfg.resolved_head_dim,
                                    dtype_of(cfg.dtype), kv_cache_dtype=cfg.kv_cache_dtype, device=device)
            for length in lengths]


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, device="cuda") -> List[attention.Cache]:
    """Zeroed per-layer caches; layers write into them in place."""
    return _kv_caches(cfg, batch, _attn_lengths(cfg, max_seq), device)


# ---------------------------------------------------------------------------
# Slot pools (continuous-batching serve engine)
# ---------------------------------------------------------------------------

def init_slot_pool(cfg: ModelConfig, n_slots: int, max_seq: int, device="cuda") -> List[attention.Cache]:
    """``n_slots`` independent batch-1 decode states.  The reference stacks
    them on a new leading axis; here the slot axis is the cache's batch
    axis, so one batched forward steps every slot (the port's form of the
    reference's ``vmap``)."""
    return init_cache(cfg, n_slots, max_seq, device)


def _check_dtype(fn: str, pool_leaf: torch.Tensor, cache_leaf: torch.Tensor) -> None:
    if cache_leaf.dtype != pool_leaf.dtype:
        raise ValueError(
            f"{fn}: cache leaf dtype {cache_leaf.dtype} does not match pool leaf dtype "
            f"{pool_leaf.dtype}; a silent cast would corrupt quantized caches (bf16 values written "
            "as int8 codes); build the slot cache from the same config as the pool")


def write_slot(pool: List[attention.Cache], slot_cache: List[attention.Cache], slot: int) -> List[attention.Cache]:
    """Overwrite every leaf of slot ``slot`` with a batch-1 cache of the
    same ``max_seq``, in place: the full-slot reset of an admission, which
    makes a retired slot's dirty decode writes harmless."""
    for p_layer, c_layer in zip(pool, slot_cache):
        for name, buf in p_layer.items():
            _check_dtype("write_slot", buf, c_layer[name])
            buf[slot] = c_layer[name][0]
    return pool


def read_slot(pool: List[attention.Cache], slot: int) -> List[attention.Cache]:
    """One slot's batch-1 cache, as views into the pool."""
    return [{name: buf[slot:slot + 1] for name, buf in layer.items()} for layer in pool]


# ---------------------------------------------------------------------------
# Block pools (paged KV storage)
# ---------------------------------------------------------------------------
#
# ``num_blocks`` physical blocks of ``block_size`` KV rows, shared by every
# slot and every layer: per layer ``(num_blocks, block_size, KV, hd)`` codes
# (+ ``(num_blocks, block_size, KV)`` scales for int8).  A slot's block-table
# row addresses all layers at once.  Block 0 is the trash block: the host
# allocator never hands it out, and dead slots' decode writes land there.


def blocks_for(rows: int, block_size: int) -> int:
    """Blocks needed to hold ``rows`` KV rows (ceil division)."""
    return -(-rows // block_size)


def init_block_pool(cfg: ModelConfig, num_blocks: int, block_size: int, device="cuda") -> List[attention.Cache]:
    """Zeroed block pool of an attention-only stack.  Windowed layers stop
    using rows past their own ``cache_len``: the rotating write wraps at
    the layer's length and the ``k_pos < n_valid`` mask hides the rest."""
    for spec in cfg.all_layers():
        if spec.kind != "attn":
            raise ValueError(
                f"init_block_pool: paged pools support attention-only stacks; layer kind {spec.kind!r} "
                "carries O(1) recurrent state per slot and has nothing to page")
    if num_blocks < 2:
        raise ValueError(f"init_block_pool: num_blocks={num_blocks} < 2; block 0 is the reserved trash block, "
                         "so a usable pool needs at least one more")
    return _kv_caches(cfg, num_blocks, [block_size] * len(cfg.all_layers()), device)


def write_prompt_blocks(pool: List[attention.Cache], slot_cache: List[attention.Cache], bt_row: torch.Tensor,
                        n_prompt_blocks: int, block_size: int) -> List[attention.Cache]:
    """Admission copy into the block pool, in place: the first
    ``n_prompt_blocks`` blocks (``ceil(bucket / block_size)``) of each
    layer's freshly prefilled batch-1 cache go to the pool blocks
    ``bt_row[:nb]``.  Padded prompt rows ride along, invisible behind the
    causal mask and ``n_valid``; blocks a short (windowed) layer or the
    reservation lacks land in trash block 0 through the row's zero padding."""
    ids = bt_row.to(torch.int64)
    for p_layer, c_layer in zip(pool, slot_cache):
        for name, buf in p_layer.items():
            leaf = c_layer[name]
            _check_dtype("write_prompt_blocks", buf, leaf)
            rows = leaf.shape[1]
            nb = min(n_prompt_blocks, blocks_for(rows, block_size))
            flat = leaf[0, :nb * block_size]
            if flat.shape[0] < nb * block_size:
                pad = nb * block_size - flat.shape[0]
                flat = F.pad(flat, (0, 0) * (flat.dim() - 1) + (0, pad))
            buf[ids[:nb]] = flat.reshape((nb, block_size) + tuple(flat.shape[1:]))
    return pool


# ---------------------------------------------------------------------------
# Byte accounting (analytic, no allocation; equal to the reference's ints)
# ---------------------------------------------------------------------------

def _attn_row_bytes(cfg: ModelConfig) -> int:
    """Bytes per KV row of one attention layer: k + v codes, plus bf16
    scales when the cache is int8."""
    quantized = cfg.kv_cache_dtype == "int8"
    itemsize = 1 if quantized else dtype_of(cfg.dtype).itemsize
    row_bytes = 2 * cfg.num_kv_heads * cfg.resolved_head_dim * itemsize
    return row_bytes + (2 * cfg.num_kv_heads * 2 if quantized else 0)


def decode_read_bytes(cfg: ModelConfig, max_seq: int, valid: int, masked: bool = True, paged: bool = False,
                      block_size: int = 16) -> int:
    """Attention-cache bytes one decode step reads for one request:
    ``masked=False`` the full cache, ``masked=True`` the
    ``ceil(valid / block)`` blocks of the length-masked walk, ``paged=True``
    the ``ceil(valid / block_size)`` pool blocks plus the int32 table row
    and ``n_valid`` (the reference's accounting)."""
    row_bytes = _attn_row_bytes(cfg)
    total = 0
    for length in _attn_lengths(cfg, max_seq):
        if paged:
            j_l = blocks_for(length, block_size)
            nblk = min(math.ceil(min(valid, length) / block_size), j_l)
            total += nblk * block_size * row_bytes + 4 * j_l + 4
            continue
        if masked:
            bkv = decode_block_kv(length, cfg.attn_decode_block_kv)
            rows = min(math.ceil(min(valid, length) / bkv) * bkv, length)
        else:
            rows = length
        total += rows * row_bytes
    return total


def decode_read_bytes_jnp(cfg: ModelConfig, max_seq: int, valid, masked: bool = True, paged: bool = False,
                          block_size: int = 16) -> torch.Tensor:
    """Twin of the reference's traced ``decode_read_bytes_jnp``:
    :func:`decode_read_bytes` on a tensor of valid lengths (the slot
    pool's per-slot lengths), in f32 on their device with the reference's
    operations in its order, so the engines add the read-bytes counter on
    the card each step.  The per-layer lengths and block sizes are host
    numbers; only the ceil-to-block arithmetic runs on the device.  The
    reference's analytic count, not the bytes the split-KV kernel reads."""
    row_bytes = _attn_row_bytes(cfg)
    valid = torch.as_tensor(valid).to(torch.float32)

    def layer_bytes(length):
        if paged:
            j_l = blocks_for(length, block_size)
            v = torch.clamp(valid, max=float(length))
            nblk = torch.clamp(torch.ceil(v / block_size), max=float(j_l))
            return nblk * float(block_size * row_bytes) + float(4 * j_l + 4)
        if masked:
            bkv = decode_block_kv(length, cfg.attn_decode_block_kv)
            v = torch.clamp(valid, max=float(length))
            rows = torch.clamp(torch.ceil(v / bkv) * bkv, max=float(length))
        else:
            rows = torch.full_like(valid, float(length))
        return rows * float(row_bytes)

    # A layer's term depends only on its cache length: formed once a length,
    # added a layer at a time in the reference's order.
    terms: dict = {}
    total = torch.zeros_like(valid)
    for length in _attn_lengths(cfg, max_seq):
        if length not in terms:
            terms[length] = layer_bytes(length)
        total = total + terms[length]
    return total


def admission_write_bytes(cfg: ModelConfig, max_seq: int, bucket: int, paged: bool = False,
                          block_size: int = 16) -> int:
    """Cache bytes one admission writes: the whole ``max_seq`` slot
    (contiguous), or ``ceil(bucket / block_size)`` blocks per layer, capped
    at the layer's own block count (paged)."""
    if not paged:
        return cache_bytes(cfg, 1, max_seq)
    row_bytes = _attn_row_bytes(cfg)
    return sum(min(blocks_for(bucket, block_size), blocks_for(length, block_size)) * block_size * row_bytes
               for length in _attn_lengths(cfg, max_seq))


def block_pool_bytes(cfg: ModelConfig, num_blocks: int, block_size: int) -> int:
    """Footprint of a block pool in bytes."""
    return len(cfg.all_layers()) * num_blocks * block_size * _attn_row_bytes(cfg)


def cache_bytes(cfg: ModelConfig, batch: int, max_seq: int) -> int:
    """Footprint of ``batch`` contiguous caches of ``max_seq`` in bytes."""
    return batch * sum(_attn_lengths(cfg, max_seq)) * _attn_row_bytes(cfg)
