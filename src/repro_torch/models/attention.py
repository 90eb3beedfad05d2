"""Grouped-query attention with RoPE, sliding windows and rotating KV
caches — the port's twin of ``repro/models/attention.py``.

Decode (one new token against the cache) runs, by ``cfg.attn_impl``:

* ``flash_decode`` / ``blockwise`` — ``kernels.decode_attention``: the
  length-masked online softmax over the valid rows only, int8 KV
  dequantized inline (the hand CUDA kernel on the card);
* ``naive`` — the oracle: the valid prefix dequantized to the model dtype
  and a full softmax.

Prefill and training run naive causal attention up to ``cfg.attn_block_q``
tokens.  Past it (``blockwise`` / ``flash_decode``) they run the online
softmax over KV blocks: ``_blockwise_attn``, the reference's recurrence op
for op, under autograd, on a CPU tensor, and the hand CUDA flash-attention
kernels (``kernels.flash_attention``: the forward, and for a training
step's gradient the backward, through ``FlashAttentionFunction``) on the
card.  Windowed layers keep a rotating cache of ``window`` slots; RoPE is
applied at write time, and writes land at ``index % C``, so the live slots
are always the prefix ``[0, min(index+1, C))``.

``cache_index`` is an int (every row at the same length), a ``(B,)`` int32
tensor of per-row lengths (the continuous engine's slot pool: each row
writes at its own ``length % C`` and attends over its own prefix), or a
``PagedIndex`` (the shared block pool: rows are reached through block
tables and decode always runs the paged flash decode).

Caches are dicts of tensors updated **in place** (the reference returns
new arrays); ``Attention.forward`` returns only the layer's output.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.kernels import runtime
from repro_torch.kernels.decode_attention import decode_attention, paged_decode_attention
from repro_torch.kernels.flash_attention import grouped_flash_attention
from repro_torch.models import rope as rope_lib
from repro_torch.models.common import acc_dtype, dense_std, frozen, trunc_normal_

NEG_INF = -1.0e30
Cache = Dict[str, torch.Tensor]


class PagedPlan(NamedTuple):
    """One decode step's pool coordinates for the layers of one rotating
    length: where each row writes, what it attends over, and its table."""

    write_block: torch.Tensor    # (B,) int64 -- physical block of the new row (0 for dead slots)
    write_row: torch.Tensor      # (B,) int64 -- row inside that block
    n_valid: torch.Tensor        # (B,) int32 -- min(lengths + 1, cache_len)
    block_table: torch.Tensor    # (B, ceil(cache_len / block_size)) int32, contiguous


@dataclasses.dataclass(frozen=True, eq=False)
class PagedIndex:
    """Paged-decode coordinates, passed as ``cache_index`` when the decode
    state is a block pool (twin of ``repro.models.attention.PagedIndex``).
    Each layer derives its own rotating length from ``max_seq``; ``live``
    routes dead slots' decode writes to the reserved trash block 0, since a
    retired slot's blocks may already belong to a new request.  One index
    serves one decode step: ``plan`` computes the step's coordinates once
    per rotating length and every layer of that length shares them."""

    lengths: torch.Tensor        # (B,) int32 -- tokens already cached per slot
    block_table: torch.Tensor    # (B, J) int32 -- physical block ids (0 = trash)
    live: torch.Tensor           # (B,) bool -- slot currently owns its blocks
    max_seq: int
    block_size: int
    _plans: Dict[int, PagedPlan] = dataclasses.field(default_factory=dict, repr=False)

    def plan(self, c_len: int) -> PagedPlan:
        """Logical row ``lengths % c_len`` (the contiguous rotation) maps to
        table entry ``row // block_size``, offset ``row % block_size``."""
        if c_len not in self._plans:
            bs = self.block_size
            row = self.lengths.to(torch.int64) % c_len
            ent = torch.gather(self.block_table.to(torch.int64), 1, (row // bs)[:, None])[:, 0]
            self._plans[c_len] = PagedPlan(
                write_block=torch.where(self.live, ent, 0), write_row=row % bs,
                n_valid=_n_valid(self.lengths, c_len),
                block_table=self.block_table[:, :-(-c_len // bs)].to(torch.int32).contiguous())
        return self._plans[c_len]


Index = Union[int, torch.Tensor, PagedIndex]


def _sqrt_f32(hd: int) -> float:
    """``sqrt(float32(hd))``, the f32 value the reference divides scores by."""
    return float(torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))


def _grouped(q: torch.Tensor, num_kv: int) -> torch.Tensor:
    """(B, S, H, hd) -> (B, S, KV, G, hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, num_kv, h // num_kv, hd)


def _naive_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor,
                softcap: float) -> torch.Tensor:
    """q (B, Sq, KV, G, hd), k/v (B, Skv, KV, hd), mask broadcastable to
    (B, KV, G, Sq, Skv): materialized f32 scores, softmax, probs in q's dtype."""
    scores = torch.einsum("bqkgh,bskh->bkgqs", q, k).to(acc_dtype(q))
    scores = scores / _sqrt_f32(q.shape[-1])
    if softcap > 0.0:
        scores = torch.tanh(scores / softcap) * softcap
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskh->bqkgh", probs, v)


def _blockwise_attn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, causal: bool, window: int,
                    q_offset: int, block_q: int, block_kv: int, softcap: float) -> torch.Tensor:
    """FlashAttention-style online softmax in plain PyTorch (twin of the
    reference's ``_blockwise_attn``): q (B, Sq, KV, G, hd) and k/v (B, Skv,
    KV, hd) are padded here to block multiples; every KV block is walked,
    masked by causality, the window and ``k_pos < Skv``; the probabilities
    are cast to q's dtype before the PV product, as the reference casts
    them."""
    b, sq, kvh, g, hd = q.shape
    skv = k.shape[1]
    bq, bkv = min(block_q, sq), min(block_kv, skv)
    pad_q, pad_kv = (-sq) % bq, (-skv) % bkv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nq, nkv = q.shape[1] // bq, k.shape[1] // bkv
    scale = float(1.0 / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32)))
    dev = q.device
    outs = []
    for qi in range(nq):
        qblk = q[:, qi * bq:(qi + 1) * bq]
        q_pos = q_offset + qi * bq + torch.arange(bq, device=dev)
        acc = torch.zeros((b, kvh, g, bq, hd), dtype=torch.float32, device=dev)
        m = torch.full((b, kvh, g, bq), NEG_INF, dtype=torch.float32, device=dev)
        l = torch.zeros((b, kvh, g, bq), dtype=torch.float32, device=dev)
        for kj in range(nkv):
            kblk, vblk = k[:, kj * bkv:(kj + 1) * bkv], v[:, kj * bkv:(kj + 1) * bkv]
            k_pos = kj * bkv + torch.arange(bkv, device=dev)
            s = torch.einsum("bqkgh,bskh->bkgqs", qblk, kblk).float() * scale
            if softcap > 0.0:
                s = torch.tanh(s / softcap) * softcap
            msk = torch.ones((bq, bkv), dtype=torch.bool, device=dev)
            if causal:
                msk &= k_pos[None, :] <= q_pos[:, None]
            if window > 0:
                msk &= q_pos[:, None] - k_pos[None, :] < window
            msk &= k_pos[None, :] < skv
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.where(msk, torch.exp(s - m_new[..., None]), 0.0)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bkgqs,bskh->bkgqh", p.to(qblk.dtype), vblk).float()
            m = m_new
        out = acc / torch.clamp(l[..., None], min=1e-20)
        outs.append(torch.einsum("bkgqh->bqkgh", out).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq]


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_len(spec: LayerSpec, max_seq: int) -> int:
    return min(max_seq, spec.window) if spec.window > 0 else max_seq


def init_kv_cache(batch: int, length: int, num_kv: int, head_dim: int, dtype,
                  kv_cache_dtype: str = "", *, device) -> Cache:
    """A model-dtype cache, or int8 codes + per-(pos, head) bf16 scales."""
    shape = (batch, length, num_kv, head_dim)
    if kv_cache_dtype == "int8":
        return {
            "k": torch.zeros(shape, dtype=torch.int8, device=device),
            "v": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale": torch.zeros(shape[:3], dtype=torch.bfloat16, device=device),
            "v_scale": torch.zeros(shape[:3], dtype=torch.bfloat16, device=device),
        }
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., hd) -> int8 codes + bf16 absmax scale (clamped at 1e-8), codes
    rounded half to even."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    codes = torch.round(x32 / scale[..., None])
    return codes.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize_kv(codes: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (codes.float() * scale.float()[..., None]).to(dtype)


def _is_quantized(cache: Cache) -> bool:
    return "k_scale" in cache


def _read_cache(cache: Cache, dtype):
    if _is_quantized(cache):
        return (_dequantize_kv(cache["k"], cache["k_scale"], dtype),
                _dequantize_kv(cache["v"], cache["v_scale"], dtype))
    return cache["k"], cache["v"]


def _parts(cache: Cache, k: torch.Tensor, v: torch.Tensor) -> Cache:
    if _is_quantized(cache):
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def _write_decode(cache: Cache, k: torch.Tensor, v: torch.Tensor, index) -> Cache:
    """Write one position (S == 1) at rotating slot ``index % C``, in place;
    a ``(B,)`` tensor index writes each row at its own slot."""
    c = cache["k"].shape[1]
    if not torch.is_tensor(index):
        slot = int(index) % c
        for name, val in _parts(cache, k, v).items():
            cache[name][:, slot:slot + 1] = val
        return cache
    rows = torch.arange(k.shape[0], device=k.device)
    slots = index.to(device=k.device, dtype=torch.int64) % c
    for name, val in _parts(cache, k[:, 0], v[:, 0]).items():
        cache[name][rows, slots] = val
    return cache


def _write_decode_paged(cache: Cache, k: torch.Tensor, v: torch.Tensor, plan: PagedPlan) -> Cache:
    """Paged twin of :func:`_write_decode`, in place, at the rows ``plan``
    maps the step's rotating writes to; dead slots write trash block 0."""
    for name, val in _parts(cache, k[:, 0], v[:, 0]).items():
        cache[name][plan.write_block, plan.write_row] = val
    return cache


def _n_valid(cache_index, c: int):
    """Rows each request attends over: ``min(index + 1, C)``, an int for an
    int index and ``(B,)`` int32 for per-row lengths."""
    if not torch.is_tensor(cache_index):
        return min(int(cache_index) + 1, c)
    return torch.clamp(cache_index.to(torch.int32) + 1, max=c)


def _write_prefill(cache: Cache, k: torch.Tensor, v: torch.Tensor) -> Cache:
    """Write positions 0..S-1 as rotating decode writes would (position p in
    slot p % C, keeping the last C), in place."""
    c = cache["k"].shape[1]
    s = k.shape[1]
    for name, val in _parts(cache, k, v).items():
        if s <= c:
            cache[name][:, :s] = val
        else:
            slots = (torch.arange(c, device=val.device) + (s - c)) % c
            cache[name][:, slots] = val[:, s - c:]
    return cache


def _masked_decode_attn(qg: torch.Tensor, cache: Cache, cache_index, softcap: float,
                        dtype) -> torch.Tensor:
    """The naive decode oracle.  An int index slices the valid prefix
    ``[0, min(index+1, C))`` out, dequantizes it to the model dtype and
    attends in full; per-row lengths keep the whole cache and mask each
    row's dead slots before the softmax (the reference's traced form)."""
    c = cache["k"].shape[1]
    n_valid = _n_valid(cache_index, c)
    if isinstance(n_valid, int):
        cache = {name: buf[:, :n_valid] for name, buf in cache.items()}
        mask = torch.ones((1, 1, 1, 1, n_valid), dtype=torch.bool, device=qg.device)
    else:
        valid = torch.arange(c, device=qg.device)[None, :] < n_valid.to(qg.device)[:, None]
        mask = valid[:, None, None, None, :]                     # (B, 1, 1, 1, C)
    k_read, v_read = _read_cache(cache, dtype)
    return _naive_attn(qg, k_read, v_read, mask, softcap)


# ---------------------------------------------------------------------------
# Layer
# ---------------------------------------------------------------------------

class Attention(nn.Module):
    """q/k/v/out projections in the reference's ``x @ w`` layout:
    ``wq`` (d, H*hd), ``wk``/``wv`` (d, KV*hd), ``w_out`` (H*hd, d)."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, dtype, device):
        super().__init__()
        d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        self.spec = spec
        self.wq = frozen((d, h * hd), dtype, device)
        self.wk = frozen((d, kv * hd), dtype, device)
        self.wv = frozen((d, kv * hd), dtype, device)
        self.w_out = frozen((h * hd, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = frozen((h * hd,), dtype, device)
            self.bk = frozen((kv * hd,), dtype, device)
            self.bv = frozen((kv * hd,), dtype, device)
        else:
            self.bq = self.bk = self.bv = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.wq, self.wk, self.wv, self.w_out):
            trunc_normal_(w, dense_std(w.shape), gen)
        for bias in (self.bq, self.bk, self.bv):
            if bias is not None:
                nn.init.zeros_(bias)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                cache: Optional[Cache] = None, cache_index: Optional[Index] = None) -> torch.Tensor:
        b, s, _ = x.shape
        h, kvh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
        q, k, v = x @ self.wq, x @ self.wk, x @ self.wv
        if self.bq is not None:
            q, k, v = q + self.bq, k + self.bk, v + self.bv
        q = rope_lib.apply_rope(q.reshape(b, s, h, hd), positions, cfg.rope_theta, cfg.mrope_sections)
        k = rope_lib.apply_rope(k.reshape(b, s, kvh, hd), positions, cfg.rope_theta, cfg.mrope_sections)
        v = v.reshape(b, s, kvh, hd)
        qg = _grouped(q, kvh)

        if cache is not None and s == 1 and isinstance(cache_index, PagedIndex):
            # The block pool has no contiguous layout for the naive oracle:
            # paged decode always runs the paged flash decode.
            c = cache_len(self.spec, cache_index.max_seq)
            plan = cache_index.plan(c)
            _write_decode_paged(cache, k, v, plan)
            out = paged_decode_attention(qg, cache, plan.block_table, plan.n_valid,
                                         seq_len=c, block_size=cache_index.block_size,
                                         softcap=cfg.logit_softcap)
        elif cache is not None and s == 1:
            _write_decode(cache, k, v, cache_index)
            if cfg.attn_impl in ("flash_decode", "blockwise"):
                n_valid = _n_valid(cache_index, cache["k"].shape[1])
                out = decode_attention(qg, cache, n_valid, softcap=cfg.logit_softcap,
                                       block_kv=cfg.attn_decode_block_kv)
            else:
                out = _masked_decode_attn(qg, cache, cache_index, cfg.logit_softcap, k.dtype)
        else:
            if cfg.attn_impl in ("blockwise", "flash_decode") and s > cfg.attn_block_q:
                kw = dict(causal=True, window=self.spec.window, q_offset=0, softcap=cfg.logit_softcap)
                if runtime.use_kernel(qg):
                    out = grouped_flash_attention(qg, k, v, **kw)
                else:
                    out = _blockwise_attn(qg, k, v, block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv, **kw)
            else:
                pos = torch.arange(s, device=x.device)
                msk = pos[:, None] >= pos[None, :]
                if self.spec.window > 0:
                    msk &= pos[:, None] - pos[None, :] < self.spec.window
                out = _naive_attn(qg, k, v, msk[None, None, None], cfg.logit_softcap)
            if cache is not None:
                _write_prefill(cache, k, v)
        return out.reshape(b, s, h * hd) @ self.w_out

