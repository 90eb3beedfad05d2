"""Plain PyTorch flash decode: the port's twin of
``repro/kernels/decode_attention/ref.py::flash_decode_ref``.

It mirrors the reference op for op: f32 dequantization of each KV block,
scores ``q . k * 1/sqrt(hd)``, optional ``tanh(s / cap) * cap``, the
``k_pos < n_valid`` mask applied as ``where(mask, s, -1e30)`` before the
max, ``exp`` then ``where(mask, p, 0)``, the online-softmax update, and
``acc / max(l, 1e-20)`` cast to q's dtype.  The reference vmaps a
``fori_loop`` over ``ceil(n_valid / block_kv)`` blocks per (request, head);
here the block loop runs to the largest row's bound for all rows at once,
and a row whose own bound has passed keeps its carry (what the vmapped
loop does).  It is the CPU path of ``dispatch.decode_attention`` and the
plain version the CUDA kernel is held against on the card.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1.0e30


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
    b, kvh, g, hd = q.shape
    c = k.shape[1]
    assert c % block_kv == 0, (c, block_kv)
    quantized = k_scale is not None
    qf = q.float()
    scale = float(torch.tensor(1.0) / torch.sqrt(torch.tensor(float(hd))))
    nv = n_valid.reshape(b).to(torch.int64)
    n_blocks = (nv + block_kv - 1) // block_kv                       # (B,)
    acc = torch.zeros((b, kvh, g, hd), dtype=torch.float32, device=q.device)
    m = torch.full((b, kvh, g), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, kvh, g), dtype=torch.float32, device=q.device)
    steps = int(n_blocks.max()) if b else 0
    iota = torch.arange(block_kv, device=q.device)
    for kj in range(steps):
        start = kj * block_kv
        kb = k[:, start:start + block_kv].float()                   # (B, bkv, KV, hd)
        vb = v[:, start:start + block_kv].float()
        if quantized:
            kb = kb * k_scale[:, start:start + block_kv].float()[..., None]
            vb = vb * v_scale[:, start:start + block_kv].float()[..., None]
        s = torch.einsum("bkgh,bskh->bkgs", qf, kb) * scale          # (B, KV, G, bkv)
        if softcap > 0.0:
            s = torch.tanh(s / softcap) * softcap
        msk = ((start + iota)[None, :] < nv[:, None])[:, None, None, :]
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

