"""Plain PyTorch attention over whole sequences: the port's twin of
``repro/kernels/flash_attention/ref.py``, op for op.

Layout ``(BH, Sq, hd)`` / ``(BH, Skv, hd)``: f32 scores divided by
``sqrt(hd)``, optional ``tanh(s / cap) * cap``, the causal / window mask as
``where(mask, s, -1e30)``, a full softmax, the f32 PV product, then a cast
to q's dtype.  ``gqa_flash_attention_ref`` is the same function on the
dispatch's ``(B, S, H, hd)`` / ``(B, S, KV, hd)`` layout, with the
reference's GQA expansion (``repeat_interleave``, as ``ops.py``'s
``jnp.repeat``) and ``(B, H)`` fold.  They are the CPU path of ``dispatch``
and the plain version the CUDA kernel (``csrc/flash_attention.cu``) is held
against on the card.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30


def flash_attention_ref(
    q: torch.Tensor,     # (BH, Sq, hd)
    k: torch.Tensor,     # (BH, Skv, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    sq, skv = q.shape[1], k.shape[1]
    hd = q.shape[-1]
    s = torch.einsum("bqh,bkh->bqk", q.float(), k.float())
    s = s / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=q.device))
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    q_pos = q_offset + torch.arange(sq, device=q.device)
    k_pos = torch.arange(skv, device=q.device)
    msk = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        msk &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        msk &= q_pos[:, None] - k_pos[None, :] < window
    s = torch.where(msk[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.float()).to(q.dtype)


def gqa_flash_attention_ref(
    q: torch.Tensor,     # (B, Sq, H, hd)
    k: torch.Tensor,     # (B, Skv, KV, hd), H % KV == 0
    v: torch.Tensor,
    **kw,
) -> torch.Tensor:
    """``flash_attention_ref`` on the (B, S, H, hd) layout, KV head ``kv``
    repeated to query heads ``kv * G .. kv * G + G - 1``; returns
    (B, Sq, H, hd) in q's dtype."""
    b, sq, h, hd = q.shape
    g = h // k.shape[2]
    if g > 1:
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
    fold = lambda x: x.transpose(1, 2).reshape(b * h, -1, hd)
    return flash_attention_ref(fold(q), fold(k), fold(v), **kw).reshape(b, h, sq, hd).transpose(1, 2)
