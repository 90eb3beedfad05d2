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
against on the card.  They compute in f32 (f64 for f64 inputs, so that
``torch.autograd.gradcheck`` can run through them).

``flash_attention_bwd_ref`` is the plain backward on the dispatch's layout,
the version ``csrc/flash_attention_bwd.cu`` is held against: it recomputes
P as the forward does and forms dV = P^T dO, dP = dO V^T,
dS = P * (dP - rowsum(dO * O)) (times tanh's derivative under a softcap,
and only where the mask lets a score through), dQ = dS K / sqrt(hd) and
dK = dS^T Q / sqrt(hd), with dK and dV summed over the G query heads of
each KV head.  Given the forward's row statistics (``stats``: each row's
max m in log2 units and sum l, as the wgmma forward writes them and the
wgmma backward reads them), it forms p = exp2(s log2(e) - m) / l from them
instead of a softmax; the two agree to f32 rounding.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e30
LOG2E = 1.4426950408889634


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
    acc = _acc_dtype(q)
    s = torch.einsum("bqh,bkh->bqk", q.to(acc), k.to(acc))
    s = s / torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=q.device))
    if softcap > 0.0:
        s = torch.tanh(s / softcap) * softcap
    s = torch.where(_mask(sq, skv, causal, window, q_offset, q.device)[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkh->bqh", p, v.to(acc)).to(q.dtype)


def _acc_dtype(q: torch.Tensor) -> torch.dtype:
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def _mask(sq: int, skv: int, causal: bool, window: int, q_offset: int, device) -> torch.Tensor:
    """(Sq, Skv) bool: the keys each query sees."""
    q_pos = q_offset + torch.arange(sq, device=device)
    k_pos = torch.arange(skv, device=device)
    msk = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        msk &= k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        msk &= q_pos[:, None] - k_pos[None, :] < window
    return msk


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


def flash_attention_bwd_ref(
    q: torch.Tensor,     # (B, Sq, H, hd)
    k: torch.Tensor,     # (B, Skv, KV, hd), H % KV == 0
    v: torch.Tensor,
    out: torch.Tensor,   # (B, Sq, H, hd): the forward's output
    dout: torch.Tensor,  # (B, Sq, H, hd): its gradient
    *,
    stats: torch.Tensor | None = None,   # (2, B * H * Sq): the forward's m (log2 units) and l
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softcap: float = 0.0,
):
    """(dQ, dK, dV) of ``gqa_flash_attention_ref``, each in its input's
    dtype, computed in f32 (f64 for f64 inputs), P from ``stats`` where
    given."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    acc = _acc_dtype(q)
    grouped = lambda x: x.to(acc).reshape(b, sq, kvh, g, hd)
    qf, of, dof = grouped(q), grouped(out), grouped(dout)
    kf, vf = k.to(acc), v.to(acc)
    sqrt_hd = torch.sqrt(torch.tensor(float(hd), dtype=torch.float32, device=q.device))
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) / sqrt_hd
    if softcap > 0.0:
        t = torch.tanh(s / softcap)
        s = t * softcap
    msk = _mask(sq, skv, causal, window, q_offset, q.device)
    if stats is None:
        p = torch.softmax(torch.where(msk, s, NEG_INF), dim=-1)                  # (B, KV, G, Sq, Skv)
    else:
        m, l = (x[..., None] for x in stats.to(acc).reshape(2, b, kvh, g, sq))
        p = torch.where(msk, torch.exp2(s * LOG2E - torch.where(msk, m, 0.0)) / l, 0.0)
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    rowsum = torch.einsum("bqkgh,bqkgh->bkgq", dof, of)
    ds = torch.where(msk, p * (dp - rowsum[..., None]), 0.0)
    if softcap > 0.0:
        ds = ds * (1.0 - t * t)
    ds = ds / sqrt_hd
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf).reshape(b, sq, h, hd)
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)
