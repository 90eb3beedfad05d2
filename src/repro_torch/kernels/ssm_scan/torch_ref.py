"""Plain PyTorch linear-recurrence scan and its gradient: the port's twin of
``repro/kernels/ssm_scan/ref.py``, and the plain reverse scan of its
backward.

All prefix states of ``h[t] = a[t] * h[t-1] + b[t]`` from ``h0``, in f32.
XLA contracts the reference's ``a * h + b`` into one fused multiply-add,
rounded once; PyTorch has no such op, and a multiply then an add rounds
twice (up to ~5e-7 apart over a few hundred steps).  Each step here is
formed in f64, where the product of two f32 values is exact, and rounded
once to f32, which gives the fused result (the CUDA kernel's
``__fmaf_rn``) bit for bit.  It is the CPU path of ``dispatch`` and the
plain version the kernel is held against on the card.

The backward is the same recurrence run in reverse with ``a`` shifted by
one: with ``g[t]`` the total adjoint of ``h[t]``, ``g[T-1] = dy[T-1]`` and
``g[t] = a[t+1] g[t+1] + dy[t]`` (one rounding a step, formed as above),
then ``db[t] = g[t]``, ``da[t] = g[t] h[t-1]`` (``h[-1] = h0``) and ``dh0 =
a[0] g[0]``, each product rounded once in f32.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _acc(*tensors) -> torch.dtype:
    """f32, or f64 where an input is f64 (the gradient oracle)."""
    acc = torch.float32
    for t in tensors:
        acc = torch.promote_types(acc, t.dtype)
    return acc


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: (..., T, D); h0: (..., D) -> all prefix states (..., T, D) f32
    (f64 for f64 inputs)."""
    acc = _acc(a, b, h0)
    h = h0.to(acc)
    out = torch.empty(a.shape, dtype=acc, device=a.device)
    if out.is_meta:
        return out          # shapes only: the steps hold no product to count
    for t in range(a.shape[-2]):
        h = (a[..., t, :].double() * h.double() + b[..., t, :].double()).to(acc)
        out[..., t, :] = h
    return out


def ssm_scan_bwd_ref(a: torch.Tensor, dy: torch.Tensor, out: torch.Tensor,
                     h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """a: (..., T, D) the decays; dy: (..., T, D) the gradient of the
    returned states ``out``; h0: (..., D) -> (da, db) (..., T, D) f32 and
    dh0 (..., D) f32 (f64 for f64 inputs)."""
    acc = _acc(a, dy, out, h0)
    da = torch.empty(a.shape, dtype=acc, device=a.device)
    db = torch.empty(a.shape, dtype=acc, device=a.device)
    g = torch.zeros(h0.shape, dtype=acc, device=a.device)
    a_next = torch.zeros(h0.shape, dtype=acc, device=a.device)
    for t in range(a.shape[-2] - 1, -1, -1):
        g = (a_next.double() * g.double() + dy[..., t, :].double()).to(acc)
        h_prev = out[..., t - 1, :].to(acc) if t > 0 else h0.to(acc)
        db[..., t, :] = g
        da[..., t, :] = g * h_prev
        a_next = a[..., t, :].to(acc)
    return da, db, a_next * g
