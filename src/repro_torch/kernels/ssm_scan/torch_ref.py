"""Plain PyTorch linear-recurrence scan: the port's twin of
``repro/kernels/ssm_scan/ref.py``.

All prefix states of ``h[t] = a[t] * h[t-1] + b[t]`` from ``h0``, in f32.
XLA contracts the reference's ``a * h + b`` into one fused multiply-add,
rounded once; PyTorch has no such op, and a multiply then an add rounds
twice (up to ~5e-7 apart over a few hundred steps).  Each step here is
formed in f64, where the product of two f32 values is exact, and rounded
once to f32, which gives the fused result (the CUDA kernel's
``__fmaf_rn``) bit for bit.  It is the CPU path of ``dispatch`` and the
plain version the kernel is held against on the card.
"""

from __future__ import annotations

import torch


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: (..., T, D); h0: (..., D) -> all prefix states (..., T, D) f32."""
    h = h0.float()
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    for t in range(a.shape[-2]):
        h = (a[..., t, :].double() * h.double() + b[..., t, :].double()).float()
        out[..., t, :] = h
    return out
