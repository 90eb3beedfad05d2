"""Plain PyTorch split-point link kernels: the port's twin of
``repro/kernels/lossy_link/ref.py``.

``lossy_link_egress_ref`` mirrors the reference op for op in f32: clip
(``minimum(maximum(x, s_min), s_max)``), ``round((c - s_min) / rng *
levels)`` (half to even), ``code / levels * rng + s_min``, keep where ``u
>= p``, scale by ``comp``, cast to x's dtype.  The scalars are fixed on the
host as the reference fixes them (``egress_constants``).  ``levels`` is a
0-d tensor on x's device, not a Python float: PyTorch's CUDA division by a
host scalar multiplies by its reciprocal, which can differ from ``/`` in
the last bit, and the kernel divides.

``burst_mask_ref`` defers to the port's Gilbert–Elliott scan, as the
reference's defers to its own.  Both are the CPU path of ``dispatch`` and
the plain versions the CUDA kernels are held against, bit for bit, on the
card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.net.channels import gilbert_elliott_scan


def f32(value: float) -> float:
    """``value`` rounded to float32, as a Python float."""
    return float(np.float32(value))


def egress_constants(bits: int, loss_rate: float) -> Tuple[float, float, float, float]:
    """``(levels, p, comp, rng_floor)`` as the reference fixes them: worked
    out in Python double, then rounded to f32."""
    comp = 1.0 / max(1.0 - float(loss_rate), 1e-6) if loss_rate > 0.0 else 1.0
    return f32(2 ** bits - 1), f32(loss_rate), f32(comp), f32(1e-8)


def lossy_link_egress_ref(x: torch.Tensor, u: torch.Tensor, s_min: torch.Tensor, s_max: torch.Tensor, *,
                          bits: int, loss_rate: float) -> torch.Tensor:
    """Quantize -> keep if ``u >= p`` -> dequantize -> ``1/(1-p)``, per
    element of ``x`` (T, D) f32/bf16; ``u`` (T, D) f32; ``s_min``, ``s_max``
    (D,).  Returns x's dtype."""
    levels, p, comp, rng_floor = egress_constants(bits, loss_rate)
    lv = torch.full((), levels, dtype=torch.float32, device=x.device)
    s_min, s_max = s_min.float(), s_max.float()
    rng = torch.clamp(s_max - s_min, min=rng_floor)
    clipped = torch.minimum(torch.maximum(x.float(), s_min), s_max)
    code = torch.round((clipped - s_min) / rng * lv)
    deq = code / lv * rng + s_min
    keep = u.float() >= p
    return torch.where(keep, deq * comp, 0.0).to(x.dtype)


def burst_mask_ref(u_init: torch.Tensor, u_loss: torch.Tensor, u_tr: torch.Tensor, *,
                   p_gb: float, p_bg: float, loss_good: float, loss_bad: float) -> torch.Tensor:
    """(R, N) f32 0/1 Gilbert–Elliott packet keep masks from ``u_init`` (R,)
    and ``u_loss``, ``u_tr`` (R, N): one independent chain per row."""
    return gilbert_elliott_scan(u_init.float(), u_loss.float(), u_tr.float(), p_gb, p_bg, loss_good, loss_bad)
