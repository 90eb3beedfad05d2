"""Split-point link entry points: the port's twin of
``repro/kernels/lossy_link/ops.py``.

The uniforms follow the reference's key use, so they are bit-equal to its
``jax.random`` draws.  A CUDA tensor goes to the hand kernel (or the call
raises); a CPU tensor goes to the plain version.  The egress kernel draws
its own uniforms from the key in registers (no ``prng.uniform`` call on
that path); its plain version draws them with ``prng.uniform`` first.  The
burst mask's three draws are made here for both.
"""

from __future__ import annotations

import torch

from repro_torch import prng
from repro_torch.core.compression import QuantSpec
from repro_torch.kernels import runtime
from repro_torch.kernels.lossy_link import cuda_kernel
from repro_torch.kernels.lossy_link.torch_ref import burst_mask_ref, lossy_link_egress_keyed_ref


def lossy_link_egress(key: torch.Tensor, x: torch.Tensor, quant: QuantSpec, loss_rate: float) -> torch.Tensor:
    """Quantize -> mask(p) -> dequantize -> 1/(1-p), fused, on the
    ``(..., D)`` split activation; ``u = uniform(key, (T, D))`` over its
    ``(T, D)`` flattening."""
    shape = x.shape
    flat = x.reshape(-1, shape[-1])
    s_min, s_max = quant.s_min.float(), quant.s_max.float()
    kw = dict(bits=quant.bits, loss_rate=float(loss_rate))
    if runtime.use_kernel(flat):
        out = cuda_kernel.lossy_link_egress(key.contiguous(), flat.contiguous(), s_min.contiguous(),
                                            s_max.contiguous(), **kw)
    else:
        out = lossy_link_egress_keyed_ref(key, flat, s_min, s_max, **kw)
    return out.reshape(shape)


def burst_mask(key: torch.Tensor, n_rows: int, n_packets: int, *, p_gb: float, p_bg: float,
               loss_good: float = 0.0, loss_bad: float = 1.0) -> torch.Tensor:
    """(n_rows, n_packets) f32 Gilbert–Elliott packet keep masks, one chain
    per row, from ``split(key, 3)``'s initial-state, loss and transition
    uniforms."""
    kinit, kloss, ktr = prng.split(key, 3)
    u_init = prng.uniform(kinit, (n_rows,))
    u_loss = prng.uniform(kloss, (n_rows, n_packets))
    u_tr = prng.uniform(ktr, (n_rows, n_packets))
    kw = dict(p_gb=float(p_gb), p_bg=float(p_bg), loss_good=float(loss_good), loss_bad=float(loss_bad))
    if runtime.use_kernel(u_loss):
        return cuda_kernel.burst_mask(u_init, u_loss, u_tr, **kw)
    return burst_mask_ref(u_init, u_loss, u_tr, **kw)
