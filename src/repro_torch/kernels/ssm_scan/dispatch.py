"""SSM-scan entry point: the port's twin of ``repro/kernels/ssm_scan/ops.py``
(there a ``vmap`` of the kernel over the batch; here the batch is a grid
axis of the kernel).  A CUDA tensor goes to the hand kernel; a CPU tensor
goes to the plain version."""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.ssm_scan import cuda_kernel
from repro_torch.kernels.ssm_scan.torch_ref import ssm_scan_ref


def ssm_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, D); h0: (B, D) -> prefix states (B, T, D) f32."""
    if runtime.use_kernel(a):
        return cuda_kernel.ssm_scan(a.contiguous(), b.contiguous(), h0.contiguous())
    return ssm_scan_ref(a, b, h0)
