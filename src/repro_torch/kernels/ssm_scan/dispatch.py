"""SSM-scan entry point: the port's twin of ``repro/kernels/ssm_scan/ops.py``
(there a ``vmap`` of the kernel over the batch; here the batch is a grid
axis of the kernel).  A CUDA tensor goes to the hand kernel; a CPU tensor
goes to the plain version, both through ``SSMScanFunction``, whose
backward is the hand kernel B6' on the card and the plain reverse scan on
the CPU."""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import runtime
from repro_torch.kernels.ssm_scan import cuda_kernel
from repro_torch.kernels.ssm_scan.torch_ref import ssm_scan_bwd_ref, ssm_scan_ref


class SSMScanFunction(torch.autograd.Function):
    """The scan with its gradient: ``cuda_kernel.ssm_scan`` and
    ``cuda_kernel.ssm_scan_bwd`` on the card, ``ssm_scan_ref`` and
    ``ssm_scan_bwd_ref`` on the CPU.  The forward saves ``a``, its output
    and ``h0``; the backward reads no ``b``, so ``b`` is not kept.  The
    gradients come back in f32 and are cast to the inputs' dtypes.  Double
    backward raises."""

    @staticmethod
    def forward(ctx, a, b, h0):
        if runtime.use_kernel(a):
            out = cuda_kernel.ssm_scan(a.contiguous(), b.contiguous(), h0.contiguous())
        else:
            out = ssm_scan_ref(a, b, h0)
        ctx.save_for_backward(a, out, h0)
        ctx.dtypes = (a.dtype, b.dtype, h0.dtype)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dy):
        a, out, h0 = ctx.saved_tensors
        if runtime.use_kernel(a):
            grads = cuda_kernel.ssm_scan_bwd(a.contiguous(), dy.contiguous(), out, h0.contiguous())
        else:
            grads = ssm_scan_bwd_ref(a, dy, out, h0)
        return tuple(g.to(dt) for g, dt in zip(grads, ctx.dtypes))


def ssm_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, D); h0: (B, D) -> prefix states (B, T, D) f32,
    differentiable in a, b and h0 where grad is enabled (under no_grad or
    inference_mode the Function builds no graph and keeps nothing)."""
    return SSMScanFunction.apply(a, b, h0)
