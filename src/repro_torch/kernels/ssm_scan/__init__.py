"""The linear-recurrence (selective-SSM state) scan: the hand CUDA kernel
(``cuda_kernel``), its plain PyTorch version (``torch_ref``) and the
dispatch."""

from repro_torch.kernels.ssm_scan.dispatch import ssm_scan
from repro_torch.kernels.ssm_scan.torch_ref import ssm_scan_ref

__all__ = ["ssm_scan", "ssm_scan_ref"]
