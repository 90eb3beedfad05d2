"""The linear-recurrence (selective-SSM state) scan: the hand CUDA kernels
(``cuda_kernel``: the scan and its backward), their plain PyTorch versions
(``torch_ref``) and the dispatch (``SSMScanFunction`` where a gradient is
wanted)."""

from repro_torch.kernels.ssm_scan.dispatch import SSMScanFunction, ssm_scan
from repro_torch.kernels.ssm_scan.torch_ref import ssm_scan_bwd_ref, ssm_scan_ref

__all__ = ["SSMScanFunction", "ssm_scan", "ssm_scan_bwd_ref", "ssm_scan_ref"]
