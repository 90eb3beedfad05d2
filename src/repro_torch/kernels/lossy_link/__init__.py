"""The split-point link kernels: the fused lossy-link egress and the
Gilbert–Elliott burst mask, as hand CUDA kernels (``cuda_kernel``), their
plain PyTorch versions (``torch_ref``) and the link-facing dispatch."""

from repro_torch.kernels.lossy_link.dispatch import burst_mask, lossy_link_egress
from repro_torch.kernels.lossy_link.torch_ref import (
    burst_mask_ref,
    burst_mask_scan_ref,
    lossy_link_egress_keyed_ref,
    lossy_link_egress_ref,
)

__all__ = ["burst_mask", "burst_mask_ref", "burst_mask_scan_ref", "lossy_link_egress", "lossy_link_egress_keyed_ref",
           "lossy_link_egress_ref"]
