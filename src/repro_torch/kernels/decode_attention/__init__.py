"""Length-masked decode attention over a contiguous cache or a paged block
pool: the hand CUDA kernel, one split-KV body for both (``cuda_kernel``),
its plain PyTorch versions (``torch_ref``) and the model-facing dispatch."""

from repro_torch.kernels.decode_attention.dispatch import (
    decode_attention,
    decode_block_kv,
    paged_decode_attention,
)
from repro_torch.kernels.decode_attention.torch_ref import (
    flash_decode_ref,
    flash_decode_split_ref,
    paged_flash_decode_ref,
    paged_flash_decode_split_ref,
)

__all__ = ["decode_attention", "decode_block_kv", "flash_decode_ref", "flash_decode_split_ref",
           "paged_decode_attention", "paged_flash_decode_ref", "paged_flash_decode_split_ref"]
