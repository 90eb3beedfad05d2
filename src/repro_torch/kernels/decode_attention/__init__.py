"""Length-masked decode attention: the hand CUDA kernel (``cuda_kernel``),
its plain PyTorch version (``torch_ref``) and the model-facing dispatch."""

from repro_torch.kernels.decode_attention.dispatch import decode_attention, decode_block_kv
from repro_torch.kernels.decode_attention.torch_ref import flash_decode_ref

__all__ = ["decode_attention", "decode_block_kv", "flash_decode_ref"]
