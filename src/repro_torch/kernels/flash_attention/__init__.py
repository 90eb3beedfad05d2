"""Whole-sequence attention with an online softmax (prefill past
``attn_block_q``): the hand CUDA kernel (``cuda_kernel``), its plain
PyTorch version (``torch_ref``) and the model-facing dispatch, with the
gradient of both through ``FlashAttentionFunction``."""

from repro_torch.kernels.flash_attention.dispatch import (
    FlashAttentionFunction,
    flash_attention,
    grouped_flash_attention,
)
from repro_torch.kernels.flash_attention.torch_ref import (
    flash_attention_bwd_ref,
    flash_attention_ref,
    gqa_flash_attention_ref,
)

__all__ = ["FlashAttentionFunction", "flash_attention", "flash_attention_bwd_ref", "flash_attention_ref",
           "gqa_flash_attention_ref", "grouped_flash_attention"]
