"""Length-masked decode attention over a contiguous cache or a paged block
pool: the hand CUDA kernel, one split-KV body for both (``cuda_kernel``),
its plain PyTorch versions (``torch_ref``) and the model-facing dispatch,
with context-parallel decode's partials (a rank's splits folded into one
entry a row) and cross-rank merge."""

from repro_torch.kernels.decode_attention.dispatch import (
    decode_attention,
    decode_attention_partials,
    decode_block_kv,
    merge_decode_partials,
    paged_decode_attention,
    partials_buffer,
    split_partials,
)
from repro_torch.kernels.decode_attention.torch_ref import (
    flash_decode_partials_ref,
    flash_decode_ref,
    flash_decode_split_ref,
    fold_partials_ref,
    merge_partials_ref,
    paged_flash_decode_ref,
    paged_flash_decode_split_ref,
)

__all__ = ["decode_attention", "decode_attention_partials", "decode_block_kv", "flash_decode_partials_ref",
           "flash_decode_ref", "flash_decode_split_ref", "fold_partials_ref", "merge_decode_partials",
           "merge_partials_ref", "paged_decode_attention", "paged_flash_decode_ref", "paged_flash_decode_split_ref",
           "partials_buffer", "split_partials"]
