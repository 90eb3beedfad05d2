"""Flash-attention entry points: the port's twin of
``repro/kernels/flash_attention/ops.py``.

``flash_attention`` takes ``(B, Sq, H, hd)`` queries and ``(B, Skv, KV,
hd)`` keys and values; ``grouped_flash_attention`` takes the model's grouped
query layout ``(B, S, KV, G, hd)`` (the same memory, ``h = kv * G + g``).
A CUDA tensor goes to the hand kernel, which reads KV head ``h // G`` in
place; a CPU tensor goes to the plain version, which repeats the KV heads
as the reference's ``ops.py`` does.  There is no block size to pass: the reference's
``block_q`` / ``block_kv`` tile the TPU kernel, not the function.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import cuda_kernel
from repro_torch.kernels.flash_attention.torch_ref import gqa_flash_attention_ref


def flash_attention(
    q: torch.Tensor,     # (B, Sq, H, hd)
    k: torch.Tensor,     # (B, Skv, KV, hd)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softcap: float = 0.0,
) -> torch.Tensor:
    """GQA attention over the whole sequence; returns (B, Sq, H, hd) in
    q's dtype."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
    if runtime.use_kernel(q):
        return cuda_kernel.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), **kw)
    return gqa_flash_attention_ref(q, k, v, **kw)


def grouped_flash_attention(
    q: torch.Tensor,     # (B, S, KV, G, hd) grouped query
    k: torch.Tensor,     # (B, Skv, KV, hd)
    v: torch.Tensor,
    **kw,
) -> torch.Tensor:
    """The model's layout: returns (B, S, KV, G, hd) in q's dtype."""
    b, s, kvh, g, hd = q.shape
    return flash_attention(q.reshape(b, s, kvh * g, hd), k, v, **kw).reshape(b, s, kvh, g, hd)
