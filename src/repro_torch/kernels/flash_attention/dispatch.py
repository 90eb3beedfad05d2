"""Flash-attention entry points: the port's twin of
``repro/kernels/flash_attention/ops.py``.

``flash_attention`` takes ``(B, Sq, H, hd)`` queries and ``(B, Skv, KV,
hd)`` keys and values; ``grouped_flash_attention`` takes the model's grouped
query layout ``(B, S, KV, G, hd)`` (the same memory, ``h = kv * G + g``).
Both go through ``FlashAttentionFunction``: a CUDA tensor runs the hand
forward kernel and, for the gradient, the hand backward kernel, which read
KV head ``h // G`` in place; a CPU tensor runs the plain versions, which
repeat the KV heads as the reference's ``ops.py`` does.  There is no block
size to pass: the reference's ``block_q`` / ``block_kv`` tile the TPU
kernel, not the function.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from repro_torch.kernels import runtime
from repro_torch.kernels.flash_attention import cuda_kernel
from repro_torch.kernels.flash_attention.torch_ref import flash_attention_bwd_ref, gqa_flash_attention_ref


class FlashAttentionFunction(torch.autograd.Function):
    """Attention with its gradient: the forward and backward kernels on the
    card, ``gqa_flash_attention_ref`` and ``flash_attention_bwd_ref`` on the
    CPU.  The raw kernel wrappers refuse inputs that require grad; here the
    forward runs under autograd's own no-grad and saves q, k, v and the
    output for the backward, and, where a gradient is wanted and the
    backward reads them (``cuda_kernel.bwd_reads_stats``: bf16, and f32 up
    to hd 128), the forward kernel's row statistics (m, l), which the
    backward reads instead of recomputing them.  In f32 that request runs
    the forward on the bf16x6 body (f32-accurate, six bf16 products a
    product) instead of the serving body, 3xTF32, whose ~22 bits would
    reach every gradient.  A forward whose inputs need no gradient, or
    that runs with grad disabled (serving; ``grad_enabled``, which the
    entry points pass as ``torch.is_grad_enabled()``: inside ``forward``
    grad is always off), asks for no statistics.  Double backward
    raises."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: int, q_offset: int, softcap: float, grad_enabled: bool = True):
        kw = dict(causal=causal, window=window, q_offset=q_offset, softcap=softcap)
        stats = None
        if runtime.use_kernel(q):
            qkv = (q.contiguous(), k.contiguous(), v.contiguous())
            wants_grad = grad_enabled and any(ctx.needs_input_grad[:3])
            if wants_grad and cuda_kernel.bwd_reads_stats(q.dtype, q.shape[-1]):
                out, stats = cuda_kernel.flash_attention(*qkv, **kw, return_stats=True)
            else:
                out = cuda_kernel.flash_attention(*qkv, **kw)
        else:
            out = gqa_flash_attention_ref(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, out, stats)
        ctx.kw = kw
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, dout):
        q, k, v, out, stats = ctx.saved_tensors
        if runtime.use_kernel(q):
            grads = cuda_kernel.flash_attention_bwd(q.contiguous(), k.contiguous(), v.contiguous(), out,
                                                    dout.contiguous(), stats=stats, **ctx.kw)
        else:
            grads = flash_attention_bwd_ref(q, k, v, out, dout, **ctx.kw)
        return (*grads, None, None, None, None, None)


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
    q's dtype, differentiable in q, k and v."""
    return FlashAttentionFunction.apply(q, k, v, bool(causal), int(window), int(q_offset), float(softcap),
                                        torch.is_grad_enabled())


def grouped_flash_attention(
    q: torch.Tensor,     # (B, S, KV, G, hd) grouped query
    k: torch.Tensor,     # (B, Skv, KV, hd)
    v: torch.Tensor,
    **kw,
) -> torch.Tensor:
    """The model's layout: returns (B, S, KV, G, hd) in q's dtype."""
    b, s, kvh, g, hd = q.shape
    return flash_attention(q.reshape(b, s, kvh * g, hd), k, v, **kw).reshape(b, s, kvh, g, hd)
