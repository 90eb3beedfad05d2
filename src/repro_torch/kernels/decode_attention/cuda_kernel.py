"""ctypes binding and launch wrapper of ``csrc/flash_decode.cu``.

The library is built with ``nvcc`` at first use (``kernels/nvcc.py``).
``flash_decode`` checks device, dtype, shape and contiguity, allocates the
output with ``torch.empty``, launches on PyTorch's current stream and
raises if the launch reports an error.  ``launch_count`` counts the
launches and nothing else, so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.kernels import nvcc

LIB_NAME = "flash_decode"
SOURCES = (Path(__file__).resolve().parent / "csrc" / "flash_decode.cu",)
HEAD_DIMS = (64, 128, 256)
MAX_GROUP = 16
CACHE_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
Q_TYPES = {torch.bfloat16: 1, torch.float32: 2}

launch_count: int = 0
_fn = None


def _launcher():
    global _fn
    if _fn is None:
        lib = nvcc.load_library(LIB_NAME, SOURCES)
        fn = lib.flash_decode_launch
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _fn = (fn, lib.flash_decode_error_string)
    return _fn


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode: {msg}")


def flash_decode(
    q: torch.Tensor,                     # (B, KV, G, hd) bf16/f32
    k: torch.Tensor,                     # (B, C, KV, hd) int8/bf16/f32
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],     # (B, C, KV) bf16, int8 caches only
    v_scale: Optional[torch.Tensor],
    n_valid: torch.Tensor,               # (B,) int32
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Length-masked decode attention on the card; returns (B, KV, G, hd)
    in q's dtype."""
    global launch_count
    b, kvh, g, hd = q.shape
    c = k.shape[1]
    tensors = [q, k, v, n_valid] + ([k_scale, v_scale] if k_scale is not None else [])
    _check(all(t.is_cuda and t.device == q.device for t in tensors), "all inputs must be on one CUDA device")
    _check(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _check(q.dtype in Q_TYPES, f"q dtype {q.dtype} not in {list(Q_TYPES)}")
    _check(k.dtype in CACHE_TYPES and v.dtype == k.dtype, f"cache dtype {k.dtype}/{v.dtype}")
    _check(hd in HEAD_DIMS and 1 <= g <= MAX_GROUP, f"head_dim {hd} / group {g} unsupported")
    _check(tuple(k.shape) == (b, c, kvh, hd) and tuple(v.shape) == (b, c, kvh, hd),
           f"cache shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    _check(n_valid.dtype == torch.int32 and tuple(n_valid.shape) == (b,), "n_valid must be (B,) int32")
    quantized = k.dtype == torch.int8
    _check(quantized == (k_scale is not None) == (v_scale is not None), "scales go with int8 caches only")
    if quantized:
        _check(k_scale.dtype == torch.bfloat16 and v_scale.dtype == torch.bfloat16
               and tuple(k_scale.shape) == (b, c, kvh) and tuple(v_scale.shape) == (b, c, kvh),
               "scales must be (B, C, KV) bf16")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn, err_str = _launcher()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        n_valid.data_ptr(), out.data_ptr(),
        b, c, kvh, g, hd, CACHE_TYPES[k.dtype], Q_TYPES[q.dtype], float(softcap), stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_decode launch failed: {err_str(err).decode()} (code {err})")
    launch_count += 1
    return out
