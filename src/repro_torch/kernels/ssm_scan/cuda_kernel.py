"""ctypes binding and launch wrapper of ``csrc/ssm_scan.cu``.

The library is built with ``nvcc`` at first use (``kernels/nvcc.py``).
``ssm_scan`` refuses inputs that require grad (``runtime.forbid_grad``),
checks device, dtype, shape and contiguity, allocates the output with
``torch.empty``, launches on PyTorch's current stream and raises if the
launch reports an error.  ``launch_count`` counts its
launches and nothing else, so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc, runtime

LIB_NAME = "ssm_scan"
SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu",)
DTYPES = {torch.bfloat16: 1, torch.float32: 2}
INT32_MAX = 2 ** 31 - 1
MAX_GRID_Y = 65535

launch_count: int = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load_library(LIB_NAME, SOURCES)
        lib.ssm_scan_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ssm_scan_launch.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssm_scan: {msg}")


def ssm_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, D) bf16/f32; h0: (B, D) bf16/f32 -> all prefix states
    (B, T, D) f32, on the card."""
    global launch_count
    runtime.forbid_grad("ssm_scan", a, b, h0)
    _check(a.dim() == 3 and h0.dim() == 2, f"a {tuple(a.shape)} / h0 {tuple(h0.shape)}: want (B, T, D) / (B, D)")
    bsz, t, d = a.shape
    _check(tuple(b.shape) == (bsz, t, d) and tuple(h0.shape) == (bsz, d),
           f"b {tuple(b.shape)} / h0 {tuple(h0.shape)} vs a {tuple(a.shape)}")
    _check(all(x.is_cuda and x.device == a.device for x in (a, b, h0)), "all inputs must be on one CUDA device")
    _check(all(x.is_contiguous() for x in (a, b, h0)), "inputs must be contiguous")
    _check(a.dtype in DTYPES and b.dtype == a.dtype and h0.dtype in DTYPES,
           f"dtypes {a.dtype}/{b.dtype}/{h0.dtype}: a and b share one of {list(DTYPES)}, h0 one of them")
    _check(bsz <= MAX_GRID_Y and t <= INT32_MAX and d <= INT32_MAX, f"shape {tuple(a.shape)} too large")
    out = torch.empty((bsz, t, d), dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    err = _library().ssm_scan_launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), bsz, t, d,
                                     DTYPES[a.dtype], DTYPES[h0.dtype],
                                     torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan launch failed: {_library().ssm_scan_error_string(err).decode()} (code {err})")
    launch_count += 1
    return out
