"""ctypes binding and launch wrappers of ``csrc/ssm_scan.cu``: the scan
(B6) and its backward (B6').

The library is built with ``nvcc`` at first use (``kernels/nvcc.py``).
Each wrapper refuses inputs that require grad (``runtime.forbid_grad``:
the gradient runs through ``dispatch.SSMScanFunction``, whose backward
calls ``ssm_scan_bwd`` with grad off), checks device, dtype, shape and
contiguity, allocates its outputs with ``torch.empty``, launches on
PyTorch's current stream and raises if the launch reports an error.
``launch_count`` and ``bwd_launch_count`` count each wrapper's launches
and nothing else, so a run can show that it went through the kernels.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import nvcc, runtime

LIB_NAME = "ssm_scan"
SOURCES = (Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu",)
DTYPES = {torch.bfloat16: 1, torch.float32: 2}
INT32_MAX = 2 ** 31 - 1
MAX_GRID_Y = 65535

launch_count: int = 0
bwd_launch_count: int = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load_library(LIB_NAME, SOURCES)
        lib.ssm_scan_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ssm_scan_launch.restype = ctypes.c_int
        lib.ssm_scan_bwd_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.ssm_scan_bwd_launch.restype = ctypes.c_int
        lib.ssm_scan_error_string.argtypes = [ctypes.c_int]
        lib.ssm_scan_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"ssm_scan: {msg}")


def _check_inputs(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor, b_name: str, b_dtypes) -> None:
    """The checks both wrappers run: ``a`` and ``b`` (B, T, D), ``h0`` (B, D),
    one CUDA device, contiguous, ``b``'s dtype in ``b_dtypes``."""
    _check(a.dim() == 3 and h0.dim() == 2, f"a {tuple(a.shape)} / h0 {tuple(h0.shape)}: want (B, T, D) / (B, D)")
    bsz, t, d = a.shape
    _check(tuple(b.shape) == (bsz, t, d) and tuple(h0.shape) == (bsz, d),
           f"{b_name} {tuple(b.shape)} / h0 {tuple(h0.shape)} vs a {tuple(a.shape)}")
    _check(all(x.is_cuda and x.device == a.device for x in (a, b, h0)), "all inputs must be on one CUDA device")
    _check(all(x.is_contiguous() for x in (a, b, h0)), "inputs must be contiguous")
    _check(a.dtype in DTYPES and b.dtype in b_dtypes and h0.dtype in DTYPES,
           f"dtypes {a.dtype}/{b.dtype}/{h0.dtype}: a one of {list(DTYPES)}, {b_name} one of {list(b_dtypes)}, "
           f"h0 one of {list(DTYPES)}")
    _check(bsz <= MAX_GRID_Y and t <= INT32_MAX and d <= INT32_MAX, f"shape {tuple(a.shape)} too large")


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_library().ssm_scan_error_string(err).decode()} (code {err})")


def ssm_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """a, b: (B, T, D) bf16/f32; h0: (B, D) bf16/f32 -> all prefix states
    (B, T, D) f32, on the card."""
    global launch_count
    runtime.forbid_grad("ssm_scan", a, b, h0)
    _check_inputs(a, b, h0, "b", (a.dtype,))
    out = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    if out.numel() == 0:
        return out
    bsz, t, d = a.shape
    _raise_on(_library().ssm_scan_launch(a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), bsz, t, d,
                                         DTYPES[a.dtype], DTYPES[h0.dtype],
                                         torch.cuda.current_stream(a.device).cuda_stream), "ssm_scan")
    launch_count += 1
    return out


def ssm_scan_bwd(a: torch.Tensor, dy: torch.Tensor, out: torch.Tensor,
                 h0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """a: (B, T, D) bf16/f32 the decays; dy: (B, T, D) f32 the gradient of
    ``out``, the forward's (B, T, D) f32 states; h0: (B, D) bf16/f32 ->
    (da, db) (B, T, D) f32 and dh0 (B, D) f32, on the card."""
    global bwd_launch_count
    runtime.forbid_grad("ssm_scan_bwd", a, dy, out, h0)
    _check_inputs(a, dy, h0, "dy", (torch.float32,))
    _check(tuple(out.shape) == tuple(a.shape) and out.dtype == torch.float32 and out.is_contiguous()
           and out.device == a.device, f"out {tuple(out.shape)} {out.dtype}: want a contiguous f32 {tuple(a.shape)} "
           "on a's device")
    da = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    db = torch.empty(a.shape, dtype=torch.float32, device=a.device)
    dh0 = torch.empty(h0.shape, dtype=torch.float32, device=a.device)
    if da.numel() == 0:
        return da, db, dh0.zero_()
    bsz, t, d = a.shape
    _raise_on(_library().ssm_scan_bwd_launch(a.data_ptr(), dy.data_ptr(), out.data_ptr(), h0.data_ptr(),
                                             da.data_ptr(), db.data_ptr(), dh0.data_ptr(), bsz, t, d,
                                             DTYPES[a.dtype], DTYPES[h0.dtype],
                                             torch.cuda.current_stream(a.device).cuda_stream), "ssm_scan_bwd")
    bwd_launch_count += 1
    return da, db, dh0
