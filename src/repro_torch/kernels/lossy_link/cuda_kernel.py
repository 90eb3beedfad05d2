"""ctypes binding and launch wrappers of ``csrc/lossy_link.cu``.

The library is built with ``nvcc`` at first use (``kernels/nvcc.py``).
The egress kernel draws its own uniforms: it takes the key, and each thread
computes its element's ``prng.uniform(key, (T, D))`` value from one threefry
block of the element's linear index (the partitionable scheme,
``prng.DEFAULT_PARTITIONABLE``), so no ``(T, D)`` uniform tensor is drawn
or read.  ``lossy_link_egress`` and ``burst_mask`` refuse inputs that require grad
(``runtime.forbid_grad``), check device, dtype, shape and contiguity,
allocate the output with ``torch.empty``, launch on PyTorch's current
stream and raise if the launch reports an error.
``egress_launch_count`` and ``burst_launch_count`` count each wrapper's
launches and nothing else, so a run can show that it went through the
kernel.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch import prng
from repro_torch.kernels import nvcc, runtime
from repro_torch.kernels.lossy_link.torch_ref import egress_constants, f32

LIB_NAME = "lossy_link"
SOURCES = (Path(__file__).resolve().parent / "csrc" / "lossy_link.cu",)
X_TYPES = {torch.bfloat16: 1, torch.float32: 2}
INT32_MAX = 2 ** 31 - 1

egress_launch_count: int = 0
burst_launch_count: int = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load_library(LIB_NAME, SOURCES)
        lib.lossy_link_egress_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 4
            + [ctypes.c_void_p])
        lib.burst_mask_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_float] * 5 + [ctypes.c_void_p])
        for fn in (lib.lossy_link_egress_launch, lib.burst_mask_launch):
            fn.restype = ctypes.c_int
        lib.lossy_link_error_string.argtypes = [ctypes.c_int]
        lib.lossy_link_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"lossy_link: {msg}")


def _check_common(tensors, first: torch.Tensor) -> None:
    _check(all(t.is_cuda and t.device == first.device for t in tensors), "all inputs must be on one CUDA device")
    _check(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")


def lossy_link_egress(
    key: torch.Tensor,                   # (2,) int64: two uint32 words
    x: torch.Tensor,                     # (T, D) bf16/f32
    s_min: torch.Tensor,                 # (D,) f32
    s_max: torch.Tensor,                 # (D,) f32
    *,
    bits: int,
    loss_rate: float,
) -> torch.Tensor:
    """Fused draw -> quantize -> keep if ``u >= p`` -> dequantize ->
    ``1/(1-p)`` on the card, ``u = prng.uniform(key, (T, D))`` computed in
    the kernel; returns (T, D) in x's dtype."""
    global egress_launch_count
    runtime.forbid_grad("lossy_link_egress", x, s_min, s_max)
    if not prng.DEFAULT_PARTITIONABLE:
        raise RuntimeError("lossy_link_egress: the kernel draws with the partitionable threefry scheme, but "
                           "prng.DEFAULT_PARTITIONABLE is False")
    _check(x.dim() == 2, f"x must be (T, D), got {tuple(x.shape)}")
    t, d = x.shape
    _check_common((key, x, s_min, s_max), x)
    _check(x.dtype in X_TYPES, f"x dtype {x.dtype} not in {list(X_TYPES)}")
    _check(key.dtype == torch.int64 and tuple(key.shape) == (2,), f"key must be (2,) int64, got {tuple(key.shape)} "
           f"{key.dtype}")
    _check(all(s.dtype == torch.float32 and tuple(s.shape) == (d,) for s in (s_min, s_max)),
           f"s_min, s_max must be ({d},) float32")
    _check(bits >= 1 and d <= INT32_MAX, f"bits {bits} / D {d} unsupported")
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    levels, p, comp, rng_floor = egress_constants(bits, loss_rate)
    err = _library().lossy_link_egress_launch(
        key.data_ptr(), x.data_ptr(), s_min.data_ptr(), s_max.data_ptr(), out.data_ptr(),
        t, d, X_TYPES[x.dtype], levels, p, comp, rng_floor, _stream(x))
    _raise_on(err, "lossy_link_egress")
    egress_launch_count += 1
    return out


def burst_mask(
    u_init: torch.Tensor,                # (R,) f32
    u_loss: torch.Tensor,                # (R, N) f32
    u_tr: torch.Tensor,                  # (R, N) f32
    *,
    p_gb: float,
    p_bg: float,
    loss_good: float,
    loss_bad: float,
) -> torch.Tensor:
    """(R, N) f32 0/1 Gilbert–Elliott packet keep masks on the card, one
    chain per row; the thresholds are rounded to f32 on the host (``pi_b``
    worked out in double first), as the reference's scan rounds them."""
    global burst_launch_count
    runtime.forbid_grad("burst_mask", u_init, u_loss, u_tr)
    _check(u_loss.dim() == 2, f"u_loss must be (R, N), got {tuple(u_loss.shape)}")
    r, n = u_loss.shape
    _check_common((u_init, u_loss, u_tr), u_loss)
    _check(all(a.dtype == torch.float32 for a in (u_init, u_loss, u_tr)), "uniforms must be float32")
    _check(tuple(u_init.shape) == (r,) and tuple(u_tr.shape) == (r, n),
           f"u_init must be ({r},) and u_tr {(r, n)}")
    _check(r <= INT32_MAX and n <= INT32_MAX, f"shape {(r, n)} unsupported")
    out = torch.empty_like(u_loss)
    if out.numel() == 0:
        return out
    pi_b = p_gb / max(p_gb + p_bg, 1e-12)
    err = _library().burst_mask_launch(
        u_init.data_ptr(), u_loss.data_ptr(), u_tr.data_ptr(), out.data_ptr(), r, n,
        f32(pi_b), f32(p_gb), f32(p_bg), f32(loss_good), f32(loss_bad), _stream(u_loss))
    _raise_on(err, "burst_mask")
    burst_launch_count += 1
    return out


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_library().lossy_link_error_string(err).decode()} "
                           f"(code {err})")
