"""ctypes binding and launch wrappers of the three flash-attention forward
bodies and of the three backward bodies.

``body_for`` picks from the dtype and head dim alone; nothing retries on
another body:

* ``"wgmma"`` -- ``csrc/flash_attention_wgmma.cu``: bf16 at head dims
  that are multiples of 8 up to 256 on the tensor cores (wgmma, K/V fed by
  TMA), built at widths 64, 128 and 256: a call runs at the first width
  >= hd, the tensor maps zero-filling the columns past hd;
* ``"tf32x3"`` -- ``csrc/flash_attention_tf32x3.cu``: f32 at head dims
  that are multiples of 8 up to 256 on the tensor cores (mma.sync) in
  error-compensated TF32.  One TF32 product keeps ~11 bits and misses the
  f32 bar (``atol`` 2e-5) by ~50x; splitting each operand as hi + lo and
  summing hi*hi + hi*lo + lo*hi in f32 keeps plain f32's error (~7e-7
  against ~1e-3 at the long prefill's shape);
* ``"simt"`` -- ``csrc/flash_attention.cu``: the rest (head dims that are
  not multiples of 8, or dtypes neither takes) on the CUDA cores in f32
  FMAs.

All five build into one library with ``nvcc`` at first use
(``kernels/nvcc.py``).

``flash_attention`` refuses inputs that require grad
(``runtime.forbid_grad``), checks device, dtype, shape, contiguity and
alignment, allocates the output with ``torch.empty``, launches on PyTorch's
current stream and raises if the launch reports an error.  ``launch_count`` counts
its launches and nothing else, so a run can show that it went through the
kernel; ``body_launch_count`` splits the same count by body.  Asked
with ``return_stats=True`` (the wgmma body only), it also returns each
row's max m (log2 units) and sum l, f32 ``(2, B * H * Sq)``, for the
backward.

``flash_attention_bwd`` takes the forward's inputs, its output and the
output's gradient and returns dQ, dK and dV, with the same checks and
guard.  ``bwd_body_for`` picks its body, as ``body_for`` does:

* ``"wgmma"`` -- ``csrc/flash_attention_bwd_wgmma.cu``: bf16 at head dims
  that are multiples of 8 up to 256 on the tensor cores (zero-filled as the
  forward); it reads the forward's ``stats`` (required) and runs two device
  kernels (dQ with D = rowsum(dO * O), then dK/dV summed over each KV
  head's group);
* ``"bf16x6"`` -- the same body on f32 at head dims that are multiples of
  8 up to 128, at f32 accuracy: each operand split into three bf16 planes
  (hi, mid, lo) and each product run as six bf16 wgmmas; four device
  kernels (the split, its own row statistics, dQ, dK/dV) over one scratch
  buffer; it takes no ``stats``;
* ``"simt"`` -- ``csrc/flash_attention_bwd.cu``: the rest (f32 at hd 136
  to 256, head dims that are not multiples of 8) on the CUDA cores, three
  device kernels (its own row statistics, dK/dV, dQ); it takes no
  ``stats``.

``bwd_launch_count`` counts its calls, ``bwd_body_launch_count`` by body.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc, runtime

LIB_NAME = "flash_attention"
_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "flash_attention.cu", _CSRC / "flash_attention_wgmma.cu", _CSRC / "flash_attention_tf32x3.cu",
           _CSRC / "flash_attention_bwd.cu", _CSRC / "flash_attention_bwd_wgmma.cu")
DTYPES = {torch.bfloat16: 1, torch.float32: 2}
MAX_HEAD_DIM = 256
BF16X6_MAX_HEAD_DIM = 128   # three planes of every tile fill shared memory past it
MAX_GRID_Y = 65535

launch_count: int = 0
body_launch_count: dict = {"wgmma": 0, "tf32x3": 0, "simt": 0}
bwd_launch_count: int = 0
bwd_body_launch_count: dict = {"wgmma": 0, "bf16x6": 0, "simt": 0}
_lib = None


def flash_attention_launch_count() -> int:
    return launch_count


def body_for(dtype: torch.dtype, hd: int) -> str:
    """The body a call takes at a head dim that is a multiple of 8 up to
    256: ``"wgmma"`` for bf16, ``"tf32x3"`` for f32 (both on the tensor
    cores); else ``"simt"`` (CUDA cores)."""
    if hd % 8 == 0 and hd <= MAX_HEAD_DIM:
        if dtype == torch.bfloat16:
            return "wgmma"
        if dtype == torch.float32:
            return "tf32x3"
    return "simt"


def bwd_body_for(dtype: torch.dtype, hd: int) -> str:
    """The backward body a call takes at a head dim that is a multiple of
    8: ``"wgmma"`` for bf16 up to 256 (tensor cores, the forward's
    statistics), ``"bf16x6"`` for f32 up to 128 (tensor cores, six bf16
    products an f32 one, its own statistics); else ``"simt"`` (CUDA cores,
    its own statistics pass)."""
    if hd % 8 == 0:
        if dtype == torch.bfloat16 and hd <= MAX_HEAD_DIM:
            return "wgmma"
        if dtype == torch.float32 and hd <= BF16X6_MAX_HEAD_DIM:
            return "bf16x6"
    return "simt"


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load_library(LIB_NAME, SOURCES)
        # (q, k, v, out, B, Sq, Skv, H, KV, hd, [dtype,] causal, window, q_offset, softcap, stream)
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        # (q, k, v, out, [stats,] B, Sq, Skv, H, KV, hd, causal, window, q_offset, softcap, stream)
        lib.flash_attention_wgmma_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_tf32x3_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        # (q, k, v, o, dout, dq, dk, dv, stats, B, Sq, Skv, H, KV, hd, dtype, causal, window,
        #  q_offset, softcap, stream)
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        # (q, k, v, o, dout, stats, rec, dq, dk, dv, B, Sq, Skv, H, KV, hd, causal, window, q_offset,
        #  softcap, stream)
        lib.flash_attention_bwd_wgmma_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bwd_wgmma_scratch.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_bwd_wgmma_scratch.restype = ctypes.c_longlong
        # (q, k, v, o, dout, scratch, dq, dk, dv, B, Sq, Skv, H, KV, hd, causal, window, q_offset,
        #  softcap, stream)
        lib.flash_attention_bwd_bf16x6_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bwd_bf16x6_scratch.argtypes = [ctypes.c_int] * 6
        lib.flash_attention_bwd_bf16x6_scratch.restype = ctypes.c_longlong
        for fn in (lib.flash_attention_launch, lib.flash_attention_wgmma_launch, lib.flash_attention_tf32x3_launch,
                   lib.flash_attention_bwd_launch, lib.flash_attention_bwd_wgmma_launch,
                   lib.flash_attention_bwd_bf16x6_launch):
            fn.restype = ctypes.c_int
        for fn in (lib.flash_attention_error_string, lib.flash_attention_wgmma_error_string,
                   lib.flash_attention_tf32x3_error_string, lib.flash_attention_bwd_error_string,
                   lib.flash_attention_bwd_wgmma_error_string):
            fn.argtypes = [ctypes.c_int]
            fn.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_attention: {msg}")


def _check_inputs(q, k, v, *others, q_offset: int, window: int) -> None:
    """The checks both wrappers make: one CUDA device, contiguous, one
    dtype, (B, Sq, H, hd) queries (and ``others``, the output and its
    gradient) against (B, Skv, KV, hd) keys and values."""
    _check(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, "q, k, v must be 4-d")
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    _check(all(t.is_cuda and t.device == q.device for t in (q, k, v, *others)), "all inputs must be on one CUDA device")
    _check(all(t.is_contiguous() for t in (q, k, v, *others)), "inputs must be contiguous")
    _check(q.dtype in DTYPES and all(t.dtype == q.dtype for t in (k, v, *others)),
           f"dtypes {[str(t.dtype) for t in (q, k, v, *others)]}: all must share one of {list(DTYPES)}")
    _check(tuple(k.shape) == (b, skv, kvh, hd) and tuple(v.shape) == (b, skv, kvh, hd),
           f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} vs q {tuple(q.shape)}")
    _check(all(tuple(t.shape) == tuple(q.shape) for t in others),
           f"output / gradient shapes {[tuple(t.shape) for t in others]} vs q {tuple(q.shape)}")
    _check(kvh >= 1 and h % kvh == 0, f"{h} query heads are not a multiple of {kvh} KV heads")
    _check(1 <= hd <= MAX_HEAD_DIM, f"head_dim {hd} outside [1, {MAX_HEAD_DIM}]")
    _check(b * h <= MAX_GRID_Y, f"B * H = {b * h} > {MAX_GRID_Y}")
    _check(q_offset >= 0 and window >= 0, f"q_offset {q_offset} / window {window} must be >= 0")


def flash_attention(
    q: torch.Tensor,          # (B, Sq, H, hd) bf16/f32
    k: torch.Tensor,          # (B, Skv, KV, hd), H % KV == 0
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softcap: float = 0.0,
    return_stats: bool = False,
):
    """Online-softmax attention of the whole query sequence on the card;
    query head ``h`` reads KV head ``h // (H // KV)`` in place.  Returns
    (B, Sq, H, hd) in q's dtype; with ``return_stats`` (wgmma body only)
    also the rows' m and l for ``flash_attention_bwd``."""
    global launch_count
    runtime.forbid_grad("flash_attention", q, k, v)
    _check_inputs(q, k, v, q_offset=q_offset, window=window)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    body = body_for(q.dtype, hd)
    _check(not return_stats or body == "wgmma", f"return_stats: only the wgmma body writes row statistics, not {body}")
    out = torch.empty_like(q)
    stats = torch.empty((2, b * h * sq), dtype=torch.float32, device=q.device) if return_stats else None
    if out.numel() == 0:
        return (out, stats) if return_stats else out
    lib = _library()
    flags = (int(bool(causal)), int(window), int(q_offset), float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    if body in ("wgmma", "tf32x3"):
        # TMA / cp.async read the tensors in place, 16 bytes at a time.
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)), f"{body} body: inputs must be 16-byte aligned")
        launch, what = ((lib.flash_attention_wgmma_launch, lib.flash_attention_wgmma_error_string) if body == "wgmma"
                        else (lib.flash_attention_tf32x3_launch, lib.flash_attention_tf32x3_error_string))
        ptrs = [q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr()]
        if body == "wgmma":
            ptrs.append(None if stats is None else stats.data_ptr())
        err = launch(*ptrs, b, sq, skv, h, kvh, hd, *flags)
    else:
        err = lib.flash_attention_launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                         b, sq, skv, h, kvh, hd, DTYPES[q.dtype], *flags)
        what = lib.flash_attention_error_string
    if err != 0:
        raise RuntimeError(f"flash_attention ({body} body) launch failed: {what(err).decode()} (code {err})")
    launch_count += 1
    body_launch_count[body] += 1
    return (out, stats) if return_stats else out


def flash_attention_bwd(
    q: torch.Tensor,          # (B, Sq, H, hd) bf16/f32
    k: torch.Tensor,          # (B, Skv, KV, hd)
    v: torch.Tensor,
    out: torch.Tensor,        # (B, Sq, H, hd): the forward's output
    dout: torch.Tensor,       # (B, Sq, H, hd): its gradient
    *,
    stats: torch.Tensor | None = None,   # (2, B * H * Sq) f32: the wgmma forward's m and l
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softcap: float = 0.0,
):
    """dQ, dK and dV of ``flash_attention`` on the card, each in q's dtype;
    dK and dV of KV head ``kv`` sum over its query heads in the kernel.  The
    wgmma body needs the forward's ``stats``; the bf16x6 and CUDA-core
    bodies take none."""
    global bwd_launch_count
    runtime.forbid_grad("flash_attention_bwd", q, k, v, out, dout)
    _check_inputs(q, k, v, out, dout, q_offset=q_offset, window=window)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    body = bwd_body_for(q.dtype, hd)
    if body == "wgmma":
        _check(stats is not None, "the wgmma backward reads the forward's row statistics: pass stats= from "
                                  "flash_attention(..., return_stats=True)")
        _check(stats.device == q.device and stats.dtype == torch.float32 and stats.is_contiguous()
               and tuple(stats.shape) == (2, b * h * sq), f"stats must be contiguous f32 (2, {b * h * sq}) on "
               f"{q.device}, got {stats.dtype} {tuple(stats.shape)} on {stats.device}")
    else:
        _check(stats is None, f"the {body} backward computes its own row statistics; it takes no stats")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0 or k.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lib = _library()
    flags = (int(bool(causal)), int(window), int(q_offset), float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    if body == "wgmma":
        # TMA reads q, k, v and dout in place, 16 bytes at a time.
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, dout)), "wgmma backward: inputs must be 16-byte aligned")
        # Each row's m, 1 / l and D = rowsum(dO * O), written by the dQ kernel
        # for the dK/dV kernel (padded rows, so TMA can load them).
        rec = torch.empty(lib.flash_attention_bwd_wgmma_scratch(b, h, sq), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_bwd_wgmma_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), stats.data_ptr(),
            rec.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, kvh, hd, *flags)
        what = lib.flash_attention_bwd_wgmma_error_string
    elif body == "bf16x6":
        # The split reads q, k, v and dout 16 bytes at a time; o is read and
        # the gradients written 8 at a time.
        _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out, dout, dq, dk, dv)),
               "bf16x6 backward: inputs must be 16-byte aligned")
        # q, k, v and dout as bf16 planes, the row statistics and records.
        scratch = torch.empty(lib.flash_attention_bwd_bf16x6_scratch(b, sq, skv, h, kvh, hd), dtype=torch.uint8,
                              device=q.device)
        err = lib.flash_attention_bwd_bf16x6_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), scratch.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, sq, skv, h, kvh, hd, *flags)
        what = lib.flash_attention_bwd_wgmma_error_string
    else:
        scratch = torch.empty((3, b * h * sq), dtype=torch.float32, device=q.device)   # row max, row sum, D
        err = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), scratch.data_ptr(), b, sq, skv, h, kvh, hd, DTYPES[q.dtype], *flags)
        what = lib.flash_attention_bwd_error_string
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd ({body} body) launch failed: {what(err).decode()} (code {err})")
    bwd_launch_count += 1
    bwd_body_launch_count[body] += 1
    return dq, dk, dv
