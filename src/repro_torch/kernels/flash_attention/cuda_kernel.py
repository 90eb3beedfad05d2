"""ctypes binding and launch wrappers of the flash-attention forward and
backward bodies.

Every body runs on the tensor cores.  TMA and the 16-byte copies need rows
whose stride is a multiple of 16 bytes, so a head dim that is not a
multiple of 8 (hd 36, say) is zero-filled by the wrapper up to the next
multiple of 8 (``padded_head_dim``): q, k and v (and, for the backward, the
output and its gradient) are copied into zero-filled tensors of that width,
the body runs at it with the true hd's scale (``scale_hd``; zero columns
add exactly 0 to every product), and the true hd's columns come back.  The
copies count in the call's time.

``body_for`` picks the forward body from the dtype, the head dim and
whether the row statistics are asked for; nothing retries on another body:

* ``"wgmma"`` -- ``csrc/flash_attention_wgmma.cu``: bf16 at every head dim
  up to 256 (wgmma, K/V fed by TMA), built at widths 64, 128 and 256: a
  call runs at the first width >= the padded hd, the tensor maps
  zero-filling the columns past it; with ``return_stats`` it also writes
  each row's m and l;
* ``"tf32x3"`` -- ``csrc/flash_attention_tf32x3.cu``: f32 without
  statistics (serving: no gradient wanted), at every head dim up to 256,
  on the tensor cores (mma.sync) in error-compensated TF32: each operand
  split as hi + lo and hi*hi + hi*lo + lo*hi summed in f32, ~22 of f32's 24
  bits;
* ``"bf16x6"`` -- ``csrc/flash_attention_bf16x6.cu``: f32 with statistics
  (a gradient wanted) at head dims up to 128: each operand split into
  three bf16 planes and each product run as six bf16 wgmmas, f32 accuracy,
  with the row statistics formed by the backward's own arithmetic.

``flash_attention`` refuses inputs that require grad
(``runtime.forbid_grad``), checks device, dtype, shape, contiguity and
alignment, allocates the output (and any scratch) with ``torch.empty``,
launches on PyTorch's current stream and raises if the launch reports an
error.  ``launch_count`` counts its launches and nothing else, so a run
can show that it went through the kernel; ``body_launch_count`` splits the
same count by body.  Asked with ``return_stats=True`` it also returns each
row's max m (log2 units) and sum l, f32 ``(2, B * H * Sq)``, for the
backward.

``flash_attention_bwd`` takes the forward's inputs, its output and the
output's gradient and returns dQ, dK and dV, with the same checks and
guard.  ``bwd_body_for`` picks its body:

* ``"wgmma"`` -- ``csrc/flash_attention_bwd_wgmma.cu``: bf16 at every head
  dim up to 256 on the tensor cores (zero-filled as the forward); it reads
  the forward's ``stats`` (required) and runs two device kernels (dQ with
  D = rowsum(dO * O), then dK/dV summed over each KV head's group);
* ``"bf16x6"`` -- the same source on f32 at every head dim up to 256, at
  f32 accuracy: each operand split into three bf16 planes (hi, mid, lo)
  and each product run as six bf16 wgmmas.  Up to hd 128 it reads the
  bf16x6 forward's ``stats`` (required) and runs three device kernels (the
  split, dQ, dK/dV) over one scratch buffer; past hd 128 the planes do not
  fit the forward's shared memory, so it takes no ``stats``, forms its own
  (a statistics kernel after the split: four device kernels) and runs the
  gradients as 64-column slabs, each CTA keeping 128 of the 256 columns.

``bwd_reads_stats`` says which calls read the forward's statistics;
``dispatch.FlashAttentionFunction`` asks the forward for them then.
``bwd_launch_count`` counts the backward's calls, ``bwd_body_launch_count``
by body.  The CUDA-core bodies (``csrc/flash_attention.cu``,
``csrc/flash_attention_bwd.cu``, key ``"simt"``) are still built into the
library as timing baselines (``chip_smoke.py`` launches them directly); no
route reaches them, so their counts stay 0.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels import nvcc, runtime

LIB_NAME = "flash_attention"
_CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (_CSRC / "flash_attention.cu", _CSRC / "flash_attention_wgmma.cu", _CSRC / "flash_attention_tf32x3.cu",
           _CSRC / "flash_attention_bf16x6.cu", _CSRC / "flash_attention_bwd.cu",
           _CSRC / "flash_attention_bwd_wgmma.cu")
DTYPES = {torch.bfloat16: 1, torch.float32: 2}
MAX_HEAD_DIM = 256
BF16X6_MAX_HEAD_DIM = 128   # three planes of every tile fill the forward's shared memory past it
MAX_GRID_Y = 65535

launch_count: int = 0
body_launch_count: dict = {"wgmma": 0, "tf32x3": 0, "bf16x6": 0, "simt": 0}
bwd_launch_count: int = 0
bwd_body_launch_count: dict = {"wgmma": 0, "bf16x6": 0, "simt": 0}
_lib = None


def flash_attention_launch_count() -> int:
    return launch_count


def padded_head_dim(hd: int) -> int:
    """The width a call runs at: hd rounded up to a multiple of 8 (16-byte
    rows in bf16 and f32)."""
    return -(-hd // 8) * 8


def _check_route(dtype: torch.dtype, hd: int) -> None:
    _check(dtype in DTYPES, f"dtype {dtype} not one of {list(DTYPES)}")
    _check(1 <= hd <= MAX_HEAD_DIM, f"head_dim {hd} outside [1, {MAX_HEAD_DIM}]")


def body_for(dtype: torch.dtype, hd: int, *, stats: bool = False) -> str:
    """The forward body a call takes: ``"wgmma"`` for bf16; for f32
    ``"tf32x3"`` (serving, no statistics) or, asked for the row statistics,
    ``"bf16x6"`` up to hd 128.  Raises for what no body takes."""
    _check_route(dtype, hd)
    if dtype == torch.bfloat16:
        return "wgmma"
    if not stats:
        return "tf32x3"
    _check(padded_head_dim(hd) <= BF16X6_MAX_HEAD_DIM,
           f"no f32 forward body writes row statistics past hd {BF16X6_MAX_HEAD_DIM} (hd {hd})")
    return "bf16x6"


def bwd_body_for(dtype: torch.dtype, hd: int) -> str:
    """The backward body a call takes: ``"wgmma"`` for bf16, ``"bf16x6"``
    for f32 (both on the tensor cores).  Raises for what no body takes."""
    _check_route(dtype, hd)
    return "wgmma" if dtype == torch.bfloat16 else "bf16x6"


def bwd_reads_stats(dtype: torch.dtype, hd: int) -> bool:
    """Whether the backward reads the forward's row statistics: bf16 at
    every head dim, f32 up to hd 128 (past it the backward forms its own)."""
    return bwd_body_for(dtype, hd) == "wgmma" or padded_head_dim(hd) <= BF16X6_MAX_HEAD_DIM


def _words(*nbytes: int) -> torch.dtype:
    """The widest integer word (8, 4, 2 or 1 bytes) that divides every one of
    ``nbytes``."""
    return {8: torch.int64, 4: torch.int32, 2: torch.int16, 1: torch.uint8}[math.gcd(8, *nbytes)]


def _zero_fill(x: torch.Tensor, width: int) -> torch.Tensor:
    """x copied into a zero-filled tensor ``width`` columns wide (its last
    axis).  The rows are copied as whole integer words (a 72-byte row as nine
    8-byte words): a strided copy of 2-byte elements ran at ~0.8 TB/s."""
    words = _words(x.shape[-1] * x.element_size(), x.storage_offset() * x.element_size())
    out = x.new_empty((*x.shape[:-1], width))
    src, dst = x.view(words), out.view(words)
    dst[..., src.shape[-1]:].zero_()
    dst[..., :src.shape[-1]].copy_(src)
    return out


def _true_columns(x: torch.Tensor, hd: int) -> torch.Tensor:
    """The first ``hd`` columns of a freshly allocated x, contiguous, copied
    as whole words as ``_zero_fill`` copies them."""
    words = _words(hd * x.element_size())
    n = hd * x.element_size() // words.itemsize
    return x.view(words)[..., :n].contiguous().view(x.dtype)


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load_library(LIB_NAME, SOURCES)
        # The CUDA-core bodies, for direct timing launches only:
        # (q, k, v, out, B, Sq, Skv, H, KV, hd, dtype, causal, window, q_offset, softcap, stream)
        lib.flash_attention_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        # (q, k, v, o, dout, dq, dk, dv, stats, B, Sq, Skv, H, KV, hd, dtype, causal, window,
        #  q_offset, softcap, stream)
        lib.flash_attention_bwd_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        # The tensor-core bodies; hd is the width the operands are laid out at,
        # scale_hd the true head dim:
        # (q, k, v, out, stats, B, Sq, Skv, H, KV, hd, scale_hd, causal, window, q_offset, softcap, stream)
        lib.flash_attention_wgmma_launch.argtypes = (
            [ctypes.c_void_p] * 5 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        # (q, k, v, out, B, Sq, Skv, H, KV, hd, scale_hd, causal, window, q_offset, softcap, stream)
        lib.flash_attention_tf32x3_launch.argtypes = (
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        # (q, k, v, out, stats, scratch, B, Sq, Skv, H, KV, hd, scale_hd, causal, window, q_offset,
        #  softcap, stream)
        lib.flash_attention_bf16x6_launch.argtypes = (
            [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bf16x6_scratch.argtypes = [ctypes.c_int] * 6
        lib.flash_attention_bf16x6_scratch.restype = ctypes.c_longlong
        # (q, k, v, o, dout, stats, rec, dq, dk, dv, B, Sq, Skv, H, KV, hd, scale_hd, causal, window,
        #  q_offset, softcap, stream)
        lib.flash_attention_bwd_wgmma_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bwd_wgmma_scratch.argtypes = [ctypes.c_int] * 3
        lib.flash_attention_bwd_wgmma_scratch.restype = ctypes.c_longlong
        # (q, k, v, o, dout, stats, scratch, dq, dk, dv, B, Sq, Skv, H, KV, hd, scale_hd, causal, window,
        #  q_offset, softcap, stream)
        lib.flash_attention_bwd_bf16x6_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_attention_bwd_bf16x6_scratch.argtypes = [ctypes.c_int] * 6
        lib.flash_attention_bwd_bf16x6_scratch.restype = ctypes.c_longlong
        for fn in (lib.flash_attention_launch, lib.flash_attention_wgmma_launch, lib.flash_attention_tf32x3_launch,
                   lib.flash_attention_bf16x6_launch, lib.flash_attention_bwd_launch,
                   lib.flash_attention_bwd_wgmma_launch, lib.flash_attention_bwd_bf16x6_launch):
            fn.restype = ctypes.c_int
        for fn in (lib.flash_attention_error_string, lib.flash_attention_wgmma_error_string,
                   lib.flash_attention_tf32x3_error_string, lib.flash_attention_bf16x6_error_string,
                   lib.flash_attention_bwd_error_string, lib.flash_attention_bwd_wgmma_error_string):
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
    (B, Sq, H, hd) in q's dtype; with ``return_stats`` also the rows' m
    and l for ``flash_attention_bwd`` (bf16 at any hd, f32 up to hd 128:
    the bf16x6 body)."""
    global launch_count
    runtime.forbid_grad("flash_attention", q, k, v)
    _check_inputs(q, k, v, q_offset=q_offset, window=window)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    body = body_for(q.dtype, hd, stats=return_stats)
    stats = torch.empty((2, b * h * sq), dtype=torch.float32, device=q.device) if return_stats else None
    if q.numel() == 0:
        out = torch.empty_like(q)
        return (out, stats) if return_stats else out
    width = padded_head_dim(hd)
    if width != hd:
        q, k, v = (_zero_fill(t, width) for t in (q, k, v))
    out = torch.empty_like(q)
    # TMA / cp.async read the tensors in place, 16 bytes at a time.
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out)), f"{body} body: inputs must be 16-byte aligned")
    lib = _library()
    dims = (b, sq, skv, h, kvh, width, hd)
    flags = (int(bool(causal)), int(window), int(q_offset), float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if body == "wgmma":
        err = lib.flash_attention_wgmma_launch(*ptrs, None if stats is None else stats.data_ptr(), *dims, *flags)
        what = lib.flash_attention_wgmma_error_string
    elif body == "tf32x3":
        err = lib.flash_attention_tf32x3_launch(*ptrs, *dims, *flags)
        what = lib.flash_attention_tf32x3_error_string
    else:
        # q, k and v as three bf16 planes each.
        scratch = torch.empty(lib.flash_attention_bf16x6_scratch(b, sq, skv, h, kvh, width), dtype=torch.uint8,
                              device=q.device)
        err = lib.flash_attention_bf16x6_launch(*ptrs, stats.data_ptr(), scratch.data_ptr(), *dims, *flags)
        what = lib.flash_attention_bf16x6_error_string
    if err != 0:
        raise RuntimeError(f"flash_attention ({body} body) launch failed: {what(err).decode()} (code {err})")
    launch_count += 1
    body_launch_count[body] += 1
    if width != hd:
        out = _true_columns(out, hd)
    return (out, stats) if return_stats else out


def flash_attention_bwd(
    q: torch.Tensor,          # (B, Sq, H, hd) bf16/f32
    k: torch.Tensor,          # (B, Skv, KV, hd)
    v: torch.Tensor,
    out: torch.Tensor,        # (B, Sq, H, hd): the forward's output
    dout: torch.Tensor,       # (B, Sq, H, hd): its gradient
    *,
    stats: torch.Tensor | None = None,   # (2, B * H * Sq) f32: the forward's m and l
    causal: bool = True,
    window: int = 0,
    q_offset: int = 0,
    softcap: float = 0.0,
):
    """dQ, dK and dV of ``flash_attention`` on the card, each in q's dtype;
    dK and dV of KV head ``kv`` sum over its query heads in the kernel.
    Where ``bwd_reads_stats`` (bf16; f32 up to hd 128) it needs the
    forward's ``stats``; past that it takes none."""
    global bwd_launch_count
    runtime.forbid_grad("flash_attention_bwd", q, k, v, out, dout)
    _check_inputs(q, k, v, out, dout, q_offset=q_offset, window=window)
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    body = bwd_body_for(q.dtype, hd)
    if bwd_reads_stats(q.dtype, hd):
        _check(stats is not None, f"the {body} backward at hd {hd} reads the forward's row statistics: pass "
                                  "stats= from flash_attention(..., return_stats=True)")
        _check(stats.device == q.device and stats.dtype == torch.float32 and stats.is_contiguous()
               and tuple(stats.shape) == (2, b * h * sq), f"stats must be contiguous f32 (2, {b * h * sq}) on "
               f"{q.device}, got {stats.dtype} {tuple(stats.shape)} on {stats.device}")
    else:
        _check(stats is None, f"the {body} backward at hd {hd} computes its own row statistics; it takes no stats")
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    width = padded_head_dim(hd)
    if width != hd:
        q, k, v, out, dout = (_zero_fill(t, width) for t in (q, k, v, out, dout))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # TMA reads q, k, v and dout in place, 16 bytes at a time; the f32 split
    # reads them 16 bytes at a time too, o 8 at a time, and writes the
    # gradients 8 at a time.
    _check(all(t.data_ptr() % 16 == 0 for t in (q, k, v, out, dout, dq, dk, dv)),
           f"{body} backward: inputs must be 16-byte aligned")
    lib = _library()
    dims = (b, sq, skv, h, kvh, width, hd)
    flags = (int(bool(causal)), int(window), int(q_offset), float(softcap),
             torch.cuda.current_stream(q.device).cuda_stream)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
            None if stats is None else stats.data_ptr())
    grads = (dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    if body == "wgmma":
        # Each row's m, 1 / l and D = rowsum(dO * O), written by the dQ kernel
        # for the dK/dV kernel (padded rows, so TMA can load them).
        rec = torch.empty(lib.flash_attention_bwd_wgmma_scratch(b, h, sq), dtype=torch.float32, device=q.device)
        err = lib.flash_attention_bwd_wgmma_launch(*ptrs, rec.data_ptr(), *grads, *dims, *flags)
    else:
        # q, k, v and dout as bf16 planes, the row statistics and records.
        scratch = torch.empty(lib.flash_attention_bwd_bf16x6_scratch(b, sq, skv, h, kvh, width), dtype=torch.uint8,
                              device=q.device)
        err = lib.flash_attention_bwd_bf16x6_launch(*ptrs, scratch.data_ptr(), *grads, *dims, *flags)
    if err != 0:
        what = lib.flash_attention_bwd_wgmma_error_string(err).decode()
        raise RuntimeError(f"flash_attention_bwd ({body} body) launch failed: {what} (code {err})")
    bwd_launch_count += 1
    bwd_body_launch_count[body] += 1
    if width != hd:
        dq, dk, dv = (_true_columns(g, hd) for g in (dq, dk, dv))
    return dq, dk, dv
