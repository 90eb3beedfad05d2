"""ctypes binding and launch wrappers of ``csrc/flash_decode.cu``.

The library is built with ``nvcc`` at first use (``kernels/nvcc.py``).
``flash_decode`` (contiguous cache) and ``paged_flash_decode`` (block pool
and table) run one split-KV body, which differs between them only in how a
logical row becomes a cache row, at head dims 64, 112 (kimi-k2), 128 and
256.  Each wrapper refuses inputs that require
grad (``runtime.forbid_grad``), checks device, dtype, shape, contiguity and
alignment, allocates the output (and the split scratch) with
``torch.empty``, launches on PyTorch's current stream and raises if a
launch reports an error.  ``launch_count`` and ``paged_launch_count`` count
each wrapper's calls and nothing else, so a run can show that it went
through the kernels.

Both split the logical rows across blocks as ``decode_plan`` says, the
same plan for a contiguous cache of C rows and a table of J * bs rows:
with one split a call launches one kernel; with more it launches the split
kernel and the merge, two device kernels for one call (one count).

Context-parallel decode (a KV sequence split over ranks) runs the body
and a merge apart: ``flash_decode_partials`` (``partials_launch_count``)
runs the split kernel over a rank's rows, its splits planned by those rows,
and folds the splits' partials on the rank (in the same launch) into one
f32 entry a row (m, l and the unnormalised sums); ``merge_decode_partials``
(``merge_launch_count``) merges the entries the ranks' all-gather delivers,
with a rank stride, into the output (its own kernel, not the one-call
merge).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import nvcc, runtime
from repro_torch.kernels.decode_attention.torch_ref import split_rows

LIB_NAME = "flash_decode"
# flash_decode.cu builds the body at hd 64 / 128 / 256, flash_decode_hd112.cu
# at hd 112 (its own unit, so that the other head dims keep their code),
# flash_decode_partials.cu the partial entry point's body (a unit of its own
# for the same reason).
SOURCES = tuple(Path(__file__).resolve().parent / "csrc" / name
                for name in ("flash_decode.cu", "flash_decode_hd112.cu", "flash_decode_partials.cu"))
HEAD_DIMS = (64, 112, 128, 256)   # 112: kimi-k2, idle lanes past the row (flash_decode.cuh SplitShape)
MAX_GROUP = 16
CACHE_TYPES = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}
Q_TYPES = {torch.bfloat16: 1, torch.float32: 2}
INT32_MAX = 2 ** 31 - 1
SPLIT_MIN_ROWS = 64          # a split walks a multiple of this many cache rows
SPLIT_FROM_ROWS = 256        # a request addressing fewer rows is one split
RESIDENT_BLOCKS_PER_SM = 2   # the blocks of one wave: SMs x this
H100_SMS = 132

launch_count: int = 0
paged_launch_count: int = 0
partials_launch_count: int = 0
merge_launch_count: int = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = nvcc.load_library(LIB_NAME, SOURCES)
        lib.flash_decode_launch.argtypes = (
            [ctypes.c_void_p] * 9 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        lib.paged_flash_decode_launch.argtypes = (
            [ctypes.c_void_p] * 10 + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_void_p])
        lib.flash_decode_partials_launch.argtypes = (
            [ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float, ctypes.c_void_p])
        lib.merge_decode_partials_launch.argtypes = (
            [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_longlong, ctypes.c_void_p])
        for fn in (lib.flash_decode_launch, lib.paged_flash_decode_launch, lib.flash_decode_partials_launch,
                   lib.merge_decode_partials_launch):
            fn.restype = ctypes.c_int
        lib.flash_decode_error_string.argtypes = [ctypes.c_int]
        lib.flash_decode_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"flash_decode: {msg}")


def group_tile(g: int) -> int:
    """Query heads a split block serves (the kernel's GT): G itself for G 1
    and 2, else 4."""
    return g if g <= 2 else 4


def split_plan(blocks: int, rows: int, sms: int = H100_SMS) -> int:
    """Splits of a decode call: about enough that ``blocks * nsplit`` fills
    one wave (``sms * RESIDENT_BLOCKS_PER_SM`` blocks), with each split a
    multiple of ``SPLIT_MIN_ROWS`` of the ``rows`` a request can address (a
    block walks 64 rows a step at hd 64).  ``blocks`` is B x KV x G tiles.
    Fewer than ``SPLIT_FROM_ROWS`` rows stay in one split: one block walks
    them in at most four steps, sooner than two splits and the merge kernel
    take (``PERF.md`` section 6: the engine's 160 rows, one split against
    two).  A split that starts past a request's ``n_valid`` sees no row and
    merges to nothing."""
    if rows < SPLIT_FROM_ROWS:
        return 1
    most = rows // SPLIT_MIN_ROWS
    want = max(1, min(most, -(-sms * RESIDENT_BLOCKS_PER_SM // max(1, blocks))))
    per = SPLIT_MIN_ROWS * -(-rows // (SPLIT_MIN_ROWS * want))
    return -(-rows // per)


def decode_plan(b: int, kvh: int, g: int, c: int, sms: int = H100_SMS) -> dict:
    """What a call of this shape launches: splits, rows a split, and device
    kernels a call (2 with the merge).  ``c`` is the logical rows a request
    addresses: the contiguous cache's C, or the paged table's J * bs."""
    nsplit = split_plan(b * kvh * -(-g // group_tile(g)), c, sms)
    return dict(nsplit=nsplit, rows_per_split=split_rows(c, nsplit), kernels=1 if nsplit == 1 else 2)


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check_contiguous_call(q, k, v, k_scale, v_scale, n_valid) -> None:
    b, kvh, g, hd = q.shape
    c = k.shape[1]
    tensors = [q, k, v, n_valid] + ([k_scale, v_scale] if k_scale is not None else [])
    _check_common(q, k, v, tensors)
    _check(tuple(k.shape) == (b, c, kvh, hd) and tuple(v.shape) == (b, c, kvh, hd),
           f"cache shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    _check(n_valid.dtype == torch.int32 and tuple(n_valid.shape) == (b,), "n_valid must be (B,) int32")
    _check_scales(k, k_scale, v_scale, (b, c, kvh))


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
    """Length-masked decode attention on the card, the cache split across
    blocks as ``decode_plan`` says; returns (B, KV, G, hd) in q's dtype."""
    global launch_count
    runtime.forbid_grad("flash_decode", q, k, v, k_scale, v_scale)
    b, kvh, g, hd = q.shape
    c = k.shape[1]
    _check_contiguous_call(q, k, v, k_scale, v_scale, n_valid)
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan, scratch = _split(q, c)
    quantized = k_scale is not None
    err = _library().flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        n_valid.data_ptr(), out.data_ptr(), *_ptrs(scratch),
        b, c, kvh, g, hd, CACHE_TYPES[k.dtype], Q_TYPES[q.dtype], plan["nsplit"], plan["rows_per_split"],
        float(softcap), _stream(q),
    )
    _raise_on(err, "flash_decode")
    launch_count += 1
    return out


def flash_decode_partials(
    q: torch.Tensor,                     # (B, KV, G, hd) bf16/f32
    k: torch.Tensor,                     # (B, C_r, KV, hd) int8/bf16/f32: this rank's rows
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],     # (B, C_r, KV) bf16, int8 caches only
    v_scale: Optional[torch.Tensor],
    n_valid: torch.Tensor,               # (B,) int32: valid rows among this rank's
    *,
    softcap: float = 0.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """A rank's flash-decode partial on the card: the split kernel over
    its ``C_r`` rows, planned by ``decode_plan`` on those rows, its splits'
    partials folded on the rank, in the same launch, into one unnormalised
    entry a row (``M = max m_s``, ``l = sum l_s e^(m_s - M)``, ``acc = sum
    acc_s e^(m_s - M)`` in split order, ``m = M``).  Returns ``acc`` (B,
    KV, G, 1, hd) and ``ml`` (B, KV, G, 1, 2), (m, l), views of one flat
    buffer, ``acc`` first (:func:`partials_buffer`), so that one all-gather
    moves both: the CPU's layout.  A row with no valid row holds m =
    -1e30, l = 0, acc = 0.  The splits' scratch follows the entries in
    the same allocation; the fold's arrival counters are the library's,
    one set a device, so calls on a device run on one stream at a time."""
    global partials_launch_count
    runtime.forbid_grad("flash_decode_partials", q, k, v, k_scale, v_scale)
    b, kvh, g, hd = q.shape
    c = k.shape[1]
    _check_contiguous_call(q, k, v, k_scale, v_scale, n_valid)
    plan = decode_plan(b, kvh, g, c, _sms(q.device.index))
    nsplit = plan["nsplit"]
    n_entry = b * kvh * g * (hd + 2)
    buf = torch.empty((n_entry * (1 + nsplit if nsplit > 1 else 1),), dtype=torch.float32, device=q.device)
    acc, ml = split_partials(buf[:n_entry], (b, kvh, g, 1), hd)
    if n_entry == 0:
        return acc, ml
    quantized = k_scale is not None
    err = _library().flash_decode_partials_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        n_valid.data_ptr(), acc.data_ptr(), ml.data_ptr(),
        b, c, kvh, g, hd, CACHE_TYPES[k.dtype], Q_TYPES[q.dtype], nsplit, plan["rows_per_split"],
        float(softcap), _stream(q),
    )
    _raise_on(err, "flash_decode_partials")
    partials_launch_count += 1
    return acc, ml


def merge_decode_partials(acc: torch.Tensor, ml: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The cross-rank merge on the card: ``acc`` (R, B, KV, G, S, hd) and
    ``ml`` (R, B, KV, G, S, 2) f32 (or without R: one rank), each rank's
    block contiguous and both at one rank stride (the views
    :func:`split_partials` makes of an all-gather's ``(R, n)`` output),
    merged over the R x S entries in rank order (S is 1 from
    :func:`flash_decode_partials`; any S is taken); returns (B, KV, G, hd)
    in ``dtype``."""
    global merge_launch_count
    runtime.forbid_grad("merge_decode_partials", acc, ml)
    if acc.dim() == 5:
        acc, ml = acc[None], ml[None]
    _check(acc.dim() == 6 and tuple(ml.shape) == tuple(acc.shape[:5]) + (2,),
           f"partials {tuple(acc.shape)} / {tuple(ml.shape)}")
    r, b, kvh, g, s, hd = acc.shape
    _check(acc.is_cuda and ml.device == acc.device, "the partials must be on one CUDA device")
    _check(acc.dtype == torch.float32 and ml.dtype == torch.float32, "the partials are f32")
    _check(acc[0].is_contiguous() and ml[0].is_contiguous(), "each rank's partials must be contiguous")
    _check(r == 1 or acc.stride(0) == ml.stride(0), "acc and ml must share the rank stride")
    _check(dtype in Q_TYPES and hd in HEAD_DIMS, f"output dtype {dtype} / head_dim {hd} unsupported")
    out = torch.empty((b, kvh, g, hd), dtype=dtype, device=acc.device)
    if out.numel() == 0:
        return out
    _check(s >= 1 and r * s <= INT32_MAX, f"{r} x {s} splits")
    err = _library().merge_decode_partials_launch(
        acc.data_ptr(), ml.data_ptr(), out.data_ptr(), b * kvh * g, hd, Q_TYPES[dtype], s, r,
        acc.stride(0) if r > 1 else 0, _stream(acc))
    _raise_on(err, "merge_decode_partials")
    merge_launch_count += 1
    return out


def split_partials(buf: torch.Tensor, lead: Tuple[int, ...], hd: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(acc, ml)`` views of a partial buffer whose last dim holds one
    rank's ``acc`` (lead + (hd,)) then its ``ml`` (lead + (2,)): a flat
    buffer, or the all-gathered ``(R, n)`` one (then each gets a leading
    R dim)."""
    n_acc = int(torch.Size(lead).numel()) * hd
    rank = tuple(buf.shape[:-1])
    return (buf[..., :n_acc].view(rank + tuple(lead) + (hd,)),
            buf[..., n_acc:].view(rank + tuple(lead) + (2,)))


def paged_flash_decode(
    q: torch.Tensor,                     # (B, KV, G, hd) bf16/f32
    k: torch.Tensor,                     # (N, bs, KV, hd) int8/bf16/f32 block pool
    v: torch.Tensor,
    k_scale: Optional[torch.Tensor],     # (N, bs, KV) bf16, int8 pools only
    v_scale: Optional[torch.Tensor],
    block_table: torch.Tensor,           # (B, J) int32 pool block ids in [0, N)
    n_valid: torch.Tensor,               # (B,) int32
    *,
    softcap: float = 0.0,
) -> torch.Tensor:
    """Length-masked decode attention over a shared block pool, walked
    through each request's block-table row, on the card, its J * bs
    logical rows split across blocks as ``decode_plan`` says; returns (B,
    KV, G, hd) in q's dtype.  Rows past ``J * bs`` are never read.  The
    block ids are not checked (that would need a device sync): the caller
    keeps them in ``[0, N)``."""
    global paged_launch_count
    runtime.forbid_grad("paged_flash_decode", q, k, v, k_scale, v_scale)
    b, kvh, g, hd = q.shape
    nblk, bs = k.shape[:2]
    tensors = [q, k, v, block_table, n_valid] + ([k_scale, v_scale] if k_scale is not None else [])
    _check_common(q, k, v, tensors)
    _check(tuple(k.shape) == (nblk, bs, kvh, hd) and tuple(v.shape) == (nblk, bs, kvh, hd),
           f"pool shape {tuple(k.shape)} vs q {tuple(q.shape)}")
    _check(block_table.dtype == torch.int32 and block_table.dim() == 2 and block_table.shape[0] == b
           and block_table.shape[1] >= 1, "block_table must be (B, J) int32 with J >= 1")
    j = block_table.shape[1]
    _check(j * bs <= INT32_MAX, f"table of {j} blocks of {bs} rows is too long")
    _check(n_valid.dtype == torch.int32 and tuple(n_valid.shape) == (b,), "n_valid must be (B,) int32")
    _check_scales(k, k_scale, v_scale, (nblk, bs, kvh))
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    plan, scratch = _split(q, j * bs)
    quantized = k_scale is not None
    err = _library().paged_flash_decode_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        k_scale.data_ptr() if quantized else None, v_scale.data_ptr() if quantized else None,
        block_table.data_ptr(), n_valid.data_ptr(), out.data_ptr(), *_ptrs(scratch),
        b, bs, j, kvh, g, hd, CACHE_TYPES[k.dtype], Q_TYPES[q.dtype], plan["nsplit"], plan["rows_per_split"],
        float(softcap), _stream(q),
    )
    _raise_on(err, "paged_flash_decode")
    paged_launch_count += 1
    return out


def _check_common(q, k, v, tensors) -> None:
    _check(all(t.is_cuda and t.device == q.device for t in tensors), "all inputs must be on one CUDA device")
    _check(all(t.is_contiguous() for t in tensors), "inputs must be contiguous")
    _check(q.dtype in Q_TYPES, f"q dtype {q.dtype} not in {list(Q_TYPES)}")
    _check(k.dtype in CACHE_TYPES and v.dtype == k.dtype, f"cache dtype {k.dtype}/{v.dtype}")
    _check(q.shape[-1] in HEAD_DIMS and 1 <= q.shape[2] <= MAX_GROUP,
           f"head_dim {q.shape[-1]} / group {q.shape[2]} unsupported")
    # The body reads each cache row with 16-byte loads.
    _check(k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0, "k and v must be 16-byte aligned")


def _split(q: torch.Tensor, rows: int):
    """The plan of a call over ``rows`` logical rows a request, and its
    scratch: (part_acc, part_ml) f32, or () with one split."""
    b, kvh, g, hd = q.shape
    plan = decode_plan(b, kvh, g, rows, _sms(q.device.index))
    nsplit = plan["nsplit"]
    if nsplit == 1:
        return plan, ()
    return plan, (torch.empty((b * kvh * g * nsplit * hd,), dtype=torch.float32, device=q.device),
                  torch.empty((b * kvh * g * nsplit * 2,), dtype=torch.float32, device=q.device))


def _ptrs(scratch) -> tuple:
    return tuple(t.data_ptr() for t in scratch) if scratch else (None, None)


def _check_scales(k, k_scale, v_scale, shape) -> None:
    quantized = k.dtype == torch.int8
    _check(quantized == (k_scale is not None) == (v_scale is not None), "scales go with int8 caches only")
    if quantized:
        _check(k_scale.dtype == torch.bfloat16 and v_scale.dtype == torch.bfloat16
               and tuple(k_scale.shape) == shape and tuple(v_scale.shape) == shape,
               f"scales must be {shape} bf16")


def _stream(q: torch.Tensor) -> int:
    return torch.cuda.current_stream(q.device).cuda_stream


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: {_library().flash_decode_error_string(err).decode()} "
                           f"(code {err})")
