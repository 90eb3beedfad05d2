"""Threefry-2x32 keys and draws, bit-equal to ``jax.random``.

Every link mask of the DI round is drawn from a ``jax.random`` key chain in
the reference; the port reproduces the same bits so that its masks, and so
its greedy tokens, match the reference token for token.

A key is an int64 tensor of shape ``(2,)`` holding two uint32 words.  All
uint32 arithmetic is done in int64 and masked with ``& 0xFFFFFFFF`` (torch
has no uint32 add on every device).  Draws run on the key's device.

``partitionable`` selects jax's ``jax_threefry_partitionable`` scheme for
``split`` and ``random_bits`` (the counter layout differs between the two);
``None`` means the default of the installed reference, ``DEFAULT_PARTITIONABLE``
(True, as on jax >= 0.5; jax 0.4.x defaults to False).
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
DEFAULT_PARTITIONABLE = True
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _resolve(partitionable: Optional[bool]) -> bool:
    return DEFAULT_PARTITIONABLE if partitionable is None else partitionable


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit ints: ``[0, seed mod 2**32]``."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def threefry2x32(k1, k2, x0: torch.Tensor, x1: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) on uint32 words in int64."""
    k1 = k1 & M32
    k2 = k2 & M32
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & M32
    x1 = (x1 + ks[1]) & M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) & M32) | (x1 >> (32 - r))
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def _words(key: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The two words of a key ``(2,)`` or a key stack ``(..., 2)``, shaped
    ``(..., 1)`` so they broadcast against a trailing counter axis."""
    return key[..., 0, None], key[..., 1, None]


def _threefry_2x32(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    """jax's ``threefry_2x32(keypair, count)``: hash a flat counter array by
    pairing its first half with its second half (zero-padded when odd).  A
    key stack ``(..., 2)`` hashes the counter under every key at once:
    ``(...,) + count.shape``."""
    flat = count.reshape(-1)
    n = flat.numel()
    if n % 2:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.numel() // 2
    o0, o1 = threefry2x32(*_words(key), flat[:half], flat[half:])
    out = torch.cat([o0, o1], dim=-1)
    return out[..., :n].reshape(key.shape[:-1] + count.shape)


def _iota_2x32(shape: Sequence[int], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-major linear index of ``shape`` as (high word, low word)."""
    idx = torch.arange(math.prod(shape), dtype=torch.int64, device=device).reshape(tuple(shape))
    return idx >> 32, idx & M32


def split(key: torch.Tensor, num: int = 2, *, partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> ``(num, 2)``.  A key stack ``(...,
    2)`` splits every key at once -> ``(..., num, 2)``, bit-equal to
    splitting each key alone (what ``vmap(jax.random.split)`` gives)."""
    if _resolve(partitionable):
        hi, lo = _iota_2x32((num,), key.device)
        b0, b1 = threefry2x32(*_words(key), hi, lo)
        return torch.stack([b0, b1], dim=-1)
    counts = torch.arange(2 * num, dtype=torch.int64, device=key.device)
    return _threefry_2x32(key, counts).reshape(key.shape[:-1] + (num, 2))


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` (the same in both schemes; a key
    stack folds ``data`` into every key)."""
    count = torch.tensor([0, int(data) & M32], dtype=torch.int64, device=key.device)
    return _threefry_2x32(key, count)


def random_bits(key: torch.Tensor, shape: Sequence[int] = (), *,
                partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int64 values in [0, 2**32).
    A key stack ``(..., 2)`` draws under every key at once -> ``(...) +
    shape``, bit-equal to each key's own draw (what ``vmap`` gives)."""
    shape = tuple(int(s) for s in shape)
    lead = tuple(key.shape[:-1])
    if _resolve(partitionable):
        hi, lo = _iota_2x32(shape, key.device)
        words = [key[..., j].reshape(lead + (1,) * len(shape)) for j in (0, 1)]
        b0, b1 = threefry2x32(*words, hi, lo)
        return b0 ^ b1
    size = math.prod(shape)
    counts = torch.arange(size, dtype=torch.int64, device=key.device)
    return _threefry_2x32(key, counts).reshape(lead + shape)


def uniform(key: torch.Tensor, shape: Sequence[int] = (), *, minval: float = 0.0, maxval: float = 1.0,
            partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, minval=minval, maxval=maxval)``,
    float32: the top 23 bits become the mantissa of a float f in [1, 2),
    minus 1, then ``max(minval, f * (maxval - minval) + minval)`` with the
    bounds rounded to f32, as jax converts them.  XLA fuses the multiply
    and the add (one rounding); the port forms them in f64, where the
    product of two f32s is exact, and rounds once to f32."""
    bits = random_bits(key, shape, partitionable=partitionable)
    one = (bits >> 9) | 0x3F800000
    f = one.to(torch.int32).view(torch.float32) - 1.0
    if minval == 0.0 and maxval == 1.0:
        return f     # f * 1 + 0, and max(0, f) = f: the same bits
    lo, hi = np.float32(minval), np.float32(maxval)
    scaled = (f.to(torch.float64) * float(hi - lo) + float(lo)).to(torch.float32)
    return torch.clamp(scaled, min=float(lo))


def gumbel(key: torch.Tensor, shape: Sequence[int] = (), *,
           partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape)`` in float32, its default "low"
    mode: ``-log(-log(u))`` with ``u`` uniform on [tiny, 1).  The uniforms
    are jax's bit for bit; the two logs are the device's (within an ulp of
    XLA's each)."""
    tiny = float(np.finfo(np.float32).tiny)
    u = uniform(key, shape, minval=tiny, maxval=1.0, partitionable=partitionable)
    return -torch.log(-torch.log(u))


def categorical(key: torch.Tensor, logits: torch.Tensor, *,
                partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` for float32 logits
    (the Gumbel-max trick): the argmax over the last axis of ``logits +
    gumbel(key, logits.shape)``, the first index on a tie, as int64.  A
    key stack ``(..., 2)`` samples each leading row under its own key (the
    reference's ``vmap(categorical)``): ``logits`` ``(...) + rest``."""
    g = gumbel(key, tuple(logits.shape[key.dim() - 1:]), partitionable=partitionable)
    return torch.argmax(g.to(logits.device) + logits, dim=-1)


def bernoulli(key: torch.Tensor, p, shape: Sequence[int] = (), *,
              partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < float32(p)``;
    ``p`` a Python number or a 0-d tensor (compared in f32)."""
    u = uniform(key, shape, partitionable=partitionable)
    if torch.is_tensor(p):
        return u < p.to(device=u.device, dtype=torch.float32)
    return u < float(np.float32(p))


def _mul32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """uint32 product mod 2**32 without int64 overflow."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int, *,
            partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` for int32 bounds
    that fit in int32, as an int32 tensor."""
    i32 = np.iinfo(np.int32)
    if not (i32.min <= minval <= i32.max and i32.min <= maxval <= i32.max):
        raise ValueError("randint: bounds must fit in int32")
    k1, k2 = split(key, partitionable=partitionable)
    higher = random_bits(k1, shape, partitionable=partitionable)
    lower = random_bits(k2, shape, partitionable=partitionable)
    span = (maxval - minval) & M32 if maxval > minval else 1
    multiplier = (2 ** 16) % span
    multiplier = (multiplier * multiplier & M32) % span
    mult = torch.tensor(multiplier, dtype=torch.int64, device=key.device)
    offset = (_mul32(higher % span, mult) + lower % span) & M32
    offset = offset % span
    out = (minval + offset) & M32
    return torch.where(out >= 2 ** 31, out - 2 ** 32, out).to(torch.int32)


def permutation(key: torch.Tensor, n: int, *, partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: jax's sort-based shuffle —
    ``ceil(3 ln n / ln(2**32 - 1))`` rounds, each a stable sort of
    ``arange`` by fresh 32-bit keys."""
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key, partitionable=partitionable)
        sort_keys = random_bits(sub, (n,), partitionable=partitionable)
        order = torch.sort(sort_keys, stable=True).indices
        x = x[order]
    return x
