"""Plain PyTorch split-point link kernels: the port's twin of
``repro/kernels/lossy_link/ref.py``.

``lossy_link_egress_ref`` mirrors the reference op for op in f32: clip
(``minimum(maximum(x, s_min), s_max)``), ``round((c - s_min) / rng *
levels)`` (half to even), ``code / levels * rng + s_min``, keep where ``u
>= p``, scale by ``comp``, cast to x's dtype.  The scalars are fixed on the
host as the reference fixes them (``egress_constants``).  ``levels`` is a
0-d tensor on x's device, not a Python float: PyTorch's CUDA division by a
host scalar multiplies by its reciprocal, which can differ from ``/`` in
the last bit, and the kernel divides.

``lossy_link_egress_keyed_ref`` is the function the CUDA egress computes:
the draw ``prng.uniform(key, (T, D))``, then ``lossy_link_egress_ref`` on
it (the reference's ``ops.lossy_link_egress`` on a flat activation).

``burst_mask_ref`` defers to the port's Gilbert–Elliott scan, as the
reference's defers to its own.  Both are the CPU path of ``dispatch`` and
the plain versions the CUDA kernels are held against, bit for bit, on the
card.

``burst_mask_scan_ref`` is the plain version of the CUDA burst mask's own
arithmetic (a warp scan of per-packet state maps, ``csrc/lossy_link.cu``):
the tests hold it to ``burst_mask_ref`` bit for bit; nothing else calls it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import prng
from repro_torch.net.channels import gilbert_elliott_scan


def f32(value: float) -> float:
    """``value`` rounded to float32, as a Python float."""
    return float(np.float32(value))


def egress_constants(bits: int, loss_rate: float) -> Tuple[float, float, float, float]:
    """``(levels, p, comp, rng_floor)`` as the reference fixes them: worked
    out in Python double, then rounded to f32."""
    comp = 1.0 / max(1.0 - float(loss_rate), 1e-6) if loss_rate > 0.0 else 1.0
    return f32(2 ** bits - 1), f32(loss_rate), f32(comp), f32(1e-8)


def lossy_link_egress_ref(x: torch.Tensor, u: torch.Tensor, s_min: torch.Tensor, s_max: torch.Tensor, *,
                          bits: int, loss_rate: float) -> torch.Tensor:
    """Quantize -> keep if ``u >= p`` -> dequantize -> ``1/(1-p)``, per
    element of ``x`` (T, D) f32/bf16; ``u`` (T, D) f32; ``s_min``, ``s_max``
    (D,).  Returns x's dtype."""
    levels, p, comp, rng_floor = egress_constants(bits, loss_rate)
    lv = torch.full((), levels, dtype=torch.float32, device=x.device)
    s_min, s_max = s_min.float(), s_max.float()
    rng = torch.clamp(s_max - s_min, min=rng_floor)
    clipped = torch.minimum(torch.maximum(x.float(), s_min), s_max)
    code = torch.round((clipped - s_min) / rng * lv)
    deq = code / lv * rng + s_min
    keep = u.float() >= p
    return torch.where(keep, deq * comp, 0.0).to(x.dtype)


def lossy_link_egress_keyed_ref(key: torch.Tensor, x: torch.Tensor, s_min: torch.Tensor, s_max: torch.Tensor, *,
                                bits: int, loss_rate: float) -> torch.Tensor:
    """``lossy_link_egress_ref`` on ``u = prng.uniform(key, (T, D))``: the
    fused kernel's function of ``(key, x)``, x (T, D)."""
    u = prng.uniform(key, tuple(x.shape))
    return lossy_link_egress_ref(x, u, s_min, s_max, bits=bits, loss_rate=loss_rate)


def burst_mask_ref(u_init: torch.Tensor, u_loss: torch.Tensor, u_tr: torch.Tensor, *,
                   p_gb: float, p_bg: float, loss_good: float, loss_bad: float) -> torch.Tensor:
    """(R, N) f32 0/1 Gilbert–Elliott packet keep masks from ``u_init`` (R,)
    and ``u_loss``, ``u_tr`` (R, N): one independent chain per row."""
    return gilbert_elliott_scan(u_init.float(), u_loss.float(), u_tr.float(), p_gb, p_bg, loss_good, loss_bad)


BURST_TILE = 256     # packets a warp stages per pass (lossy_link.cu kBurstTile)
WARP = 32            # lanes a warp: one contiguous chunk of a tile each
IDENTITY = 0b10      # the map G -> G, B -> B


def _then(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Map ``f`` followed by map ``g``; a map {G,B} -> {G,B} is 2 bits, bit 0
    the image of G and bit 1 the image of B (1 = bad)."""
    return ((g >> (f & 1)) & 1) | (((g >> ((f >> 1) & 1)) & 1) << 1)


def burst_mask_scan_ref(u_init: torch.Tensor, u_loss: torch.Tensor, u_tr: torch.Tensor, *,
                        p_gb: float, p_bg: float, loss_good: float, loss_bad: float) -> torch.Tensor:
    """:func:`burst_mask_ref` computed as the CUDA kernel computes it.  Per
    tile of ``BURST_TILE`` packets: each of 32 lanes folds its contiguous
    chunk of ``ceil(cols / 32)`` per-packet maps (``bad' = bad ? u_tr >=
    p_bg : u_tr < p_gb``) into one map; an inclusive scan of the lanes' maps
    in 5 ``shfl_up`` steps, applied to the state entering the tile, gives
    the state entering each chunk and, from lane 31, the next tile; each
    lane walks its chunk again from there, keeping a packet if ``u_loss >=
    loss_{good,bad}``."""
    r, n = u_loss.shape
    pi_b = p_gb / max(p_gb + p_bg, 1e-12)
    keep_good = (u_loss >= f32(loss_good)).long()
    keep_bad = (u_loss >= f32(loss_bad)).long()
    maps = (u_tr < f32(p_gb)).long() | ((u_tr >= f32(p_bg)).long() << 1)
    bad = (u_init < f32(pi_b)).long()                                     # (R,)
    lane = torch.arange(WARP, device=u_loss.device)
    out = torch.empty((r, n), dtype=torch.float32, device=u_loss.device)
    for t0 in range(0, n, BURST_TILE):
        cols = min(BURST_TILE, n - t0)
        chunk = -(-cols // WARP)
        lanes = lambda a, fill: F.pad(a[:, t0:t0 + cols], (0, WARP * chunk - cols), value=fill).reshape(
            r, WARP, chunk)
        tile_maps, kg, kb = lanes(maps, IDENTITY), lanes(keep_good, 0), lanes(keep_bad, 0)
        m = torch.full((r, WARP), IDENTITY, dtype=torch.long, device=u_loss.device)
        for i in range(chunk):
            m = _then(m, tile_maps[:, :, i])
        for o in (1, 2, 4, 8, 16):
            prev = torch.cat([m[:, :o], m[:, :-o]], dim=1)                # shfl_up: lane l reads l - o
            m = torch.where(lane >= o, _then(prev, m), m)
        before = torch.cat([torch.full((r, 1), IDENTITY, dtype=torch.long, device=m.device), m[:, :-1]], dim=1)
        s = (before >> bad[:, None]) & 1                                  # (R, 32) state entering each chunk
        keep = torch.empty((r, WARP, chunk), dtype=torch.long, device=m.device)
        for i in range(chunk):
            step = tile_maps[:, :, i]
            keep[:, :, i] = torch.where(s == 1, kb[:, :, i], kg[:, :, i])
            s = torch.where(s == 1, (step >> 1) & 1, step & 1)
        out[:, t0:t0 + cols] = keep.reshape(r, WARP * chunk)[:, :cols].float()
        bad = (m[:, -1] >> bad) & 1
    return out
