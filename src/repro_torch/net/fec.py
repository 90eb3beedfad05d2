"""Packet-level forward error correction (erasure coding), the port's twin
of ``repro/net/fec.py``.

Two codes over blocks of ``k`` data packets + ``m`` parity packets:

* ``kind="xor"``: one parity packet (m = 1), the XOR of the k data packets;
  recovers any one erasure;
* ``kind="rs"``: Cauchy-matrix Reed–Solomon over GF(256); any k of the
  k + m packets reconstruct the block exactly (MDS).

Payloads are byte arrays (numpy, as the reference's); ``encode_floats`` /
``decode_floats`` view float32 payloads as bytes, bit-exactly.

On the train and serve paths the decoder is replaced by its
*channel-equivalent mask* (``fec_element_keep``, on torch tensors on the
key's device): a block with at most m erasures is fully recovered,
otherwise only its surviving data packets are kept.  The mask carries no
gradient, so the fine-tuning graph is identity on it.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.link import element_mask_from_packets, log_binom_coeff
from repro_torch.obs import device as obs_device

# ---------------------------------------------------------------------------
# GF(256) arithmetic (Reed-Solomon polynomial 0x11D, generator 2)
# ---------------------------------------------------------------------------

_GF_EXP = np.zeros(512, dtype=np.int32)
_GF_LOG = np.zeros(256, dtype=np.int32)


def _build_tables() -> None:
    x = 1
    for i in range(255):
        _GF_EXP[i] = x
        _GF_LOG[x] = i
        x <<= 1
        if x & 0x100:
            x ^= 0x11D  # x^8+x^4+x^3+x^2+1: 2 generates the full group
    _GF_EXP[255:510] = _GF_EXP[:255]


_build_tables()


def gf_mul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Element-wise GF(256) multiply (arrays of uint8/int)."""
    a = np.asarray(a, dtype=np.int32)
    b = np.asarray(b, dtype=np.int32)
    out = _GF_EXP[(_GF_LOG[a] + _GF_LOG[b]) % 255]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def gf_inv(a: int) -> int:
    assert a != 0, "GF(256) inverse of zero"
    return int(_GF_EXP[255 - _GF_LOG[a]])


def gf_matmul(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """(r, k) GF matrix times (k, L) byte payloads -> (r, L)."""
    r, k = m.shape
    out = np.zeros((r, v.shape[1]), dtype=np.uint8)
    for i in range(r):
        acc = np.zeros(v.shape[1], dtype=np.uint8)
        for j in range(k):
            acc ^= gf_mul(np.full(v.shape[1], m[i, j], np.uint8), v[j])
        out[i] = acc
    return out


def gf_solve(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Solve A x = B over GF(256); A (k, k), B (k, L), by Gaussian
    elimination with XOR row operations."""
    k = a.shape[0]
    a = a.astype(np.uint8).copy()
    b = b.astype(np.uint8).copy()
    for col in range(k):
        piv = next((r for r in range(col, k) if a[r, col] != 0), None)
        assert piv is not None, "singular GF system (non-MDS selection?)"
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            b[[col, piv]] = b[[piv, col]]
        inv = gf_inv(int(a[col, col]))
        a[col] = gf_mul(a[col], np.full(k, inv, np.uint8))
        b[col] = gf_mul(b[col], np.full(b.shape[1], inv, np.uint8))
        for r in range(k):
            if r != col and a[r, col] != 0:
                f = a[r, col]
                a[r] ^= gf_mul(a[col], np.full(k, f, np.uint8))
                b[r] ^= gf_mul(b[col], np.full(b.shape[1], f, np.uint8))
    return b


def cauchy_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) Cauchy matrix over GF(256): C[i, j] = 1 / (x_i ^ y_j) with
    x_i = k + i, y_j = j (disjoint index sets, k + m <= 256)."""
    assert k + m <= 256, "GF(256) supports at most 256 packets per block"
    c = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            c[i, j] = gf_inv((k + i) ^ j)
    return c


# ---------------------------------------------------------------------------
# Block erasure codes
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FECSpec:
    """k data packets + m parity packets per block."""

    k: int = 4
    m: int = 2
    kind: str = "rs"                 # "rs" | "xor"

    def __post_init__(self):
        assert self.k >= 1 and self.m >= 0
        if self.kind == "xor":
            assert self.m <= 1, "xor parity supports m <= 1"
        assert self.k + self.m <= 256

    @property
    def block_packets(self) -> int:
        return self.k + self.m

    @property
    def overhead(self) -> float:
        """Transmission expansion factor (k+m)/k."""
        return self.block_packets / self.k

    def num_blocks(self, n_data_packets: int) -> int:
        return -(-n_data_packets // self.k)

    def transmitted_packets(self, n_data_packets: int) -> int:
        return self.num_blocks(n_data_packets) * self.block_packets


def encode(data: np.ndarray, spec: FECSpec) -> np.ndarray:
    """Encode one block: (k, L) uint8 payloads -> (k+m, L) systematic
    codeword (data rows first, parity rows after)."""
    data = np.asarray(data, dtype=np.uint8)
    k, _ = data.shape
    assert k == spec.k, (k, spec.k)
    if spec.m == 0:
        return data.copy()
    if spec.kind == "xor":
        parity = np.bitwise_xor.reduce(data, axis=0)[None, :]
    elif spec.kind == "rs":
        parity = gf_matmul(cauchy_matrix(spec.k, spec.m), data)
    else:
        raise ValueError(spec.kind)
    return np.concatenate([data, parity], axis=0)


def decode(received: np.ndarray, received_idx: Sequence[int], spec: FECSpec) -> np.ndarray:
    """Reconstruct the k data packets from any >= k received codeword rows
    (``received_idx``: their positions, 0..k-1 data, k.. parity).  Raises
    ValueError if fewer than k rows survived."""
    received = np.asarray(received, dtype=np.uint8)
    idx = list(received_idx)
    if len(idx) < spec.k:
        raise ValueError(f"unrecoverable block: {len(idx)} of {spec.k} packets received")
    have_data = {i for i in idx if i < spec.k}
    if len(have_data) == spec.k:   # all data rows survived
        rows = {i: received[n] for n, i in enumerate(idx) if i < spec.k}
        return np.stack([rows[i] for i in range(spec.k)], axis=0)
    if spec.kind == "xor":
        # One data row missing: parity XOR the surviving data rows.
        (missing,) = set(range(spec.k)) - have_data
        rows = {i: received[n] for n, i in enumerate(idx)}
        assert spec.k in rows, "xor decode needs the parity row"
        acc = rows[spec.k].copy()
        for i in have_data:
            acc ^= rows[i]
        out = np.zeros((spec.k, received.shape[1]), np.uint8)
        for i in range(spec.k):
            out[i] = acc if i == missing else rows[i]
        return out
    # RS: the generator rows of the received positions form a (k, k) system.
    gen = np.concatenate([np.eye(spec.k, dtype=np.uint8), cauchy_matrix(spec.k, spec.m)], axis=0)
    sel = idx[: spec.k]
    return gf_solve(gen[sel], received[: spec.k])


def encode_floats(packets: np.ndarray, spec: FECSpec) -> np.ndarray:
    """(k, n_elem) float32 packet payloads -> (k+m, n_elem*4) uint8 rows."""
    raw = np.ascontiguousarray(packets, dtype=np.float32).view(np.uint8)
    return encode(raw.reshape(packets.shape[0], -1), spec)


def decode_floats(received: np.ndarray, received_idx: Sequence[int], spec: FECSpec,
                  n_elem: int) -> np.ndarray:
    """Inverse of ``encode_floats`` -> (k, n_elem) float32, bit-exact."""
    data = decode(received, received_idx, spec)
    return data.view(np.float32).reshape(spec.k, n_elem)


# ---------------------------------------------------------------------------
# Train/serve-time emulation (mask algebra)
# ---------------------------------------------------------------------------

def block_recovery_mask(pkt_keep: torch.Tensor, spec: FECSpec) -> torch.Tensor:
    """Keep mask of the k data packets of each block after decoding.

    ``pkt_keep``: 0/1 of shape (..., n_blocks * (k+m)), the raw channel
    mask over the transmitted packets, block-major, data first in a block.
    Returns float32 (..., n_blocks * k): 1 where a data packet arrived or
    its block was recovered (>= k of its packets arrived)."""
    km = spec.block_packets
    lead = tuple(pkt_keep.shape[:-1])
    n_blocks = pkt_keep.shape[-1] // km
    blk = pkt_keep.reshape(*lead, n_blocks, km).to(torch.float32)
    recovered = (blk.sum(dim=-1) >= spec.k).to(torch.float32)[..., None]
    out = torch.maximum(blk[..., : spec.k], recovered)
    return out.reshape(*lead, n_blocks * spec.k)


def fec_element_keep(key: torch.Tensor, channel, num_elements: int, elements_per_packet: int,
                     spec: FECSpec, shuffle: bool = False) -> torch.Tensor:
    """Flat element keep mask of an FEC-protected link: the channel drawn
    over the expanded (data + parity) packet stream, decoded per block, the
    data packets expanded to elements.  A constant 0/1 mask, out of the
    gradient whatever channel drew it (the reference's stop_gradient)."""
    kperm, kmask = prng.split(key)
    n_data = -(-num_elements // elements_per_packet)
    n_tx = spec.transmitted_packets(n_data)
    raw = channel.packet_keep(kmask, n_tx)
    data_keep = block_recovery_mask(raw, spec)[:n_data]
    if obs_device.tapping():
        # Data packets the raw channel lost but decoding rebuilt.
        raw_data = raw.reshape(-1, spec.block_packets)[:, :spec.k].reshape(-1)[:n_data].to(torch.float32)
        obs_device.record_fec_recovered(torch.sum(data_keep - raw_data))
    return element_mask_from_packets(data_keep, num_elements, elements_per_packet, kperm, shuffle).detach()


def residual_loss_rate(spec: FECSpec, channel) -> float:
    """Post-FEC data-packet loss rate under an i.i.d. approximation at the
    channel's stationary rate (exact for IIDChannel): the probability of
    each erasure count e > m in a block times its data-loss fraction e /
    (k+m).  The receiver's 1/(1-p) compensation on FEC links."""
    p = channel.stationary_loss_rate
    if spec.m == 0:
        return p
    km = spec.block_packets
    loss = 0.0
    for e in range(spec.m + 1, km + 1):
        pe = np.exp(
            log_binom_coeff(km, e)
            + e * np.log(max(p, 1e-12))
            + (km - e) * np.log(max(1.0 - p, 1e-12))
        )
        loss += pe * (e / km)
    return float(min(max(loss, 0.0), 1.0))
