"""Unreliable-link model (paper §III-B, Eq. 1-3) — the port's twin of
``repro/core/link.py``: keep masks drawn from ``repro_torch.prng`` with the
reference's key use, so every mask is bit-equal to the reference's, plus
the channel constants and the NumPy latency analytics of Eq. 4-5 (the same
float64 arrays as the reference's, bit for bit).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.obs import device as obs_device

# Floor for every kept-fraction denominator (1 - p, 1 - p_eff), so a loss
# rate of 1.0 returns zeros instead of 0 * inf = NaN.
MIN_KEEP_FRACTION = 1e-6


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Physical channel constants (paper §IV-A)."""

    packet_bytes: int = 100          # packet size l, including MAC/net overhead
    throughput_bps: float = 9.0e6    # b = 9.0 Mbit/s
    loss_rate: float = 0.0           # p
    bytes_per_element: int = 4       # 32-bit float activations by default

    @property
    def elements_per_packet(self) -> int:
        return max(1, self.packet_bytes // self.bytes_per_element)

    def num_packets_for_bytes(self, num_bytes: float) -> int:
        return max(1, -(-int(num_bytes) // self.packet_bytes))

    def num_packets(self, num_elements: int) -> int:
        return -(-num_elements // self.elements_per_packet)

    def slot_time_s(self) -> float:
        """Time T to transmit one packet."""
        return self.packet_bytes * 8.0 / self.throughput_bps


def element_loss_mask(key: torch.Tensor, shape, loss_rate) -> torch.Tensor:
    """Eq. (1): i.i.d. Bernoulli keep mask with E[m] = 1 - p (float32 0/1);
    a 0-d tensor rate draws the same bits as the equal Python float."""
    return prng.bernoulli(key, 1.0 - loss_rate, tuple(shape)).to(torch.float32)


def element_mask_from_packets(
    pkt_keep: torch.Tensor, num_elements: int, elements_per_packet: int,
    key: torch.Tensor, shuffle: bool,
) -> torch.Tensor:
    """Expand a packet keep mask to a flat element mask, optionally through
    the paper's anti-burst interleaving permutation (Eq. 2):
    ``out[perm[i]] = mask[i]``."""
    mask = torch.repeat_interleave(pkt_keep.to(torch.float32), elements_per_packet)[:num_elements]
    if shuffle:
        perm = prng.permutation(key, num_elements)
        out = torch.zeros(num_elements, dtype=torch.float32, device=mask.device)
        out[perm] = mask
        mask = out
    return mask


def packet_loss_mask(
    key: torch.Tensor, num_elements: int, loss_rate,
    elements_per_packet: int, shuffle: bool = True,
) -> torch.Tensor:
    """Eq. (2)-(3): whole packets of ``s`` consecutive (post-shuffle)
    elements dropped together; a flat float32 0/1 keep mask."""
    kperm, kdrop = prng.split(key)
    n_packets = -(-num_elements // elements_per_packet)
    pkt_keep = prng.bernoulli(kdrop, 1.0 - loss_rate, (n_packets,))
    return element_mask_from_packets(pkt_keep, num_elements, elements_per_packet, kperm, shuffle)


def scalar_as(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` (as ``jnp.asarray(value, dtype)``),
    returned as a Python float so an op against a ``dtype`` tensor uses
    exactly that value without a host-to-device copy."""
    return float(torch.tensor(value, dtype=dtype))


def apply_channel(
    key: torch.Tensor, x: torch.Tensor, loss_rate, *,
    granularity: str = "element", elements_per_packet: int = 25,
    shuffle: bool = True, compensate: bool = True,
) -> torch.Tensor:
    """Transmit ``x`` through the lossy link (Eq. 1/10) and apply the
    receiver's ``1/(1-p)`` compensation (Eq. 11), as a reciprocal multiply.
    ``loss_rate`` may be a 0-d tensor (the per-step curriculum): the same
    masks and the same f32 reciprocal as the equal Python float."""
    if granularity == "element":
        mask = element_loss_mask(key, x.shape, loss_rate)
    elif granularity == "packet":
        mask = packet_loss_mask(key, x.numel(), loss_rate, elements_per_packet, shuffle).reshape(x.shape)
    else:
        raise ValueError(f"unknown granularity: {granularity!r}")
    obs_device.record_mask(mask)
    y = x * mask.to(x.dtype)
    if compensate:
        if torch.is_tensor(loss_rate):
            keep = torch.clamp(1.0 - loss_rate.to(device=x.device, dtype=torch.float32), min=MIN_KEEP_FRACTION)
            return y * (1.0 / keep).to(x.dtype)
        keep = np.maximum(np.float32(1.0) - np.float32(loss_rate), np.float32(MIN_KEEP_FRACTION))
        y = y * scalar_as(np.float32(1.0) / keep, x.dtype)
    return y


# ---------------------------------------------------------------------------
# Latency model (Eq. 4-5): pure NumPy analytics, as the reference's.
# ---------------------------------------------------------------------------

def _gammaln(x: np.ndarray) -> np.ndarray:
    """Stirling-series log-gamma, accurate to ~1e-10 for x >= 1 (no scipy)."""
    x = np.asarray(x, dtype=np.float64)
    # Shift x up by 6 for series accuracy, then divide back down.
    shift = 6
    xs = x + shift
    series = (
        (xs - 0.5) * np.log(xs)
        - xs
        + 0.5 * np.log(2.0 * np.pi)
        + 1.0 / (12.0 * xs)
        - 1.0 / (360.0 * xs**3)
        + 1.0 / (1260.0 * xs**5)
    )
    corr = np.zeros_like(xs)
    for i in range(shift):
        corr += np.log(x + i)
    return series - corr


def log_binom_coeff(n, k):
    n = np.asarray(n, dtype=np.float64)
    k = np.asarray(k, dtype=np.float64)
    return _gammaln(n + 1.0) - _gammaln(k + 1.0) - _gammaln(n - k + 1.0)


def received_packets_pmf(n_t: int, loss_rate: float) -> np.ndarray:
    """Eq. (4): PMF of the number of received packets, support 0..n_t."""
    n_r = np.arange(n_t + 1)
    if loss_rate <= 0.0:
        pmf = np.zeros(n_t + 1)
        pmf[-1] = 1.0
        return pmf
    if loss_rate >= 1.0:
        pmf = np.zeros(n_t + 1)
        pmf[0] = 1.0
        return pmf
    logp = log_binom_coeff(n_t, n_r) + (n_t - n_r) * np.log(loss_rate) + n_r * np.log1p(-loss_rate)
    pmf = np.exp(logp)
    return pmf / pmf.sum()


def unreliable_latency_s(n_t: int, cfg: ChannelConfig) -> float:
    """No retransmission: deterministic n_t * l / b (paper §III-B)."""
    return n_t * cfg.slot_time_s()


def reliable_latency_pmf(n_t: int, cfg: ChannelConfig, max_slots: int | None = None):
    """Eq. (5): latency (slots) * T until all n_t packets are delivered under
    stop-and-wait retransmission; the slot count K is negative-binomial,
    P(K=k) = C(k-1, n_t-1) p^(k-n_t) (1-p)^n_t.  Returns (latency_seconds,
    pmf) over k = n_t .. max_slots."""
    p = cfg.loss_rate
    if max_slots is None:
        # Enough tail for p up to 0.9.
        max_slots = max(n_t + 1, int(n_t / max(1e-9, 1.0 - p) * 6))
    k = np.arange(n_t, max_slots + 1)
    if p <= 0.0:
        pmf = np.zeros_like(k, dtype=np.float64)
        pmf[0] = 1.0
    else:
        logp = log_binom_coeff(k - 1, n_t - 1) + (k - n_t) * np.log(p) + n_t * np.log1p(-p)
        pmf = np.exp(logp)
        pmf = pmf / pmf.sum()
    return k.astype(np.float64) * cfg.slot_time_s(), pmf


def latency_cdf(latency_s: np.ndarray, pmf: np.ndarray):
    order = np.argsort(latency_s)
    return latency_s[order], np.cumsum(pmf[order])
