"""Packet-loss channel processes — the port's twin of the functional
(per-message mask) half of ``repro/net/channels.py``: the paper's i.i.d.
channel and the Gilbert–Elliott two-state burst channel.  Masks are drawn
with the reference's key use, so they are bit-equal to its draws.  The
fading and trace channels and the NumPy stateful simulator half wait for
ROADMAP A11.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.link import element_mask_from_packets


class _ChannelBase:
    """Element-granularity plumbing on top of ``packet_keep``."""

    def element_keep(self, key: torch.Tensor, num_elements: int, elements_per_packet: int,
                     shuffle: bool = False) -> torch.Tensor:
        kperm, kmask = prng.split(key)
        n_packets = -(-num_elements // elements_per_packet)
        pkt = self.packet_keep(kmask, n_packets)
        return element_mask_from_packets(pkt, num_elements, elements_per_packet, kperm, shuffle)


@dataclasses.dataclass(frozen=True)
class IIDChannel(_ChannelBase):
    """Memoryless Bernoulli packet loss — the paper's Eq. (1)-(3)."""

    loss_rate: float = 0.1

    @property
    def stationary_loss_rate(self) -> float:
        return float(self.loss_rate)

    def packet_keep(self, key: torch.Tensor, n_packets: int) -> torch.Tensor:
        return prng.bernoulli(key, 1.0 - self.loss_rate, (n_packets,)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class GilbertElliottChannel(_ChannelBase):
    """Two-state Markov chain: Good (loss ``loss_good``) / Bad (``loss_bad``);
    per packet G->B with prob ``p_gb``, B->G with ``p_bg``."""

    p_gb: float = 0.05
    p_bg: float = 0.4
    loss_good: float = 0.01
    loss_bad: float = 0.75

    @property
    def pi_bad(self) -> float:
        denom = self.p_gb + self.p_bg
        return float(self.p_gb / denom) if denom > 0 else 0.0

    @property
    def stationary_loss_rate(self) -> float:
        pb = self.pi_bad
        return float((1.0 - pb) * self.loss_good + pb * self.loss_bad)

    @classmethod
    def from_target(cls, loss_rate: float, burst_len: float = 4.0,
                    loss_good: float = 0.0, loss_bad: float = 1.0) -> "GilbertElliottChannel":
        """(p_gb, p_bg) hitting a target stationary loss rate with mean bad
        sojourn ``burst_len`` packets (as the reference constructs it)."""
        span = loss_bad - loss_good
        assert span > 1e-9, "loss_bad must exceed loss_good"
        pi_b = min(max((loss_rate - loss_good) / span, 0.0), 0.999)
        p_bg = 1.0 / max(burst_len, 1.0)
        p_gb = p_bg * pi_b / max(1.0 - pi_b, 1e-9)
        if p_gb > 1.0:
            p_gb = 1.0
            p_bg = (1.0 - pi_b) / pi_b
        return cls(p_gb=p_gb, p_bg=p_bg, loss_good=loss_good, loss_bad=loss_bad)

    def packet_keep(self, key: torch.Tensor, n_packets: int) -> torch.Tensor:
        kinit, kloss, ktr = prng.split(key, 3)
        u_init = prng.uniform(kinit, ())
        u_loss = prng.uniform(kloss, (n_packets,))
        u_tr = prng.uniform(ktr, (n_packets,))
        return gilbert_elliott_scan(u_init, u_loss, u_tr, self.p_gb, self.p_bg,
                                    self.loss_good, self.loss_bad)


def gilbert_elliott_scan(u_init: torch.Tensor, u_loss: torch.Tensor, u_tr: torch.Tensor,
                         p_gb: float, p_bg: float, loss_good: float, loss_bad: float) -> torch.Tensor:
    """GE keep mask over the last (packet) axis; leading axes are
    independent chains.  The per-packet keep decisions and next-state
    tables are computed for both states at once; only the state walk is a
    sequential loop (one ``where`` per packet)."""
    f32 = lambda x: float(np.float32(x))
    pi_b = p_gb / max(p_gb + p_bg, 1e-12)
    bad = (u_init < f32(pi_b)).expand(u_loss.shape[:-1])
    keep_if_bad = u_loss >= f32(loss_bad)
    keep_if_good = u_loss >= f32(loss_good)
    next_if_bad = u_tr >= f32(p_bg)
    next_if_good = u_tr < f32(p_gb)
    states = []
    for t in range(u_loss.shape[-1]):
        states.append(bad)
        bad = torch.where(bad, next_if_bad[..., t], next_if_good[..., t])
    bad_seq = torch.stack(states, dim=-1)
    return torch.where(bad_seq, keep_if_bad, keep_if_good).to(torch.float32)


def supports_target_rate(name: str, params=()) -> bool:
    """True when ``make_channel(name, loss_rate=p, **params)`` hits the
    target stationary rate ``p``, so a loss-rate curriculum over it means
    something: the i.i.d. channel, and a GE channel not pinned by explicit
    ``p_gb`` / ``p_bg``."""
    key = name.lower()
    if key in ("ge", "gilbert_elliott"):
        pd = dict(params)
        return "p_gb" not in pd and "p_bg" not in pd
    return key == "iid"


CHANNELS = {
    "iid": IIDChannel,
    "gilbert_elliott": GilbertElliottChannel,
    "ge": GilbertElliottChannel,
}


def make_channel(name: str, loss_rate: float = 0.1, **params):
    """Build a channel by registry name (``iid``, ``ge``, ``gilbert_elliott``)."""
    key = name.lower()
    if key in ("fading", "trace"):
        raise NotImplementedError(f"channel {name!r} is not ported yet (ROADMAP A11)")
    if key not in CHANNELS:
        raise ValueError(f"unknown channel {name!r}; available: {sorted(CHANNELS)}")
    if key in ("ge", "gilbert_elliott"):
        params.pop("loss_rate", None)
        if "p_gb" in params or "p_bg" in params:
            return GilbertElliottChannel(**params)
        return GilbertElliottChannel.from_target(loss_rate, **params)
    return IIDChannel(loss_rate=params.pop("loss_rate", loss_rate))
