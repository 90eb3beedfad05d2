"""COMtune's link at the split point — the port's twin of the serving half
of ``repro/core/comtune.py``.

The distributed-inference graph (paper Eq. 12):
    y = f_out ∘ f_dec ∘ (1/(1-p) · f_c(p)) ∘ f_cmp ∘ f_in
``emulate_link`` is the one entry point, in the modes ``serve`` (compress,
channel, compensate, decompress), ``clean`` (compression only) and ``off``.
The fine-tuning graph (``train``), FEC protection, the fused egress /
burst-mask kernels and adaptive compensation are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import link as link_lib
from repro_torch.core.compression import Compressor
from repro_torch.core.link import MIN_KEEP_FRACTION, scalar_as


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Configuration of the emulated IoT link at the split point (the
    serving fields of the reference's ``LinkSpec``)."""

    loss_rate: float = 0.0             # p used during DI serving
    compressor: Compressor = dataclasses.field(default_factory=Compressor)
    granularity: str = "element"       # "element" (Eq. 1) or "packet" (Eq. 2-3)
    elements_per_packet: int = 25      # 100 B packets / 4 B floats
    shuffle: bool = True               # paper's anti-burst interleaving
    channel: str = "iid"
    channel_params: tuple = ()
    fec_m: int = 0                     # FEC parity packets per block (0 = none)

    def with_channel_loss_rate(self, rate: float) -> "LinkSpec":
        """Set ``loss_rate``, dropping any ``("loss_rate", x)`` channel param
        that would shadow it."""
        params = tuple((k, v) for k, v in self.channel_params if k != "loss_rate")
        return dataclasses.replace(self, loss_rate=rate, channel_params=params)

    def resolve_channel(self):
        """The channel model this spec names; a ("loss_rate", x) channel
        param overrides ``loss_rate``."""
        from repro_torch.net import channels as net_channels

        params = dict(self.channel_params)
        loss_rate = params.pop("loss_rate", self.loss_rate)
        return net_channels.make_channel(self.channel or "iid", loss_rate=loss_rate, **params)


def _not_ported(spec: LinkSpec) -> None:
    if spec.fec_m > 0:
        raise NotImplementedError("packet FEC on the link is not ported yet (ROADMAP A11)")


def channel_link(key: torch.Tensor, x: torch.Tensor, spec: LinkSpec) -> torch.Tensor:
    """Eq. (10)-(11): channel + compensation on the compressed message."""
    _not_ported(spec)
    if spec.channel in ("", "iid"):
        loss_rate = dict(spec.channel_params).get("loss_rate", spec.loss_rate)
        if loss_rate <= 0.0:
            return x
        return link_lib.apply_channel(
            key, x, loss_rate, granularity=spec.granularity,
            elements_per_packet=spec.elements_per_packet, shuffle=spec.shuffle, compensate=True,
        )
    ch = spec.resolve_channel()
    mask = ch.element_keep(key, x.numel(), spec.elements_per_packet, shuffle=spec.shuffle).reshape(x.shape)
    keep = max(1.0 - ch.stationary_loss_rate, MIN_KEEP_FRACTION)
    return x * mask.to(x.dtype) / scalar_as(keep, x.dtype)


def streamed_channel_link(key: torch.Tensor, msg: torch.Tensor, spec: LinkSpec) -> torch.Tensor:
    """A (B, S, F) message sent as S per-token rounds: position ``i`` draws
    with ``fold_in(key, i)``, except position 0, which keeps the raw key (so
    a one-position message matches the decode round's draw)."""
    rounds = []
    for i in range(msg.shape[1]):
        k = key if i == 0 else prng.fold_in(key, i)
        rounds.append(channel_link(k, msg[:, i:i + 1, :], spec))
    return torch.cat(rounds, dim=1)


def emulate_link(key: Optional[torch.Tensor], x: torch.Tensor, spec: LinkSpec, mode: str) -> torch.Tensor:
    """The link-emulation entry point (modes serve / clean / off)."""
    if mode == "off":
        return x
    if mode == "clean":
        return spec.compressor.decompress(spec.compressor.compress(x))
    if mode == "train":
        raise NotImplementedError("the COMtune fine-tuning link (train mode) is not ported yet (ROADMAP A9)")
    if mode == "serve":
        msg = spec.compressor.compress(x)
        if x.dim() == 3 and x.shape[1] > 1:
            msg = streamed_channel_link(key, msg, spec)
        else:
            msg = channel_link(key, msg, spec)
        return spec.compressor.decompress(msg)
    raise ValueError(f"unknown link mode: {mode!r}")


def message_bytes(spec: LinkSpec, feature_dim: int) -> float:
    """Size of one transmitted message (per activation vector)."""
    return spec.compressor.message_elements(feature_dim) * spec.compressor.bytes_per_element()


def di_latency_s(spec: LinkSpec, feature_dim: int, batch: int,
                 channel: link_lib.ChannelConfig, protocol=None) -> float:
    """Latency of one DI round under the paper's one-shot (unreliable)
    protocol: ``n_t * l / b``."""
    _not_ported(spec)
    if protocol not in (None, "unreliable"):
        raise NotImplementedError(f"protocol {protocol!r} latency is not ported yet (ROADMAP A11)")
    total_bytes = message_bytes(spec, feature_dim) * batch
    n_data = -(-int(total_bytes) // channel.packet_bytes)
    return n_data * channel.slot_time_s()

