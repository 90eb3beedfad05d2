"""COMtune's link at the split point — the port's twin of the serving half
of ``repro/core/comtune.py``.

The distributed-inference graph (paper Eq. 12):
    y = f_out ∘ f_dec ∘ (1/(1-p) · f_c(p)) ∘ f_cmp ∘ f_in
``emulate_link`` is the one entry point, in the modes ``serve`` (compress,
channel, compensate, decompress), ``clean`` (compression only) and ``off``.
``LinkSpec(use_kernel=True)`` takes the serving link through the hand
kernels of ``kernels/lossy_link``: the fused egress for the plain i.i.d.
quantized link, the burst-mask kernel for Gilbert–Elliott channels.  The
fine-tuning graph (``train``), FEC protection and adaptive compensation are
not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import prng
from repro_torch.core import link as link_lib
from repro_torch.core.compression import Compressor
from repro_torch.core.link import MIN_KEEP_FRACTION, scalar_as
from repro_torch.kernels.lossy_link import dispatch as link_kernels


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Configuration of the emulated IoT link at the split point (the
    serving fields of the reference's ``LinkSpec``)."""

    loss_rate: float = 0.0             # p used during DI serving
    compressor: Compressor = dataclasses.field(default_factory=Compressor)
    granularity: str = "element"       # "element" (Eq. 1) or "packet" (Eq. 2-3)
    elements_per_packet: int = 25      # 100 B packets / 4 B floats
    shuffle: bool = True               # paper's anti-burst interleaving
    use_kernel: bool = False           # the link kernels on the serve path
    channel: str = "iid"
    channel_params: tuple = ()
    fec_m: int = 0                     # FEC parity packets per block (0 = none)

    def with_channel_loss_rate(self, rate: float) -> "LinkSpec":
        """Set ``loss_rate``, dropping any ``("loss_rate", x)`` channel param
        that would shadow it."""
        params = tuple((k, v) for k, v in self.channel_params if k != "loss_rate")
        return dataclasses.replace(self, loss_rate=rate, channel_params=params)

    @property
    def uses_net_path(self) -> bool:
        """True when the link cannot take the plain-iid fast paths (the fused
        egress kernel bakes in ``loss_rate``): a stateful channel, FEC, or a
        ``channel_params`` loss-rate override."""
        return self.channel not in ("", "iid") or self.fec_m > 0 or "loss_rate" in dict(self.channel_params)

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


def _stateful_channel_mask(key: torch.Tensor, x: torch.Tensor, spec: LinkSpec):
    """Keep mask (x's shape, f32) and stationary loss rate of a non-iid
    channel.  Under ``use_kernel`` a Gilbert–Elliott channel draws its
    packet masks with the burst-mask kernel (one row), from the same keys
    the channel's own scan uses, so the mask is bit-equal either way."""
    ch = spec.resolve_channel()
    if spec.use_kernel and spec.channel in ("ge", "gilbert_elliott"):
        kperm, kmask = prng.split(key)
        n_packets = -(-x.numel() // spec.elements_per_packet)
        pkt = link_kernels.burst_mask(kmask, 1, n_packets, p_gb=ch.p_gb, p_bg=ch.p_bg,
                                      loss_good=ch.loss_good, loss_bad=ch.loss_bad)[0]
        flat = link_lib.element_mask_from_packets(pkt, x.numel(), spec.elements_per_packet, kperm, spec.shuffle)
    else:
        flat = ch.element_keep(key, x.numel(), spec.elements_per_packet, shuffle=spec.shuffle)
    return flat.reshape(x.shape), ch.stationary_loss_rate


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
    mask, p_eff = _stateful_channel_mask(key, x, spec)
    keep = max(1.0 - p_eff, MIN_KEEP_FRACTION)
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
        if x.dim() == 3 and x.shape[1] > 1:
            msg = streamed_channel_link(key, spec.compressor.compress(x), spec)
            return spec.compressor.decompress(msg)
        # The fused egress implements the plain iid channel only (it bakes
        # in spec.loss_rate); anything on the net path goes through
        # channel_link, which has its own burst-mask kernel for GE.
        if spec.use_kernel and spec.compressor.kind == "quant" and not spec.uses_net_path:
            return link_kernels.lossy_link_egress(key, x, spec.compressor.quant, spec.loss_rate)
        msg = channel_link(key, spec.compressor.compress(x), spec)
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

