"""COMtune's link at the split point — the port's twin of
``repro/core/comtune.py``.

Two compositions over a split model ``f = f_out ∘ f_in``:

* the fine-tuning graph (paper Eq. 8),
      f_trn = f_out ∘ f_dec ∘ f_d(r) ∘ f_cmp ∘ f_in,
  where ``f_d`` is the paper's inverted dropout at rate ``r`` (Eq. 7), or,
  under ``LinkSpec(train_link="channel")``, the serving channel with its
  masks and compensation out of the gradient (identity on the mask);
* the distributed-inference graph (Eq. 12),
      y = f_out ∘ f_dec ∘ (1/(1-p) · f_c(p)) ∘ f_cmp ∘ f_in.

``emulate_link`` is the one entry point, in the modes ``train`` (the STE
compression roundtrip, then the emulation ``spec.train_link`` names),
``serve`` (compress, channel, compensate, decompress), ``clean``
(compression only) and ``off``.  ``LinkSpec(use_kernel=True)`` takes the
link through the hand kernels of ``kernels/lossy_link``: the fused egress
for the plain i.i.d. quantized serving link, the burst-mask kernel for
Gilbert–Elliott channels in either mode without FEC.  The channel process
(``net.channels``: i.i.d., Gilbert–Elliott, fading, trace), packet FEC
(``net.fec``) and adaptive compensation are ``LinkSpec`` fields, and
``di_latency_s`` reports the link's latency under the ``net.protocol``
policies.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core import link as link_lib
from repro_torch.core.compression import Compressor
from repro_torch.core.link import MIN_KEEP_FRACTION, scalar_as
from repro_torch.kernels.lossy_link import dispatch as link_kernels
from repro_torch.obs import device as obs_device


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Configuration of the emulated IoT link at the split point.
    ``dropout_rate`` / ``loss_rate`` may be 0-d f32 tensors (the per-step
    curriculum's rate)."""

    dropout_rate: float = 0.0          # r used during COMtune fine-tuning
    loss_rate: float = 0.0             # p used during DI serving
    # What emulates the channel in the fine-tuning graph (Eq. 8):
    #   "dropout" -- the paper's Eq. 7 inverted dropout at dropout_rate;
    #   "channel" -- the serving channel at loss_rate, its masks and
    #                compensation out of the gradient.
    train_link: str = "dropout"
    compressor: Compressor = dataclasses.field(default_factory=Compressor)
    granularity: str = "element"       # "element" (Eq. 1) or "packet" (Eq. 2-3)
    elements_per_packet: int = 25      # 100 B packets / 4 B floats
    shuffle: bool = True               # paper's anti-burst interleaving
    use_kernel: bool = False           # the link kernels on the serve path
    adaptive_compensation: bool = False  # compensate by the realized keep fraction
    # Channel process (net.channels registry): "iid" (the paper's), "ge" /
    # "gilbert_elliott", "fading", "trace"; channel_params is a hashable
    # tuple of (name, value) pairs for make_channel.
    channel: str = "iid"
    channel_params: tuple = ()
    # Packet FEC (net.fec): k data + m parity packets a block; m = 0: none.
    fec_k: int = 0
    fec_m: int = 0
    fec_kind: str = "rs"

    def with_channel_loss_rate(self, rate: float) -> "LinkSpec":
        """Set ``loss_rate``, dropping any ``("loss_rate", x)`` channel param
        that would shadow it."""
        params = tuple((k, v) for k, v in self.channel_params if k != "loss_rate")
        return dataclasses.replace(self, loss_rate=rate, channel_params=params)

    def with_dropout_rate(self, r: float) -> "LinkSpec":
        return dataclasses.replace(self, dropout_rate=r)

    def with_train_link(self, kind: str) -> "LinkSpec":
        return dataclasses.replace(self, train_link=kind)

    def with_train_rate(self, rate: float) -> "LinkSpec":
        """Set the rate the fine-tuning emulation draws at: the dropout rate
        under ``train_link="dropout"``, the (authoritative) channel loss
        rate under ``"channel"`` (the curriculum's ramp)."""
        if self.train_link == "channel":
            return self.with_channel_loss_rate(rate)
        return dataclasses.replace(self, dropout_rate=rate)

    def with_channel(self, channel: str, **params) -> "LinkSpec":
        return dataclasses.replace(self, channel=channel, channel_params=tuple(sorted(params.items())))

    @property
    def uses_net_path(self) -> bool:
        """True when the link cannot take the plain-iid fast paths (the fused
        egress kernel bakes in ``loss_rate``): a stateful channel, FEC, or a
        ``channel_params`` loss-rate override."""
        return self.channel not in ("", "iid") or self.fec_m > 0 or "loss_rate" in dict(self.channel_params)

    @property
    def fec_spec(self):
        """The FEC code (``net.fec.FECSpec``, k at least 1), or None."""
        if self.fec_m <= 0:
            return None
        from repro_torch.net.fec import FECSpec

        return FECSpec(k=max(self.fec_k, 1), m=self.fec_m, kind=self.fec_kind)

    def resolve_channel(self):
        """The channel model this spec names; a ("loss_rate", x) channel
        param overrides ``loss_rate``."""
        from repro_torch.net import channels as net_channels

        params = dict(self.channel_params)
        loss_rate = params.pop("loss_rate", self.loss_rate)
        return net_channels.make_channel(self.channel or "iid", loss_rate=loss_rate, **params)


def dropout_link(key: torch.Tensor, x: torch.Tensor, rate) -> torch.Tensor:
    """Eq. (7): inverted dropout, the paper's channel emulation layer.

    Compensation is a multiply by the f32 reciprocal of ``1 - rate`` (as
    rounded to x's dtype), taken in f32 and rounded once: what the jitted
    reference computes for a static rate, where XLA folds its division by
    the constant into that multiply.  ``rate`` may be a 0-d tensor (the
    per-step curriculum): it draws the same Bernoulli bits (``uniform < 1 -
    r``) and gives the same values as the equal Python float.  (The
    reference divides by a traced rate instead, one ulp off in ~1 element
    of 16.)  Only a Python zero takes the shortcut."""
    if not torch.is_tensor(rate) and rate <= 0.0:
        obs_device.record_full_keep(x.numel())
        return x
    keep = prng.bernoulli(key, 1.0 - rate, tuple(x.shape)).to(x.device)
    obs_device.record_mask(keep)
    if torch.is_tensor(rate):
        c = (1.0 - rate.to(device=x.device, dtype=torch.float32)).to(x.dtype)
    else:
        c = torch.tensor(1.0 - rate, dtype=x.dtype, device=x.device)
    acc = torch.promote_types(x.dtype, torch.float32)
    scaled = (x.to(acc) * (1.0 / c.to(acc))).to(x.dtype)
    return torch.where(keep, scaled, torch.zeros((), dtype=x.dtype, device=x.device))


def _stateful_channel_mask(key: torch.Tensor, x: torch.Tensor, spec: LinkSpec):
    """Keep mask (x's shape, f32) and effective loss rate of a link on the
    net path.  Under FEC: the block-recovery mask over the expanded packet
    stream and the residual loss rate (ahead of the kernel branch, as in
    the reference).  Otherwise, under ``use_kernel``, a Gilbert–Elliott
    channel draws its packet masks with the burst-mask kernel (one row),
    from the same keys the channel's own scan uses, so the mask is
    bit-equal either way."""
    ch = spec.resolve_channel()
    fspec = spec.fec_spec
    if fspec is not None:
        from repro_torch.net import fec as fec_lib

        flat = fec_lib.fec_element_keep(key, ch, x.numel(), spec.elements_per_packet, fspec, shuffle=spec.shuffle)
        return flat.reshape(x.shape), fec_lib.residual_loss_rate(fspec, ch)
    if spec.use_kernel and spec.channel in ("ge", "gilbert_elliott"):
        kperm, kmask = prng.split(key)
        n_packets = -(-x.numel() // spec.elements_per_packet)
        pkt = link_kernels.burst_mask(kmask, 1, n_packets, p_gb=ch.p_gb, p_bg=ch.p_bg,
                                      loss_good=ch.loss_good, loss_bad=ch.loss_bad)[0]
        flat = link_lib.element_mask_from_packets(pkt, x.numel(), spec.elements_per_packet, kperm, spec.shuffle)
    else:
        flat = ch.element_keep(key, x.numel(), spec.elements_per_packet, shuffle=spec.shuffle)
    return flat.reshape(x.shape), ch.stationary_loss_rate


def _adaptive(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Compensation by the realized keep fraction: ``x * mask /
    max(mean(mask), MIN_KEEP_FRACTION)``, the mean in f32."""
    mask = mask.detach()
    kept = torch.clamp(mask.mean(), min=MIN_KEEP_FRACTION)
    return x * mask.to(x.dtype) / kept.to(x.dtype)


def channel_link(key: torch.Tensor, x: torch.Tensor, spec: LinkSpec) -> torch.Tensor:
    """Eq. (10)-(11): channel + compensation on the compressed message (the
    serving graph), or on the STE roundtrip's activation when the
    fine-tuning graph emulates the deployment channel; the masks and the
    compensation carry no gradient, so the gradient is identity on the
    mask.  The plain i.i.d. link keeps the paper's Eq. 1-3 path; stateful
    channels and FEC (iid + FEC included) go through ``net``.  Under
    ``adaptive_compensation`` the receiver divides by the realized keep
    fraction instead of the nominal one.  The i.i.d. rate may be a 0-d
    tensor; only a Python zero takes the shortcut."""
    if spec.channel in ("", "iid") and spec.fec_m <= 0:
        loss_rate = dict(spec.channel_params).get("loss_rate", spec.loss_rate)
        if not torch.is_tensor(loss_rate) and loss_rate <= 0.0:
            obs_device.record_full_keep(x.numel())
            return x
        if spec.adaptive_compensation:
            if spec.granularity == "element":
                mask = link_lib.element_loss_mask(key, x.shape, loss_rate)
            else:
                mask = link_lib.packet_loss_mask(key, x.numel(), loss_rate, spec.elements_per_packet,
                                                 spec.shuffle).reshape(x.shape)
            obs_device.record_mask(mask)
            return _adaptive(x, mask)
        return link_lib.apply_channel(
            key, x, loss_rate, granularity=spec.granularity,
            elements_per_packet=spec.elements_per_packet, shuffle=spec.shuffle, compensate=True,
        )
    mask, p_eff = _stateful_channel_mask(key, x, spec)
    obs_device.record_mask(mask)
    if spec.adaptive_compensation:
        return _adaptive(x, mask)
    keep = max(1.0 - p_eff, MIN_KEEP_FRACTION)
    return x * mask.to(x.dtype) / scalar_as(keep, x.dtype)


def streamed_channel_link(key: torch.Tensor, msg: torch.Tensor, spec: LinkSpec) -> torch.Tensor:
    """A (B, S, F) message sent as S per-token rounds: position ``i`` draws
    with ``fold_in(key, i)``, except position 0, which keeps the raw key (so
    a one-position message matches the decode round's draw).  Each round
    records into the ambient collector, which sums them as the reference's
    per-position taps do.  On ``meta`` (shapes only) the rounds are one."""
    if msg.is_meta:
        return channel_link(key, msg, spec)
    rounds = []
    for i in range(msg.shape[1]):
        k = key if i == 0 else prng.fold_in(key, i)
        rounds.append(channel_link(k, msg[:, i:i + 1, :], spec))
    return torch.cat(rounds, dim=1)


def emulate_link(key: Optional[torch.Tensor], x: torch.Tensor, spec: LinkSpec, mode: str) -> torch.Tensor:
    """The link-emulation entry point, shared by the fine-tuning graph (Eq.
    8) and the serving graph (Eq. 12).

    mode:
      "train" -> the STE compression roundtrip, then ``spec.train_link``:
                 "dropout" (Eq. 7 at ``dropout_rate``) or "channel" (the
                 serving channel at ``loss_rate``, identity-on-mask
                 gradients);
      "serve" -> compress, channel(p), 1/(1-p), decompress; a (B, S, F)
                 message streams as S per-token rounds; the fused egress
                 kernel under ``use_kernel`` for the plain i.i.d. link;
      "clean" -> the compression roundtrip only;
      "off"   -> identity.
    """
    if mode == "off":
        return x
    if mode == "clean":
        return spec.compressor.decompress(spec.compressor.compress(x))
    if mode == "train":
        a = spec.compressor.roundtrip_train(x)
        if spec.train_link == "dropout":
            return dropout_link(key, a, spec.dropout_rate)
        if spec.train_link == "channel":
            return channel_link(key, a, spec)
        raise ValueError(f"unknown train_link: {spec.train_link!r}")
    if mode == "serve":
        if x.dim() == 3 and x.shape[1] > 1:
            msg = streamed_channel_link(key, spec.compressor.compress(x), spec)
            return spec.compressor.decompress(msg)
        # The fused egress implements the plain iid channel only (it bakes
        # in spec.loss_rate); anything on the net path goes through
        # channel_link, which has its own burst-mask kernel for GE.
        if spec.use_kernel and spec.compressor.kind == "quant" and not spec.uses_net_path:
            if obs_device.tapping():
                # The egress draws its keep mask inside the kernel (keep = u
                # >= p, on the key's threefry uniforms); draw those uniforms
                # again here, only to count.
                u = prng.uniform(key, (x.numel() // x.shape[-1], x.shape[-1]))
                obs_device.record_mask(u >= float(np.float32(spec.loss_rate)))
            return link_kernels.lossy_link_egress(key, x, spec.compressor.quant, spec.loss_rate)
        msg = channel_link(key, spec.compressor.compress(x), spec)
        return spec.compressor.decompress(msg)
    raise ValueError(f"unknown link mode: {mode!r}")


def comtune_forward(f_in, f_out, params_in, params_out, x: torch.Tensor, key: torch.Tensor, spec: LinkSpec,
                    train: bool = True) -> torch.Tensor:
    """Eq. (8): the fine-tuning graph over ``f_in(params_in, x)`` and
    ``f_out(params_out, a)``; ``train=False`` gives the compression
    roundtrip alone (``clean``)."""
    a = f_in(params_in, x)
    return f_out(params_out, emulate_link(key, a, spec, "train" if train else "clean"))


def distributed_inference(f_in, f_out, params_in, params_out, x: torch.Tensor, key: torch.Tensor,
                          spec: LinkSpec) -> torch.Tensor:
    """Eq. (12): the DI serving graph, ``f_out(f_dec(f_c(f_cmp(f_in(x)))
    / (1 - p)))``."""
    return f_out(params_out, emulate_link(key, f_in(params_in, x), spec, "serve"))


def message_bytes(spec: LinkSpec, feature_dim: int) -> float:
    """Size of one transmitted message (per activation vector)."""
    return spec.compressor.message_elements(feature_dim) * spec.compressor.bytes_per_element()


def di_latency_s(spec: LinkSpec, feature_dim: int, batch: int,
                 channel: link_lib.ChannelConfig, protocol=None) -> float:
    """Expected communication latency of one DI round.

    ``protocol`` selects the link-layer policy (``net.protocol``):

    * ``None`` / ``"unreliable"``: the paper's one-shot protocol, ``n_t * l
      / b``, with FEC expanding ``n_t`` by ``(k+m)/k``;
    * ``"arq"`` / ``"fec_arq"`` or a policy instance: the mean of the
      policy's latency PMF at ``channel.loss_rate``.  ARQ resends the
      (FEC-expanded, if any) packet stream; FEC-ARQ codes blocks itself, so
      it takes the raw data-packet count and the spec's FEC code (which the
      string form needs).
    """
    total_bytes = message_bytes(spec, feature_dim) * batch
    n_data = -(-int(total_bytes) // channel.packet_bytes)
    fspec = spec.fec_spec
    n_tx = fspec.transmitted_packets(n_data) if fspec is not None else n_data

    if protocol is None or protocol == "unreliable":
        return n_tx * channel.slot_time_s()

    if isinstance(protocol, str):
        from repro_torch.net import protocol as protocol_lib

        kwargs = {}
        if protocol == "fec_arq":
            if fspec is None:
                raise ValueError("protocol='fec_arq' needs the spec's FEC code (set fec_k/fec_m) or pass a "
                                 "HybridFECARQProtocol instance")
            kwargs["fec"] = fspec
        policy = protocol_lib.make_protocol(protocol, **kwargs)
    else:
        policy = protocol
    n_t = n_data if getattr(policy, "name", "") == "fec_arq" else n_tx
    return policy.expected_latency_s(n_t, channel)
