"""Link-layer protocol policies over the packet channel, the port's twin of
``repro/net/protocol.py`` (numpy, the reference's code).

The paper compares two extremes (§III-B): a reliable protocol (retransmit
forever, Eq. 5) and an unreliable one (one shot, Eq. 4).  Three policies sit
behind one interface:

* ``UnreliableProtocol``: one transmission a packet; latency ``n_t * T``,
  partial delivery (Eq. 4);
* ``ARQProtocol``: round-based selective-repeat ARQ, the missing packets
  resent for up to ``max_rounds`` rounds or until ``deadline_slots`` slots
  are spent;
* ``HybridFECARQProtocol``: each round sends FEC-coded blocks
  (``net.fec``); a block is delivered when >= k of its k + m packets
  arrive, and unrecovered blocks are resent.

Each has ``latency_pmf`` / ``completion_latency_pmf`` (a DP over the
per-round binomial delivery at the stationary loss rate, generalising Eq.
4-5), ``expected_latency_s``, ``expected_delivery_rate`` and ``run_round``
(a stateful Monte-Carlo round against a bursty channel, the simulator's
path).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core import link as link_lib
from repro_torch.net import fec as fec_lib
from repro_torch.net.channels import Channel


@dataclasses.dataclass(frozen=True)
class RoundResult:
    """Outcome of one protocol round for one request."""

    delivered: np.ndarray            # bool (n_data_packets,)
    slots: int                       # total packet-slots spent on the air
    rounds: int                      # transmission rounds used

    @property
    def delivered_fraction(self) -> float:
        return float(np.mean(self.delivered))

    @property
    def complete(self) -> bool:
        return bool(np.all(self.delivered))


def latency_quantile(lat: np.ndarray, pmf: np.ndarray, q: float) -> float:
    """Quantile of a discrete latency PMF (support assumed sorted)."""
    return float(lat[min(np.searchsorted(np.cumsum(pmf), q), lat.size - 1)])


def _binom_pmf(n: int, p_success: float) -> np.ndarray:
    """PMF over number of successes in n i.i.d. trials (support 0..n)."""
    if n == 0:
        return np.ones(1)
    ks = np.arange(n + 1)
    if p_success <= 0.0:
        out = np.zeros(n + 1)
        out[0] = 1.0
        return out
    if p_success >= 1.0:
        out = np.zeros(n + 1)
        out[-1] = 1.0
        return out
    logp = (
        link_lib.log_binom_coeff(n, ks)
        + ks * np.log(p_success)
        + (n - ks) * np.log1p(-p_success)
    )
    pmf = np.exp(logp)
    return pmf / pmf.sum()


def _clamped_loss(channel_cfg: link_lib.ChannelConfig,
                  loss_rate: Optional[float]) -> float:
    """Resolve and clamp the loss rate into [0, 1].

    The PMF tail handling at the extremes is exact by construction
    (``_binom_pmf`` branches at p<=0 / p>=1 instead of exponentiating
    ``log(0)``), but callers feeding a chaos-ramped ``loss_rate`` can
    overshoot 1.0 by float error — without the clamp that turns the DP
    weights into NaN and feasibility into NaN instead of exactly 0."""
    p = channel_cfg.loss_rate if loss_rate is None else float(loss_rate)
    return min(max(p, 0.0), 1.0)


def _retry_dp(
    n_units: int,
    slots_per_unit: int,
    p_unit_fail: float,
    max_rounds: int,
    deadline_hit,
) -> Tuple[dict, dict]:
    """DP over (missing units, slots spent) shared by ARQ and FEC+ARQ.

    One "unit" is a packet (ARQ) or an FEC block (``slots_per_unit`` = k+m
    packet slots).  Returns ``(done_all, done_complete)``: terminal
    probability mass by slot count over ALL terminal states, and over the
    full-delivery (``missing == 0``) terminals only.  ``done_complete`` is
    sub-normalized — its missing mass is the failure probability.
    """
    dist = {(n_units, 0): 1.0}
    done_all: dict = {}
    done_ok: dict = {}

    def settle(miss: int, slots: int, prob: float) -> None:
        done_all[slots] = done_all.get(slots, 0.0) + prob
        if miss == 0:
            done_ok[slots] = done_ok.get(slots, 0.0) + prob

    for _ in range(max_rounds):
        nxt: dict = {}
        for (miss, slots), prob in dist.items():
            if miss == 0 or deadline_hit(slots):
                settle(miss, slots, prob)
                continue
            new_slots = slots + miss * slots_per_unit
            pmf = _binom_pmf(miss, 1.0 - p_unit_fail)
            for rec, pr in enumerate(pmf):
                if pr < 1e-15:
                    continue
                key = (miss - rec, new_slots)
                nxt[key] = nxt.get(key, 0.0) + prob * pr
        dist = nxt
        if not dist:
            break
    for (miss, slots), prob in dist.items():
        settle(miss, slots, prob)
    return done_all, done_ok


def _dist_arrays(done: dict, slot_time_s: float
                 ) -> Tuple[np.ndarray, np.ndarray]:
    slots = np.array(sorted(done))
    mass = np.array([done[s] for s in slots])
    return slots * slot_time_s, mass


class _ProtocolBase:
    name: str = "base"

    def latency_pmf(
        self, n_packets: int, channel_cfg: link_lib.ChannelConfig,
        loss_rate: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def completion_latency_pmf(
        self, n_packets: int, channel_cfg: link_lib.ChannelConfig,
        loss_rate: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Joint (full delivery, latency) distribution.

        Returns ``(lat_s, mass)`` where ``mass[i]`` is the probability that
        the exchange delivers the COMPLETE message and finishes at latency
        ``lat_s[i]`` — sub-normalized on purpose: ``mass.sum()`` is
        P(complete delivery) and the missing probability is the failure
        mass (deadline hit / retry budget exhausted with packets missing).
        Keeping the joint form instead of conditioning on success is what
        makes ``deadline_feasible`` exactly 0 (not 0/0 = NaN) when the
        success mass vanishes at ``loss_rate=1.0``.
        """
        raise NotImplementedError

    def expected_latency_s(
        self, n_packets: int, channel_cfg: link_lib.ChannelConfig,
        loss_rate: Optional[float] = None,
    ) -> float:
        lat, pmf = self.latency_pmf(n_packets, channel_cfg, loss_rate)
        return float(np.dot(lat, pmf))

    def run_round(self, rng, channel: Channel, state, n_packets: int
                  ) -> Tuple[RoundResult, object]:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# Unreliable (paper Eq. 4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class UnreliableProtocol(_ProtocolBase):
    """One shot per packet; latency is deterministic, delivery partial."""

    name: str = "unreliable"

    def latency_pmf(self, n_packets, channel_cfg, loss_rate=None):
        lat = np.array([n_packets * channel_cfg.slot_time_s()])
        return lat, np.ones(1)

    def completion_latency_pmf(self, n_packets, channel_cfg, loss_rate=None):
        p = _clamped_loss(channel_cfg, loss_rate)
        lat = np.array([n_packets * channel_cfg.slot_time_s()])
        # All n packets must survive the single shot; (1-p)^n is exactly 0
        # at p=1 and exactly 1 at p=0.
        return lat, np.array([(1.0 - p) ** n_packets])

    def expected_delivery_rate(self, n_packets: int, channel: Channel) -> float:
        return 1.0 - channel.stationary_loss_rate

    def run_round(self, rng, channel, state, n_packets):
        keep, state = channel.step(rng, state, n_packets)
        return RoundResult(keep.copy(), n_packets, 1), state


# ---------------------------------------------------------------------------
# ARQ with a retransmission/deadline budget
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ARQProtocol(_ProtocolBase):
    """Round-based selective-repeat ARQ.

    Round 1 transmits all ``n`` packets; round j retransmits the packets
    still missing.  Stops when everything is delivered, after ``max_rounds``
    rounds, or once ``deadline_slots`` packet-slots have been spent (the
    "ARQ-with-deadline" policy: latency is bounded, delivery best-effort).
    A large integer ``max_rounds`` budget (e.g. 60) with no deadline
    approaches the paper's reliable protocol to numerical precision
    (Eq. 5 is the n=1-per-slot special case of the same process).
    """

    max_rounds: int = 4
    deadline_slots: Optional[int] = None
    name: str = "arq"

    def _deadline_hit(self, slots: int) -> bool:
        return (
            self.deadline_slots is not None and slots >= self.deadline_slots
        )

    def latency_pmf(self, n_packets, channel_cfg, loss_rate=None):
        """DP over (round, missing count) at the stationary loss rate.

        State: number of packets still missing entering round j.  Latency
        accumulated = sum over rounds of (missing_j) slots; we track the
        joint distribution of (missing, slots spent).
        """
        p = _clamped_loss(channel_cfg, loss_rate)
        done, _ = _retry_dp(
            n_packets, 1, p, self.max_rounds, self._deadline_hit
        )
        lat, pmf = _dist_arrays(done, channel_cfg.slot_time_s())
        return lat, pmf / pmf.sum()

    def completion_latency_pmf(self, n_packets, channel_cfg, loss_rate=None):
        p = _clamped_loss(channel_cfg, loss_rate)
        _, ok = _retry_dp(
            n_packets, 1, p, self.max_rounds, self._deadline_hit
        )
        return _dist_arrays(ok, channel_cfg.slot_time_s())

    def expected_delivery_rate(self, n_packets: int, channel: Channel) -> float:
        """Per-packet delivery 1 - p^rounds, where the round count honors
        the deadline budget via a mean-field slot estimate.  With no
        deadline this is exactly 1 - p^max_rounds, independent of n."""
        p = channel.stationary_loss_rate
        rounds = 0
        slots = 0.0
        missing = float(n_packets)
        for _ in range(self.max_rounds):
            if self._deadline_hit(int(slots)):
                break
            rounds += 1
            slots += missing
            missing *= p
        return 1.0 - p ** max(rounds, 1)

    def run_round(self, rng, channel, state, n_packets):
        delivered = np.zeros(n_packets, dtype=bool)
        slots = 0
        rounds = 0
        for _ in range(self.max_rounds):
            missing = np.flatnonzero(~delivered)
            if missing.size == 0 or self._deadline_hit(slots):
                break
            rounds += 1
            keep, state = channel.step(rng, state, missing.size)
            delivered[missing[keep]] = True
            slots += missing.size
        return RoundResult(delivered, slots, max(rounds, 1)), state


# ---------------------------------------------------------------------------
# Hybrid FEC + ARQ
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HybridFECARQProtocol(_ProtocolBase):
    """FEC-coded rounds with block-level retransmission.

    Each round transmits the unrecovered blocks' full codewords (k data +
    m parity packets, ``net.fec``); a block is recovered when ≥ k of
    its packets arrive.  Up to ``max_rounds`` rounds.
    """

    fec: fec_lib.FECSpec = dataclasses.field(default_factory=fec_lib.FECSpec)
    max_rounds: int = 2
    name: str = "fec_arq"

    def _block_fail_prob(self, p: float) -> float:
        km = self.fec.block_packets
        pmf = _binom_pmf(km, 1.0 - p)           # over received count
        return float(pmf[: self.fec.k].sum())   # received < k -> unrecoverable

    def latency_pmf(self, n_packets, channel_cfg, loss_rate=None):
        """DP over number of unrecovered blocks per round (stationary p)."""
        p = _clamped_loss(channel_cfg, loss_rate)
        done, _ = _retry_dp(
            self.fec.num_blocks(n_packets), self.fec.block_packets,
            self._block_fail_prob(p), self.max_rounds, lambda s: False,
        )
        lat, pmf = _dist_arrays(done, channel_cfg.slot_time_s())
        return lat, pmf / pmf.sum()

    def completion_latency_pmf(self, n_packets, channel_cfg, loss_rate=None):
        """Full delivery at the block-DP granularity: every block recovered
        (>= k of its packets arrived in some round).  The rare partial
        path — all k data packets of an unrecovered block arriving across
        rounds — is ignored, consistent with ``latency_pmf``."""
        p = _clamped_loss(channel_cfg, loss_rate)
        _, ok = _retry_dp(
            self.fec.num_blocks(n_packets), self.fec.block_packets,
            self._block_fail_prob(p), self.max_rounds, lambda s: False,
        )
        return _dist_arrays(ok, channel_cfg.slot_time_s())

    def expected_delivery_rate(self, n_packets: int, channel: Channel) -> float:
        pfail = self._block_fail_prob(channel.stationary_loss_rate)
        resid = fec_lib.residual_loss_rate(self.fec, channel)
        # After max_rounds block retries the unrecovered fraction is
        # pfail^max_rounds, within which the data-loss fraction is resid/pfail
        # per round; a simple tight bound: 1 - residual^rounds behaviour.
        return float(1.0 - resid * pfail ** (self.max_rounds - 1))

    def run_round(self, rng, channel, state, n_packets):
        spec = self.fec
        n_blocks = spec.num_blocks(n_packets)
        km = spec.block_packets
        # Per-block: data-packet delivery after decode.
        block_ok = np.zeros(n_blocks, dtype=bool)
        data_keep = np.zeros((n_blocks, spec.k), dtype=bool)
        slots = 0
        rounds = 0
        for _ in range(self.max_rounds):
            todo = np.flatnonzero(~block_ok)
            if todo.size == 0:
                break
            rounds += 1
            keep, state = channel.step(rng, state, todo.size * km)
            keep = keep.reshape(todo.size, km)
            for n, b in enumerate(todo):
                if keep[n].sum() >= spec.k:
                    block_ok[b] = True
                    data_keep[b] = True      # decoder restores all k exactly
                else:
                    data_keep[b] |= keep[n, : spec.k]
            slots += todo.size * km
        delivered = data_keep.reshape(-1)[:n_packets]
        return RoundResult(delivered, slots, max(rounds, 1)), state


# ---------------------------------------------------------------------------
# Deadline feasibility
# ---------------------------------------------------------------------------

def deadline_feasible(
    protocol: _ProtocolBase,
    n_packets: int,
    channel_cfg: link_lib.ChannelConfig,
    deadline_s: float,
    loss_rate: Optional[float] = None,
) -> float:
    """P(the protocol delivers the FULL message within ``deadline_s``).

    Computed from the analytic completion PMFs, so it is the scheduler's
    early-expiry oracle: a queued request whose remaining deadline budget
    makes this (near) zero can be rejected before burning decode steps or
    air time.  Independently useful for capacity planning.

    Exactness at the extremes (regression-tested):

    * ``loss_rate=0.0`` — every packet lands in round one, so any deadline
      covering the first-shot latency gives exactly 1.0.
    * ``loss_rate=1.0`` — the success mass is zero.  The naive estimator
      P(lat <= d | complete) would divide 0/0 = NaN here; summing the
      *joint* completion mass instead returns exactly 0.0.
    """
    if deadline_s < 0.0:
        return 0.0
    lat, mass = protocol.completion_latency_pmf(
        n_packets, channel_cfg, loss_rate
    )
    if lat.size == 0:
        return 0.0
    # Tolerate float fuzz in slots * slot_time sums at the boundary.
    total = float(mass[lat <= deadline_s * (1.0 + 1e-12) + 1e-15].sum())
    return min(max(total, 0.0), 1.0)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

PROTOCOLS = {
    "unreliable": UnreliableProtocol,
    "arq": ARQProtocol,
    "fec_arq": HybridFECARQProtocol,
}


def make_protocol(name: str, **params) -> _ProtocolBase:
    key = name.lower()
    if key not in PROTOCOLS:
        raise ValueError(
            f"unknown protocol {name!r}; available: {sorted(PROTOCOLS)}"
        )
    if key == "fec_arq" and "fec" in params and isinstance(params["fec"], dict):
        params = dict(params, fec=fec_lib.FECSpec(**params["fec"]))
    return PROTOCOLS[key](**params)
