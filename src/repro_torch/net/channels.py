"""Packet-loss channel processes, the port's twin of ``repro/net/channels.py``:
the paper's i.i.d. channel, the Gilbert–Elliott two-state burst channel, the
distance-driven Markov fading channel and trace replay, behind one
``Channel`` interface.

Every channel has both execution styles of the reference:

* **NumPy stateful** (``init_state`` / ``step``): the simulator advances each
  client's channel packet by packet across rounds; the same code as the
  reference's, so one ``RandomState`` gives the same draws;
* **functional** (``packet_keep`` / ``element_keep``): one mask a message on
  the key's device, from a stationary-sampled state, with the reference's
  key use, so every mask is bit-equal to its ``packet_keep_jnp``.  The
  sequential chains (Gilbert–Elliott, fading) compute each state's keep
  decision and next state for all packets at once, then walk the state with
  one small op a packet.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from repro_torch import prng
from repro_torch.core.link import element_mask_from_packets


@runtime_checkable
class Channel(Protocol):
    """Common interface of all channel processes."""

    @property
    def stationary_loss_rate(self) -> float: ...

    def init_state(self, rng: np.random.RandomState): ...

    def step(self, rng: np.random.RandomState, state, n_packets: int) -> Tuple[np.ndarray, object]:
        """Advance the process by ``n_packets`` transmissions: (keep bool
        (n_packets,), new_state)."""
        ...

    def packet_keep(self, key: torch.Tensor, n_packets: int) -> torch.Tensor:
        """Keep mask (float32 0/1, (n_packets,)) of one message, on the
        key's device, the hidden state drawn from the stationary law."""
        ...


class _ChannelBase:
    """Element-granularity plumbing on top of ``packet_keep``."""

    def element_keep(self, key: torch.Tensor, num_elements: int, elements_per_packet: int,
                     shuffle: bool = False) -> torch.Tensor:
        kperm, kmask = prng.split(key)
        n_packets = -(-num_elements // elements_per_packet)
        pkt = self.packet_keep(kmask, n_packets)
        return element_mask_from_packets(pkt, num_elements, elements_per_packet, kperm, shuffle)

    def mean_loss_over(self, rng: np.random.RandomState, n_packets: int) -> float:
        """Empirical loss rate over one long stateful run (test helper)."""
        state = self.init_state(rng)
        keep, _ = self.step(rng, state, n_packets)
        return 1.0 - float(np.mean(keep))


@dataclasses.dataclass(frozen=True)
class IIDChannel(_ChannelBase):
    """Memoryless Bernoulli packet loss — the paper's Eq. (1)-(3)."""

    loss_rate: float = 0.1

    @property
    def stationary_loss_rate(self) -> float:
        return float(self.loss_rate)

    def init_state(self, rng: np.random.RandomState):
        return None

    def step(self, rng, state, n_packets: int):
        keep = rng.rand(n_packets) >= self.loss_rate
        return keep, state

    def packet_keep(self, key: torch.Tensor, n_packets: int) -> torch.Tensor:
        return prng.bernoulli(key, 1.0 - self.loss_rate, (n_packets,)).to(torch.float32)


@dataclasses.dataclass(frozen=True)
class GilbertElliottChannel(_ChannelBase):
    """Two-state Markov chain: Good (loss ``loss_good``) / Bad (``loss_bad``);
    per packet G->B with prob ``p_gb``, B->G with ``p_bg``.  Stationary
    loss ``pi_g * loss_good + pi_b * loss_bad``, mean burst ``1 / p_bg``."""

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
        sojourn ``burst_len`` packets; past p_gb = 1 the bursts lengthen so
        the rate stays exact (as the reference constructs it)."""
        span = loss_bad - loss_good
        assert span > 1e-9, "loss_bad must exceed loss_good"
        pi_b = min(max((loss_rate - loss_good) / span, 0.0), 0.999)
        p_bg = 1.0 / max(burst_len, 1.0)
        p_gb = p_bg * pi_b / max(1.0 - pi_b, 1e-9)
        if p_gb > 1.0:
            p_gb = 1.0
            p_bg = (1.0 - pi_b) / pi_b
        return cls(p_gb=p_gb, p_bg=p_bg, loss_good=loss_good, loss_bad=loss_bad)

    def init_state(self, rng: np.random.RandomState):
        return bool(rng.rand() < self.pi_bad)  # True = Bad

    def step(self, rng, state: bool, n_packets: int):
        keep = np.empty(n_packets, dtype=bool)
        bad = state
        u_loss = rng.rand(n_packets)
        u_tr = rng.rand(n_packets)
        for t in range(n_packets):
            p = self.loss_bad if bad else self.loss_good
            keep[t] = u_loss[t] >= p
            if bad:
                bad = u_tr[t] >= self.p_bg
            else:
                bad = u_tr[t] < self.p_gb
        return keep, bad

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


@dataclasses.dataclass(frozen=True)
class FadingMarkovChannel(_ChannelBase):
    """Finite-state Markov channel over quantized Rayleigh fading levels.

    Mean SNR from log-distance path loss,
        snr_db = tx_power_dbm - (pl0_db + 10 pl_exp log10(d / 1 m)) - noise_dbm;
    state k scales it by a gain log-spaced over -10..+5 dB, and loses a
    packet with the block-fading outage p_k = 1 - exp(-gamma_th / snr_k).
    The chain is birth-death: each packet moves to an adjacent level with
    probability ``agility / 2`` each way.
    """

    distance_m: float = 50.0
    tx_power_dbm: float = 14.0      # typical IoT radio
    noise_dbm: float = -90.0
    pl0_db: float = 40.0            # path loss at d0 = 1 m
    pl_exp: float = 3.0             # indoor/urban exponent
    gamma_th_db: float = 3.0        # SNR threshold for packet success
    n_states: int = 4
    agility: float = 0.25

    @property
    def mean_snr_db(self) -> float:
        pl = self.pl0_db + 10.0 * self.pl_exp * np.log10(max(self.distance_m, 1.0))
        return float(self.tx_power_dbm - pl - self.noise_dbm)

    def _state_loss_rates(self) -> np.ndarray:
        """Per-state packet loss p_k, states ordered deep fade -> strong."""
        snr_lin = 10.0 ** (self.mean_snr_db / 10.0)
        gamma_th = 10.0 ** (self.gamma_th_db / 10.0)
        gains_db = np.linspace(-10.0, 5.0, self.n_states)
        snr_k = snr_lin * 10.0 ** (gains_db / 10.0)
        return 1.0 - np.exp(-gamma_th / np.maximum(snr_k, 1e-9))

    def _transition_matrix(self) -> np.ndarray:
        k, a = self.n_states, self.agility
        tm = np.zeros((k, k))
        for i in range(k):
            up = a / 2 if i + 1 < k else 0.0
            dn = a / 2 if i > 0 else 0.0
            tm[i, i] = 1.0 - up - dn
            if i + 1 < k:
                tm[i, i + 1] = up
            if i > 0:
                tm[i, i - 1] = dn
        return tm

    @property
    def stationary_loss_rate(self) -> float:
        _, losses, pi = _fading_tables(self)
        return float(np.dot(pi, losses))

    def init_state(self, rng: np.random.RandomState):
        cum_pi = np.cumsum(_fading_tables(self)[2])
        return int(min(np.searchsorted(cum_pi, rng.rand()), self.n_states - 1))

    def step(self, rng, state: int, n_packets: int):
        cum_tm, losses, _ = _fading_tables(self)
        u_loss = rng.rand(n_packets)
        u_tr = rng.rand(n_packets)
        keep = np.empty(n_packets, dtype=bool)
        s = state
        for t in range(n_packets):
            keep[t] = u_loss[t] >= losses[s]
            s = int(min(np.searchsorted(cum_tm[s], u_tr[t]), self.n_states - 1))
        return keep, s

    def packet_keep(self, key: torch.Tensor, n_packets: int) -> torch.Tensor:
        """The reference's draw on f32 tables: the initial state is the
        left-sided search of ``uniform(kinit)`` in the f32 cumulative
        stationary law, each packet keeps when ``uniform(kloss) >= p_s`` and
        moves to the left-sided search of ``uniform(ktr)`` in row s of the
        f32 cumulative transition matrix (both clipped to the last state)."""
        cum_tm, losses, cum_pi = (torch.from_numpy(t).to(key.device) for t in _fading_tables_f32(self))
        kinit, kloss, ktr = prng.split(key, 3)
        top = self.n_states - 1
        s0 = torch.clamp(torch.searchsorted(cum_pi, prng.uniform(kinit, ()).reshape(1)), max=top)[0]
        u_loss = prng.uniform(kloss, (n_packets,))
        u_tr = prng.uniform(ktr, (n_packets,))
        keep_tab = u_loss[None, :] >= losses[:, None]                                   # (K, n)
        next_tab = torch.clamp(torch.searchsorted(cum_tm, u_tr.expand(self.n_states, n_packets).contiguous()),
                               max=top)                                                 # (K, n)
        return markov_walk(s0, keep_tab, next_tab).to(torch.float32)


def markov_walk(s0: torch.Tensor, keep_tab: torch.Tensor, next_tab: torch.Tensor) -> torch.Tensor:
    """Walk a chain over precomputed tables: ``keep_tab[s, t]`` is packet
    t's keep decision in state s, ``next_tab[s, t]`` its next state.  One
    gather a packet; returns the walk's keep decisions (n,)."""
    n = keep_tab.shape[1]
    nxt = next_tab.t().contiguous()
    s = s0
    states = []
    for t in range(n):
        states.append(s)
        s = nxt[t][s]
    if not states:
        return keep_tab.new_zeros((0,))
    seq = torch.stack(states)
    return keep_tab.t()[torch.arange(n, device=keep_tab.device), seq]


@functools.lru_cache(maxsize=64)
def _fading_tables(ch: FadingMarkovChannel):
    """(cumulative transition matrix, per-state loss rates, stationary
    distribution) in f64, cached per frozen channel so the simulator's
    per-packet loop never rebuilds them."""
    tm = ch._transition_matrix()
    losses = ch._state_loss_rates()
    pi = np.full(ch.n_states, 1.0 / ch.n_states)
    for _ in range(500):
        pi = pi @ tm
    pi = pi / pi.sum()
    return np.cumsum(tm, axis=1), losses, pi


@functools.lru_cache(maxsize=64)
def _fading_tables_f32(ch: FadingMarkovChannel):
    """The functional mask's f32 tables: the f64 cumulative transition
    matrix and loss rates rounded to f32, and the cumulative stationary law
    summed in f32 from left to right (the order XLA's cumsum takes)."""
    cum_tm, losses, pi = _fading_tables(ch)
    pi32 = pi.astype(np.float32)
    cum_pi = np.empty_like(pi32)
    acc = np.float32(0.0)
    for i, v in enumerate(pi32):
        acc = np.float32(acc + v)
        cum_pi[i] = acc
    return cum_tm.astype(np.float32), losses.astype(np.float32), cum_pi


@dataclasses.dataclass(frozen=True)
class TraceChannel(_ChannelBase):
    """Replays a recorded loss trace (1 = packet delivered, 0 = lost),
    cycling when it is exhausted.  State = replay position."""

    keep_trace: tuple = ()           # tuple of 0/1 ints (hashable/frozen)

    @staticmethod
    def from_array(trace) -> "TraceChannel":
        arr = np.asarray(trace).astype(np.int32).reshape(-1)
        assert arr.size > 0, "empty trace"
        return TraceChannel(keep_trace=tuple(int(v) for v in arr))

    @property
    def stationary_loss_rate(self) -> float:
        arr = np.asarray(self.keep_trace)
        return float(1.0 - arr.mean()) if arr.size else 0.0

    def init_state(self, rng: np.random.RandomState):
        return int(rng.randint(len(self.keep_trace)))  # random phase

    def step(self, rng, state: int, n_packets: int):
        arr = _trace_array(self)
        idx = (state + np.arange(n_packets)) % arr.size
        return arr[idx], int((state + n_packets) % arr.size)

    def packet_keep(self, key: torch.Tensor, n_packets: int) -> torch.Tensor:
        """The trace from a start drawn as ``randint(key, (), 0, len)``."""
        arr = _trace_array(self)
        trace = torch.from_numpy(arr.astype(np.float32)).to(key.device)
        start = prng.randint(key, (), 0, arr.size).to(torch.int64)
        idx = (start + torch.arange(n_packets, device=key.device)) % arr.size
        return trace[idx]


@functools.lru_cache(maxsize=64)
def _trace_array(ch: TraceChannel) -> np.ndarray:
    """The trace as a bool ndarray, cached per frozen channel (``step`` runs
    once a protocol round)."""
    return np.asarray(ch.keep_trace, dtype=bool)


CHANNELS = {
    "iid": IIDChannel,
    "gilbert_elliott": GilbertElliottChannel,
    "ge": GilbertElliottChannel,
    "fading": FadingMarkovChannel,
    "trace": TraceChannel,
}


def supports_target_rate(name: str, params=()) -> bool:
    """True when ``make_channel(name, loss_rate=p, **params)`` hits the
    target stationary rate ``p``, so a loss-rate curriculum over it means
    something: the i.i.d. channel, and a GE channel not pinned by explicit
    ``p_gb`` / ``p_bg``.  ``fading`` and ``trace`` take their loss from
    their own physics or recording."""
    key = name.lower()
    if key in ("ge", "gilbert_elliott"):
        pd = dict(params)
        return "p_gb" not in pd and "p_bg" not in pd
    return key == "iid"


def make_channel(name: str, loss_rate: float = 0.1, **params) -> Channel:
    """Build a channel by registry name.  ``loss_rate`` is the i.i.d. rate,
    and for ``ge`` the stationary rate of a burst-4 Gilbert construction
    (unless ``p_gb`` / ``p_bg`` are given); ``fading`` and ``trace`` ignore
    it for their own parameters."""
    key = name.lower()
    if key not in CHANNELS:
        raise ValueError(f"unknown channel {name!r}; available: {sorted(set(CHANNELS))}")
    if key in ("ge", "gilbert_elliott"):
        params.pop("loss_rate", None)
        if "p_gb" in params or "p_bg" in params:
            return GilbertElliottChannel(**params)
        return GilbertElliottChannel.from_target(loss_rate, **params)
    if key == "iid":
        return IIDChannel(loss_rate=params.pop("loss_rate", loss_rate))
    if key == "fading":
        return FadingMarkovChannel(**params)
    if "keep_trace" in params:
        return TraceChannel(keep_trace=tuple(params["keep_trace"]))
    raise ValueError("trace channel requires keep_trace=...")
