"""xLSTM blocks (arXiv:2405.04517), twin of ``repro/models/xlstm.py``:
mLSTM (matrix memory, parallelisable) and sLSTM (scalar memory with
recurrent gate connections).

mLSTM prefill runs the chunkwise-parallel form (``mlstm_chunked``): a loop
over chunks of ``cfg.scan_chunk`` positions carrying the recurrent
``(C, n, m)`` state, quadratic work only within a chunk; the fully
parallel form (``mlstm_parallel``) and the closed-form state
(``mlstm_final_state``) are kept beside it.  Decode is the exact recurrent
update (``mlstm_step``).  sLSTM is sequential (h_{t-1} feeds the gates) and
runs as a loop over time.  The products are ``torch.einsum`` /
``torch.matmul`` in f32, as the reference leaves them to XLA outside any
Pallas kernel (in f64 for a model cast with ``.double()``, the gradient
oracle: every upcast is ``common.upcast``).

The functions take the layer module as ``p`` and return new state dicts;
the modules (``MLSTM``, ``SLSTM``) write a given cache in place, as the
port's other layers do.  Every state starts with its stabiliser ``m`` at
``NEG_INF``, not 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.common import acc_dtype, dense_std, frozen, log_sigmoid, rmsnorm, trunc_normal_, upcast

NEG_INF = -1.0e30
State = Dict[str, torch.Tensor]


def _copy_state(cache: State, state: State) -> None:
    for name, t in state.items():
        cache[name].copy_(t)


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm_cache(batch: int, cfg: ModelConfig, device, dtype=torch.float32) -> State:
    """A fresh state in f32 (``dtype`` f64 for the gradient oracle's)."""
    h, dh = cfg.num_heads, cfg.xlstm_head_dim
    return {
        "c": torch.zeros((batch, h, dh, dh), dtype=dtype, device=device),
        "n": torch.zeros((batch, h, dh), dtype=dtype, device=device),
        "m": torch.full((batch, h), NEG_INF, dtype=dtype, device=device),
    }


class MLSTM(nn.Module):
    """``wq``/``wk``/``wv``/``wo`` (d, H dh), the gate rows ``wi``/``wf``
    (d, H) and ``f_bias`` (H,), ``w_out`` (H dh, d), ``norm_scale`` (H dh,)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, dh = cfg.d_model, cfg.num_heads, cfg.xlstm_head_dim
        for name in ("wq", "wk", "wv"):
            setattr(self, name, frozen((d, h * dh), dtype, device))
        self.wi = frozen((d, h), dtype, device)
        self.wf = frozen((d, h), dtype, device)
        self.f_bias = frozen((h,), dtype, device)
        self.wo = frozen((d, h * dh), dtype, device)
        self.w_out = frozen((h * dh, d), dtype, device)
        self.norm_scale = frozen((h * dh,), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's ``init_mlstm``: the gate rows at 0.1 x fan-in, the
        forget bias 3 (open at init), the norm scale 0."""
        for w in (self.wq, self.wk, self.wv, self.wo, self.w_out):
            trunc_normal_(w, dense_std(w.shape), gen)
        for w in (self.wi, self.wf):
            trunc_normal_(w, 0.1 * dense_std(w.shape), gen)
        nn.init.constant_(self.f_bias, 3.0)
        nn.init.zeros_(self.norm_scale)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, cache: Optional[State] = None) -> torch.Tensor:
        """With a cache, one position takes the recurrent step; otherwise the
        chunked form runs from the cache's state (or a fresh one) and, with
        a cache, leaves its final state there."""
        if cache is not None and x.shape[1] == 1:
            out, state = mlstm_step(self, x, cfg, cache)
        else:
            out, state = mlstm_chunked(self, x, cfg, cache)
        if cache is not None:
            _copy_state(cache, state)
        return out


def _mlstm_qkv(p: MLSTM, x: torch.Tensor, cfg: ModelConfig):
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.xlstm_head_dim
    q = (x @ p.wq).reshape(b, s, h, dh)
    root = torch.sqrt(torch.tensor(float(dh), dtype=x.dtype, device=x.device))
    k = (x @ p.wk).reshape(b, s, h, dh) / root
    v = (x @ p.wv).reshape(b, s, h, dh)
    i_pre = upcast(x @ p.wi)                                                # (B, S, H)
    f_pre = upcast(x @ p.wf) + upcast(p.f_bias)
    o_gate = torch.sigmoid(x @ p.wo).reshape(b, s, h, dh)
    return q, k, v, i_pre, f_pre, o_gate


def _causal(n: int, device) -> torch.Tensor:
    t = torch.arange(n, device=device)
    return t[:, None] >= t[None, :]


def mlstm_parallel(p: MLSTM, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The stabilised parallel form: the decay matrix ``D_ts = F_t - F_s +
    i_s`` (s <= t) plays the attention matrix."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.xlstm_head_dim
    q, k, v, i_pre, f_pre, o_gate = _mlstm_qkv(p, x, cfg)
    f_cum = torch.cumsum(log_sigmoid(f_pre), dim=1)                         # F_t
    d_mat = f_cum[:, :, None, :] - f_cum[:, None, :, :] + i_pre[:, None, :, :]   # (B, T, S, H)
    d_mat = torch.where(_causal(s, x.device)[None, :, :, None], d_mat, NEG_INF)
    m = d_mat.amax(dim=2)                                                   # (B, T, H)
    decay = torch.exp(d_mat - m[:, :, None, :]).permute(0, 3, 1, 2)          # (B, H, T, S)
    weights = upcast(torch.einsum("bthd,bshd->bhts", q, k)) * decay
    norm = torch.maximum(weights.sum(dim=-1).abs(), torch.exp(-m.permute(0, 2, 1)))
    weights = weights / torch.clamp_min(norm, 1e-6)[..., None]
    h_out = torch.einsum("bhts,bshd->bthd", weights, upcast(v))
    h_out = h_out.to(x.dtype) * o_gate
    return rmsnorm(h_out.reshape(b, s, h * dh), p.norm_scale) @ p.w_out


def _mlstm_chunk(p: MLSTM, cfg: ModelConfig, carry: State, x_chunk: torch.Tensor, valid: torch.Tensor,
                 causal: torch.Tensor) -> Tuple[State, torch.Tensor]:
    """One chunk of ``mlstm_chunked``: the outputs (B, L, H, dh) from the
    intra-chunk decay and the carried state, and the state after the
    chunk in closed form.  Padded rows (``valid`` False) take ``f = 1``
    and ``i = NEG_INF``, so they leave the state as it is."""
    c_in, n_in, m_in = carry["c"], carry["n"], carry["m"]
    q, k, v, i_pre, f_pre, o_gate = _mlstm_qkv(p, x_chunk, cfg)
    vmask = valid[None, :, None]                                            # (1, L, 1)
    log_f = torch.where(vmask, log_sigmoid(f_pre), 0.0)
    i_pre = torch.where(vmask, i_pre, NEG_INF)
    f_cum = torch.cumsum(log_f, dim=1)                                      # (B, L, H)

    d_intra = f_cum[:, :, None, :] - f_cum[:, None, :, :] + i_pre[:, None, :, :]
    d_intra = torch.where(causal[None, :, :, None], d_intra, NEG_INF)
    m_cross = f_cum + m_in[:, None, :]                                      # (B, L, H)
    m_t = torch.maximum(d_intra.amax(dim=2), m_cross)
    w_intra = torch.exp(d_intra - m_t[:, :, None, :]).permute(0, 3, 1, 2)   # (B, H, T, S)
    intra = upcast(torch.einsum("bthd,bshd->bhts", q, k)) * w_intra

    cross_scale = torch.exp(m_cross - m_t)                                  # (B, L, H)
    qf = upcast(q)
    num_cross = torch.einsum("bhvk,bthk->bthv", c_in, qf) * cross_scale[..., None]
    qn_cross = torch.einsum("bhk,bthk->bth", n_in, qf) * cross_scale
    row_sum = intra.sum(dim=-1).permute(0, 2, 1)                            # (B, T, H)
    denom = torch.clamp_min(torch.maximum((row_sum + qn_cross).abs(), torch.exp(-m_t)), 1e-6)
    h_intra = torch.einsum("bhts,bshd->bthd", intra, upcast(v))
    h_out = ((h_intra + num_cross) / denom[..., None]).to(x_chunk.dtype) * o_gate

    f_total = f_cum[:, -1, :]                                               # (B, H)
    d_s = f_total[:, None, :] - f_cum + i_pre                               # (B, L, H)
    m_old = f_total + m_in
    m_new = torch.maximum(d_s.amax(dim=1), m_old)
    w_s = torch.exp(d_s - m_new[:, None, :])
    kf, vf = upcast(k), upcast(v)
    c_seq = torch.einsum("bsh,bshv,bshk->bhvk", w_s, vf, kf)
    n_seq = torch.einsum("bsh,bshk->bhk", w_s, kf)
    old_scale = torch.exp(m_old - m_new)
    state = {"c": old_scale[..., None, None] * c_in + c_seq, "n": old_scale[..., None] * n_in + n_seq, "m": m_new}
    return state, h_out


def mlstm_chunked(p: MLSTM, x: torch.Tensor, cfg: ModelConfig,
                  state: Optional[State] = None) -> Tuple[torch.Tensor, State]:
    """The chunkwise-parallel mLSTM: (output (B, S, d), final state).  The
    input is padded with zero rows to a whole number of chunks of
    ``min(cfg.scan_chunk, S)``, as the reference pads it."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.xlstm_head_dim
    chunk = max(1, min(cfg.scan_chunk, s))
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    valid = (torch.arange(nc * chunk, device=x.device) < s).reshape(nc, chunk)
    carry = state if state is not None else init_mlstm_cache(b, cfg, x.device, acc_dtype(x))
    causal = _causal(chunk, x.device)
    outs = []
    for i in range(nc):
        carry, h_out = _mlstm_chunk(p, cfg, carry, x[:, i * chunk:(i + 1) * chunk], valid[i], causal)
        outs.append(h_out)
    out = torch.cat(outs, dim=1).reshape(b, nc * chunk, h * dh)[:, :s]
    return rmsnorm(out, p.norm_scale) @ p.w_out, carry


def mlstm_final_state(p: MLSTM, x: torch.Tensor, cfg: ModelConfig, cache: State) -> State:
    """The recurrent state after consuming x in closed form (the prefill ->
    decode handoff): ``C_S = sum_s exp(F_S - F_s + i_s - m) v_s k_s^T``, the
    starting state folded in with decay ``exp(F_S + m_old - m)``."""
    _, k, v, i_pre, f_pre, _ = _mlstm_qkv(p, x, cfg)
    f_cum = torch.cumsum(log_sigmoid(f_pre), dim=1)
    f_total = f_cum[:, -1, :]                                               # F_S
    d_s = f_total[:, None, :] - f_cum + i_pre                               # (B, S, H)
    m_old = f_total + cache["m"]
    m_new = torch.maximum(d_s.amax(dim=1), m_old)
    w = torch.exp(d_s - m_new[:, None, :])
    kf, vf = upcast(k), upcast(v)
    c_seq = torch.einsum("bsh,bshv,bshk->bhvk", w, vf, kf)
    n_seq = torch.einsum("bsh,bshk->bhk", w, kf)
    old_scale = torch.exp(m_old - m_new)
    return {"c": old_scale[..., None, None] * cache["c"] + c_seq,
            "n": old_scale[..., None] * cache["n"] + n_seq, "m": m_new}


def mlstm_step(p: MLSTM, x: torch.Tensor, cfg: ModelConfig, cache: State) -> Tuple[torch.Tensor, State]:
    """The recurrent decode update, x (B, 1, d) -> (output, new state)."""
    b = x.shape[0]
    h, dh = cfg.num_heads, cfg.xlstm_head_dim
    q, k, v, i_pre, f_pre, o_gate = _mlstm_qkv(p, x, cfg)
    q, k, v = q[:, 0], k[:, 0], v[:, 0]                                     # (B, H, dh)
    i_pre, f_pre, o_gate = i_pre[:, 0], f_pre[:, 0], o_gate[:, 0]
    log_f = log_sigmoid(f_pre)                                              # (B, H)
    m_new = torch.maximum(log_f + cache["m"], i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + cache["m"] - m_new)
    kf, vf, qf = upcast(k), upcast(v), upcast(q)
    c_new = f_g[..., None, None] * cache["c"] + i_g[..., None, None] * (vf[..., :, None] * kf[..., None, :])
    n_new = f_g[..., None] * cache["n"] + i_g[..., None] * kf
    num = torch.einsum("bhvk,bhk->bhv", c_new, qf)
    qn = torch.einsum("bhk,bhk->bh", n_new, qf)
    denom = torch.maximum(qn.abs(), torch.exp(-m_new)) + 1e-6
    h_out = (num / denom[..., None]).to(x.dtype) * o_gate
    out = rmsnorm(h_out.reshape(b, 1, h * dh), p.norm_scale) @ p.w_out
    return out, {"c": c_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm_cache(batch: int, cfg: ModelConfig, device, dtype=torch.float32) -> State:
    """A fresh state in f32 (``dtype`` f64 for the gradient oracle's)."""
    h, dh = cfg.num_heads, cfg.xlstm_head_dim
    zeros = lambda: torch.zeros((batch, h, dh), dtype=dtype, device=device)   # noqa: E731
    return {"c": zeros(), "n": zeros(), "m": torch.full((batch, h, dh), NEG_INF, dtype=dtype, device=device),
            "h": zeros()}


class SLSTM(nn.Module):
    """Input rows ``wz``/``wi``/``wf``/``wo`` (d, H dh), block-diagonal
    recurrent ``rz``/``ri``/``rf``/``ro`` (H, dh, dh), ``f_bias`` (H dh,),
    ``w_out`` (H dh, d), ``norm_scale`` (H dh,)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, h, dh = cfg.d_model, cfg.num_heads, cfg.xlstm_head_dim
        for name in ("wz", "wi", "wf", "wo"):
            setattr(self, name, frozen((d, h * dh), dtype, device))
        for name in ("rz", "ri", "rf", "ro"):
            setattr(self, name, frozen((h, dh, dh), dtype, device))
        self.f_bias = frozen((h * dh,), dtype, device)
        self.w_out = frozen((h * dh, d), dtype, device)
        self.norm_scale = frozen((h * dh,), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's ``init_slstm``: input gates ``wi``/``wf`` at 0.1 x
        fan-in, the recurrent blocks at 0.5 x, forget bias 3, norm scale 0."""
        for w, scale in ((self.wz, 1.0), (self.wi, 0.1), (self.wf, 0.1), (self.wo, 1.0), (self.rz, 0.5),
                         (self.ri, 0.5), (self.rf, 0.5), (self.ro, 0.5), (self.w_out, 1.0)):
            trunc_normal_(w, scale * dense_std(w.shape), gen)
        nn.init.constant_(self.f_bias, 3.0)
        nn.init.zeros_(self.norm_scale)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, cache: Optional[State] = None) -> torch.Tensor:
        out, state = slstm_forward(self, x, cfg, cache)
        if cache is not None:
            _copy_state(cache, state)
        return out


def _slstm_cell(p: SLSTM, cfg: ModelConfig, x_t: torch.Tensor, state: State) -> State:
    """One sLSTM step from the input row x_t (B, d)."""
    b = x_t.shape[0]
    h, dh = cfg.num_heads, cfg.xlstm_head_dim
    h_prev = state["h"]                                                     # (B, H, dh) f32

    def rec(w):  # the block-diagonal recurrent product
        return torch.einsum("bhk,hkv->bhv", h_prev, upcast(w))

    xz = upcast((x_t @ p.wz).reshape(b, h, dh))
    xi = upcast((x_t @ p.wi).reshape(b, h, dh))
    xf = upcast(((x_t @ p.wf) + p.f_bias).reshape(b, h, dh))
    xo = upcast((x_t @ p.wo).reshape(b, h, dh))
    z = torch.tanh(xz + rec(p.rz))
    i_pre = xi + rec(p.ri)
    f_pre = xf + rec(p.rf)
    o = torch.sigmoid(xo + rec(p.ro))
    log_f = log_sigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + state["m"] - m_new)
    c_new = f_g * state["c"] + i_g * z
    n_new = f_g * state["n"] + i_g
    return {"c": c_new, "n": n_new, "m": m_new, "h": o * c_new / torch.clamp_min(n_new, 1e-6)}


def slstm_forward(p: SLSTM, x: torch.Tensor, cfg: ModelConfig,
                  cache: Optional[State] = None) -> Tuple[torch.Tensor, Optional[State]]:
    """Sequential over time for any S (decode is S == 1): (output, the final
    state when a cache was given, else None)."""
    b, s, _ = x.shape
    h, dh = cfg.num_heads, cfg.xlstm_head_dim
    state = cache if cache is not None else init_slstm_cache(b, cfg, x.device, acc_dtype(x))
    hs = []
    for t in range(s):
        state = _slstm_cell(p, cfg, x[:, t], state)
        hs.append(state["h"])
    out = torch.stack(hs, dim=1).to(x.dtype).reshape(b, s, h * dh)
    return rmsnorm(out, p.norm_scale) @ p.w_out, (state if cache is not None else None)
