"""Mamba selective-SSM block, jamba's recurrent layer (twin of
``repro/models/mamba.py``).

Prefill runs the chunked selective scan: chunks of ``cfg.scan_chunk``
positions, each chunk's decays ``exp(dt A)`` and increments ``dt B x``
formed as ``(B, L, d_inner, d_state)`` tensors and handed, as the ``(B, L,
d_inner * d_state)`` view, to the linear-recurrence scan
``kernels.ssm_scan`` (the hand CUDA kernel on the card, its plain version
on a CPU tensor), which returns every prefix state from the carried one;
under autograd its gradient is the hand backward kernel on the card.
The reference runs the same recurrence as a ``lax.associative_scan`` a
chunk (its docstring names the Pallas kernel as implementing it); the two
differ by rounding only.  Decode is one recurrent update of the carried
``(conv, ssm)`` state.

The layer writes its cache in place, as ``Attention`` does, and keeps the
reference's parameter names and layouts (``x @ w``), so that
``params.params_from_jax`` maps them as they are.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ssm_scan import ssm_scan
from repro_torch.models.common import dense_std, frozen, softplus, trunc_normal_, upcast

Cache = Dict[str, torch.Tensor]


def init_mamba_cache(batch: int, cfg: ModelConfig, dtype, device) -> Cache:
    """The last ``d_conv - 1`` conv inputs in the model dtype and the SSM
    state in f32, both zero."""
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.mamba_d_inner), dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.mamba_d_inner, cfg.mamba_d_state), dtype=torch.float32, device=device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time, x (B, S, di), w (dc, di): the
    reference's sum of shifted products in the activation dtype, tap by tap
    from zero, then the bias (a depthwise ``F.conv1d`` sums in another
    order, which rounds otherwise in bf16)."""
    dc, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, dc - 1, 0))
    out = torch.zeros_like(x)
    for j in range(dc):
        out = out + pad[:, j:j + s] * w[j]
    return out + b


def _conv_step(x_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor,
               b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x_t (B, di), conv_state (B, dc-1, di) the previous inputs -> (the
    conv output (B, di), the new state)."""
    window = torch.cat([conv_state, x_t[:, None, :]], dim=1)         # (B, dc, di)
    out = torch.einsum("bcd,cd->bd", window, w) + b
    return out, window[:, 1:]


def _chunked_selective_scan(dt: torch.Tensor, a: torch.Tensor, b_ssm: torch.Tensor, c_ssm: torch.Tensor,
                            x: torch.Tensor, chunk: int,
                            h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dt (B, S, di), a (di, N), b_ssm / c_ssm (B, S, N), x (B, S, di), all
    f32 (f64 in the gradient oracle); h0 (B, di, N) -> (y (B, S, di),
    h_final (B, di, N)).

    One ``ssm_scan`` call a chunk of ``min(chunk, S)`` positions, from the
    state the chunk before left.  The last chunk scans its real rows only:
    the reference pads it with ``dt = 0`` rows (``a = 1``, ``b = 0``), which
    leave the state as it is, and drops their outputs.

    Under autograd each call goes through ``SSMScanFunction`` (B6 forward,
    B6' backward on the card).  The carried ``h = h_all[:, -1]`` is a view
    of a chunk's output, so the ``dh0`` of the chunk after adds to that
    chunk's last row of ``dy``.  What a chunk of ``L`` rows holds for the
    backward, at ``M = B * L * di * N`` f32 elements: the decays ``da``
    (saved by the Function and by ``exp``, one tensor), the states
    ``h_all`` (saved by the Function and by the ``einsum`` with C, one
    tensor) and the product ``dt * B`` (saved by the multiply by ``x``),
    so 3 M; ``dbx`` is not kept.  At jamba's training chunk (B 2, L 256,
    di 8192, N 16) that is 3 x 268 MB a chunk."""
    bsz, s, di = x.shape
    n = a.shape[-1]
    chunk = min(chunk, s)
    h = (h0.reshape(bsz, di * n) if h0 is not None
         else torch.zeros((bsz, di * n), dtype=x.dtype, device=x.device))
    ys = []
    for lo in range(0, s, chunk):
        hi = min(lo + chunk, s)
        dt_c = dt[:, lo:hi, :, None]
        da = torch.exp(dt_c * a)                                             # (B, L, di, N)
        dbx = dt_c * b_ssm[:, lo:hi, None, :] * x[:, lo:hi, :, None]         # (B, L, di, N)
        h_all = ssm_scan(da.reshape(bsz, hi - lo, di * n), dbx.reshape(bsz, hi - lo, di * n), h)
        ys.append(torch.einsum("bsdn,bsn->bsd", h_all.reshape(bsz, hi - lo, di, n), c_ssm[:, lo:hi]))
        h = h_all[:, -1]
    return torch.cat(ys, dim=1), h.reshape(bsz, di, n)


class Mamba(nn.Module):
    """``in_proj`` (d, 2 di), ``conv_w`` (d_conv, di), ``conv_b`` (di,),
    ``x_proj`` (di, dt_rank + 2 N), ``dt_proj`` (dt_rank, di), ``dt_bias``
    (di,), ``A_log`` (di, N) f32, ``D`` (di,), ``out_proj`` (di, d)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, di, n = cfg.d_model, cfg.mamba_d_inner, cfg.mamba_d_state
        r, dc = cfg.mamba_dt_rank, cfg.mamba_d_conv
        self.in_proj = frozen((d, 2 * di), dtype, device)
        self.conv_w = frozen((dc, di), dtype, device)
        self.conv_b = frozen((di,), dtype, device)
        self.x_proj = frozen((di, r + 2 * n), dtype, device)
        self.dt_proj = frozen((r, di), dtype, device)
        self.dt_bias = frozen((di,), dtype, device)
        self.A_log = frozen((di, n), torch.float32, device)
        self.D = frozen((di,), dtype, device)
        self.out_proj = frozen((di, d), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's ``init_mamba``: fan-in truncated normals (the
        conv at scale 1 over its d_conv taps), ``dt_bias`` -4.6
        (softplus^-1 of ~0.01), the S4D-real ``A_log = log(1..N)`` a row,
        ``D`` ones."""
        for w in (self.in_proj, self.conv_w, self.x_proj, self.dt_proj, self.out_proj):
            trunc_normal_(w, dense_std(w.shape), gen)
        nn.init.zeros_(self.conv_b)
        nn.init.constant_(self.dt_bias, -4.6)
        with torch.no_grad():
            n = self.A_log.shape[1]
            self.A_log.copy_(torch.log(torch.arange(1, n + 1, dtype=torch.float32, device=self.A_log.device)))
        nn.init.ones_(self.D)

    def _ssm_params(self, x_conv: torch.Tensor, cfg: ModelConfig):
        """x_conv (..., di) -> dt (..., di) f32 (softplus in f32), A (di, N),
        B and C (..., N) f32."""
        r, n = cfg.mamba_dt_rank, cfg.mamba_d_state
        dt_low, b_ssm, c_ssm = torch.split(x_conv @ self.x_proj, [r, n, n], dim=-1)
        dt = softplus(upcast(dt_low @ self.dt_proj) + upcast(self.dt_bias))
        return dt, -torch.exp(self.A_log), upcast(b_ssm), upcast(c_ssm)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, cache: Optional[Cache] = None) -> torch.Tensor:
        """x (B, S, d) -> (B, S, d).  With a cache, one position takes the
        decode step and more take the chunked prefill from the carried
        state; either writes the new state into the cache."""
        s = x.shape[1]
        x_in, z = torch.chunk(x @ self.in_proj, 2, dim=-1)
        if cache is not None and s == 1:
            x_conv, conv_state = _conv_step(x_in[:, 0], cache["conv"].to(x_in.dtype), self.conv_w, self.conv_b)
            x_conv = F.silu(x_conv)
            dt, a, b_ssm, c_ssm = self._ssm_params(x_conv, cfg)                 # dt (B, di); B, C (B, N)
            xf = upcast(x_conv)
            da = torch.exp(dt[..., None] * a)                                    # (B, di, N)
            dbx = dt[..., None] * b_ssm[:, None, :] * xf[..., None]
            h = da * cache["ssm"] + dbx
            y = torch.einsum("bdn,bn->bd", h, c_ssm) + upcast(self.D) * xf
            out = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None, :]
            cache["conv"].copy_(conv_state)
            cache["ssm"].copy_(h)
            return out @ self.out_proj

        x_conv = F.silu(_causal_conv(x_in, self.conv_w, self.conv_b))
        dt, a, b_ssm, c_ssm = self._ssm_params(x_conv, cfg)
        xf = upcast(x_conv)
        y, h_final = _chunked_selective_scan(dt, a, b_ssm, c_ssm, xf, cfg.scan_chunk,
                                             h0=cache["ssm"] if cache is not None else None)
        y = y + upcast(self.D) * xf
        out = y.to(x.dtype) * F.silu(z)
        if cache is not None:
            dc = cfg.mamba_d_conv
            tail = x_in[:, -(dc - 1):]
            if s < dc - 1:
                tail = torch.cat([cache["conv"].to(x_in.dtype)[:, s:], x_in], dim=1)
            cache["conv"].copy_(tail)
            cache["ssm"].copy_(h_final)
        return out @ self.out_proj
