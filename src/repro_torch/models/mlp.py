"""Dense FFN: SwiGLU (silu) / GeGLU (gelu) gated, or a plain two-layer MLP
(twin of ``repro/models/mlp.py``), with the reference's ``x @ w`` layout."""

from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.models.common import activation, dense_std, frozen, trunc_normal_


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated: bool, act: str, dtype, device):
        super().__init__()
        self.act = activation(act)
        self.w_up = frozen((d_model, d_ff), dtype, device)
        self.w_down = frozen((d_ff, d_model), dtype, device)
        self.w_gate = frozen((d_model, d_ff), dtype, device) if gated else None

    def reset_parameters(self, gen: torch.Generator) -> None:
        for w in (self.w_up, self.w_down, self.w_gate):
            if w is not None:
                trunc_normal_(w, dense_std(w.shape), gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        up = x @ self.w_up
        if self.w_gate is not None:
            up = self.act(x @ self.w_gate) * up
        else:
            up = self.act(up)
        return up @ self.w_down
