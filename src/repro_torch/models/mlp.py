"""Dense FFN: SwiGLU (silu) / GeGLU (gelu) gated, or a plain two-layer MLP
(twin of ``repro/models/mlp.py``), with the reference's ``x @ w`` layout.

Tensor parallel (``sharding.ctx.use_tensor_parallel``): when ``w_up`` /
``w_gate`` hold this rank's ``d_ff / m`` columns and ``w_down`` the
matching rows, the layer computes that slice and sums over ``model``."""

from __future__ import annotations

import torch
import torch.nn as nn

from repro_torch.models.common import activation, dense_std, frozen, trunc_normal_
from repro_torch.sharding import ctx as shard_ctx


class MLP(nn.Module):
    def __init__(self, d_model: int, d_ff: int, gated: bool, act: str, dtype, device):
        super().__init__()
        self.act = activation(act)
        self.d_ff = d_ff
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
        y = up @ self.w_down
        return y if self.w_up.shape[1] == self.d_ff else shard_ctx.sum_over_model(y)
