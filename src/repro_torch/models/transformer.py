"""The decoder stack (twin of ``repro/models/transformer.py``), attention
layers only.

The reference scans ``U`` units of ``unit_pattern`` with stacked params;
the port unrolls them into one ``nn.ModuleList`` — layer
``len(prologue) + u * len(pattern) + j`` — and applies the COMtune link
after ``split = min(max(split_after_units, 0), U)`` units, as the
reference's two scan segments do.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.nn as nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.attention import Attention, Cache, Index
from repro_torch.models.common import RMSNorm
from repro_torch.models.mlp import MLP


def _has_ffn(cfg: ModelConfig, spec: LayerSpec) -> bool:
    return spec.moe or cfg.d_ff > 0


class Layer(nn.Module):
    """Pre-norm residual layer: attention, then the dense FFN."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, dtype, device):
        super().__init__()
        if spec.kind != "attn":
            raise NotImplementedError(f"layer kind {spec.kind!r} is not ported yet (ROADMAP A12)")
        if spec.moe:
            raise NotImplementedError("MoE FFNs are not ported yet (ROADMAP A12)")
        if cfg.norm != "rmsnorm":
            raise NotImplementedError(f"norm {cfg.norm!r} is not ported yet (ROADMAP A12)")
        self.norm1 = RMSNorm(cfg.d_model, dtype, device)
        self.mix = Attention(cfg, spec, dtype, device)
        if _has_ffn(cfg, spec):
            self.norm2 = RMSNorm(cfg.d_model, dtype, device)
            self.ffn = MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.act, dtype, device)
        else:
            self.norm2 = self.ffn = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.reset_parameters()
        self.mix.reset_parameters(gen)
        if self.ffn is not None:
            self.norm2.reset_parameters()
            self.ffn.reset_parameters(gen)

    def forward(self, x, cfg, positions, cache=None, cache_index=None):
        x = x + self.mix(self.norm1(x), cfg, positions, cache, cache_index)
        if self.ffn is not None:
            x = x + self.ffn(self.norm2(x))
        return x


class Stack(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(Layer(cfg, spec, dtype, device) for spec in cfg.all_layers())

    def reset_parameters(self, gen: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(gen)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                cache: Optional[List[Cache]] = None, cache_index: Optional[Index] = None,
                link_fn=None) -> torch.Tensor:
        """Run every layer, applying ``link_fn`` at the split point."""
        split = min(max(cfg.link.split_after_units, 0), cfg.resolved_num_units) if link_fn else 0
        at = len(cfg.prologue) + split * len(cfg.unit_pattern)
        for i, layer in enumerate(self.layers):
            if link_fn is not None and i == at:
                x = link_fn(x)
            x = layer(x, cfg, positions, cache[i] if cache is not None else None, cache_index)
        if link_fn is not None and at == len(self.layers):
            x = link_fn(x)
        return x
