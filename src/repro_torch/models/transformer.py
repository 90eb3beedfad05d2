"""The decoder stack (twin of ``repro/models/transformer.py``): each layer
mixes by its kind (attention, Mamba, mLSTM or sLSTM) behind RMSNorm or
LayerNorm, then runs a dense or MoE FFN where the config has one.

The reference scans ``U`` units of ``unit_pattern`` with stacked params;
the port unrolls them into one ``nn.ModuleList`` — layer
``len(prologue) + u * len(pattern) + j`` — and applies the COMtune link
after ``split = min(max(split_after_units, 0), U)`` units, as the
reference's two scan segments do.  The layers' MoE auxiliary losses are
summed in stack order from an f32 zero, as ``run_stack`` carries them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn as nn

from repro_torch.configs.base import LayerSpec, ModelConfig
from repro_torch.models.attention import Attention, Cache, Index
from repro_torch.models.common import make_norm
from repro_torch.models.mamba import Mamba
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.xlstm import MLSTM, SLSTM

RECURRENT = {"mamba": Mamba, "mlstm": MLSTM, "slstm": SLSTM}


def _has_ffn(cfg: ModelConfig, spec: LayerSpec) -> bool:
    return spec.moe or cfg.d_ff > 0


class Layer(nn.Module):
    """Pre-norm residual layer: the mixer of ``spec.kind``, then the dense
    or MoE FFN.  A recurrent mixer reads and writes its cache's state and
    ignores the positions and ``cache_index``."""

    def __init__(self, cfg: ModelConfig, spec: LayerSpec, dtype, device):
        super().__init__()
        self.kind = spec.kind
        self.norm1 = make_norm(cfg.norm, cfg.d_model, dtype, device)
        if spec.kind == "attn":
            self.mix = Attention(cfg, spec, dtype, device)
        elif spec.kind in RECURRENT:
            self.mix = RECURRENT[spec.kind](cfg, dtype, device)
        else:
            raise ValueError(spec.kind)
        if _has_ffn(cfg, spec):
            self.norm2 = make_norm(cfg.norm, cfg.d_model, dtype, device)
            self.ffn = (MoE(cfg, dtype, device) if spec.moe
                        else MLP(cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.act, dtype, device))
        else:
            self.norm2 = self.ffn = None

    def reset_parameters(self, gen: torch.Generator) -> None:
        self.norm1.reset_parameters()
        self.mix.reset_parameters(gen)
        if self.ffn is not None:
            self.norm2.reset_parameters()
            self.ffn.reset_parameters(gen)

    def forward(self, x, cfg, positions, cache=None, cache_index=None, route_rows=False):
        """Returns (x, aux): aux the MoE FFN's load-balance term, else None.
        ``route_rows`` routes each batch row as its own MoE group."""
        if self.kind == "attn":
            x = x + self.mix(self.norm1(x), cfg, positions, cache, cache_index)
        else:
            x = x + self.mix(self.norm1(x), cfg, cache)
        aux = None
        if isinstance(self.ffn, MoE):
            y, aux = self.ffn(self.norm2(x), cfg, per_row=route_rows)
            x = x + y
        elif self.ffn is not None:
            x = x + self.ffn(self.norm2(x))
        return x, aux


class Stack(nn.Module):
    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.layers = nn.ModuleList(Layer(cfg, spec, dtype, device) for spec in cfg.all_layers())

    def reset_parameters(self, gen: torch.Generator) -> None:
        for layer in self.layers:
            layer.reset_parameters(gen)

    def forward(self, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
                cache: Optional[List[Cache]] = None, cache_index: Optional[Index] = None,
                link_fn=None, route_rows: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
        """Run every layer, applying ``link_fn`` at the split point; returns
        (x, aux) with aux the f32 sum of the MoE layers' terms."""
        split = min(max(cfg.link.split_after_units, 0), cfg.resolved_num_units) if link_fn else 0
        at = len(cfg.prologue) + split * len(cfg.unit_pattern)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            if link_fn is not None and i == at:
                x = link_fn(x)
            x, a = layer(x, cfg, positions, cache[i] if cache is not None else None, cache_index, route_rows)
            if a is not None:
                aux = aux + a
        if link_fn is not None and at == len(self.layers):
            x = link_fn(x)
        return x, aux
