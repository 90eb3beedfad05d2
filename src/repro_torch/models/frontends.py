"""Modality frontend stubs (twin of ``repro/models/frontends.py``).

For the VLM (qwen2-vl) and audio (musicgen) architectures the port, as the
reference, runs the decoder only: the vision encoder and the audio codec
are stubs whose precomputed (B, F, d) patch or frame embeddings replace the
first F token embeddings, after a trainable adapter projection ``proj``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from repro_torch.models.common import dense_std, frozen, trunc_normal_


class FrontendAdapter(nn.Module):
    """The adapter ``proj`` (d, d) of the reference's layout."""

    def __init__(self, d_model: int, dtype, device):
        super().__init__()
        self.proj = frozen((d_model, d_model), dtype, device)

    def reset_parameters(self, gen: torch.Generator) -> None:
        trunc_normal_(self.proj, dense_std(self.proj.shape), gen)


def fuse_frontend(adapter: FrontendAdapter, x: torch.Tensor, frontend_embed: Optional[torch.Tensor]) -> torch.Tensor:
    """x (B, S, d) token embeddings with the first F positions replaced by
    ``frontend_embed`` (B, F, d), cast to x's dtype, through ``proj``."""
    if frontend_embed is None:
        return x
    fused = frontend_embed.to(x.dtype) @ adapter.proj
    return torch.cat([fused, x[:, fused.shape[1]:]], dim=1)
