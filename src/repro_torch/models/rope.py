"""Rotary position embeddings (twin of ``repro/models/rope.py``, standard
RoPE; Qwen2-VL's M-RoPE waits for that architecture's port)."""

from __future__ import annotations

import torch

from repro_torch.models.common import acc_dtype


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, in f32."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponents)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections=()) -> torch.Tensor:
    """Rotate x (B, S, N, head_dim) by positions (B, S); math in f32 (the
    rotation of an f64 tensor in f64, by the same f32 angles)."""
    if sections:
        raise NotImplementedError("M-RoPE is not ported yet (ROADMAP A12)")
    head_dim = x.shape[-1]
    ang = positions.float()[..., None] * rope_frequencies(head_dim, theta, x.device)[None, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(acc_dtype(x)), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def default_positions(batch: int, seq: int, offset: int = 0, *, device) -> torch.Tensor:
    """Sequential text positions (B, S) int32 starting at ``offset``."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    return pos.expand(batch, seq)
