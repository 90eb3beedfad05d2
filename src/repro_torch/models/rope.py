"""Rotary position embeddings: standard RoPE and Qwen2-VL's M-RoPE (twin of
``repro/models/rope.py``).

M-RoPE (arXiv:2409.12191): the head_dim/2 frequency channels are cut into
``sections`` (temporal, height, width), and each section rotates by its own
position stream.  Positions are (B, S) for RoPE and (B, 3, S) for M-RoPE;
for text all three streams carry the same value, and M-RoPE is then RoPE
exactly.
"""

from __future__ import annotations

import torch

from repro_torch.models.common import acc_dtype


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies, in f32."""
    half = head_dim // 2
    exponents = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / torch.pow(torch.tensor(theta, dtype=torch.float32, device=device), exponents)


def _angles(positions: torch.Tensor, head_dim: int, theta: float, sections) -> torch.Tensor:
    """(B, S, head_dim/2) f32 angles: RoPE from (B, S) positions, or M-RoPE
    from (B, 3, S), each frequency channel reading its section's stream."""
    inv = rope_frequencies(head_dim, theta, positions.device)
    if not sections:
        return positions.float()[..., None] * inv[None, None, :]
    assert sum(sections) == head_dim // 2, (sections, head_dim)
    sec_ids = torch.cat([torch.full((s,), i, dtype=torch.int64, device=positions.device)
                         for i, s in enumerate(sections)])
    per_channel = positions.float()[:, sec_ids, :].transpose(1, 2)          # (B, S, half)
    return per_channel * inv[None, None, :]


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections=()) -> torch.Tensor:
    """Rotate x (B, S, N, head_dim) by positions ((B, S), or (B, 3, S) with
    ``sections``); math in f32 (the rotation of an f64 tensor in f64, by
    the same f32 angles)."""
    ang = _angles(positions, x.shape[-1], theta, sections)
    sin = torch.sin(ang)[:, :, None, :]
    cos = torch.cos(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.to(acc_dtype(x)), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def default_positions(batch: int, seq: int, offset: int = 0, mrope: bool = False, *, device) -> torch.Tensor:
    """Sequential text positions starting at ``offset``: (B, S) int32, or
    (B, 3, S) with the three M-RoPE streams equal."""
    pos = torch.arange(seq, dtype=torch.int32, device=device)[None, :] + offset
    pos = pos.expand(batch, seq)
    return pos[:, None, :].expand(batch, 3, seq) if mrope else pos


def row_positions(lengths: torch.Tensor, mrope: bool = False) -> torch.Tensor:
    """A decode step's positions from per-row cache lengths (B,): (B, 1), or
    (B, 3, 1) for M-RoPE (the reference's broadcast in its paged step)."""
    pos = lengths[:, None]
    return pos[:, None, :].expand(lengths.shape[0], 3, 1) if mrope else pos
