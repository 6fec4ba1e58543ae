"""Rotary position embeddings (half-rotation layout, LLaMA-style);
angles in float32."""

from __future__ import annotations

import torch


def rope_freqs(dim: int, theta: float, device=None):
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device) / dim
    return 1.0 / (theta ** exponent)  # (dim/2,)


def apply_rope(x, positions, theta: float = 10000.0):
    """x: (..., seq, heads, head_dim) or (..., seq, head_dim);
    positions: (..., seq)."""
    dim = x.shape[-1]
    inv = rope_freqs(dim, theta, x.device)                 # (dim/2,)
    ang = positions[..., None].float() * inv               # (..., seq, dim/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if x.ndim == positions.ndim + 2:                       # heads axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
