"""Rotary position embeddings (half-rotation layout, LLaMA-style);
angles in float32.

With ``yarn`` (a ``common.config.Yarn``) the frequencies are YaRN's, as
DeepSeek-V3's published modelling code computes them: each frequency
blends its extrapolated value (theta's) with its interpolated one
(divided by ``factor``) along a linear ramp between the correction dims
of ``beta_fast`` and ``beta_slow`` rotations over the original context,
and cos and sin are scaled by ``yarn_mscale(factor, mscale) /
yarn_mscale(factor, mscale_all_dim)``.  The attention's softmax scale
takes ``yarn_mscale(factor, mscale_all_dim)`` squared
(``layers.mla.softmax_scale``).
"""

from __future__ import annotations

import math

import torch


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    """YaRN's attention scale: 0.1 mscale ln(factor) + 1 (1 at factor <=
    1)."""
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_correction_dim(rotations: float, dim: int, theta: float,
                        max_positions: int) -> float:
    """The dim whose frequency turns ``rotations`` times over
    ``max_positions``."""
    return (dim * math.log(max_positions / (rotations * 2 * math.pi))
            / (2 * math.log(theta)))


def yarn_ramp(yarn, dim: int, theta: float, device=None) -> torch.Tensor:
    """(dim/2,) the share of each frequency that is interpolated: 0
    below the ``beta_fast`` correction dim, 1 above the ``beta_slow``
    one, linear between."""
    orig = yarn.original_max_position_embeddings
    low = max(math.floor(yarn_correction_dim(yarn.beta_fast, dim, theta,
                                             orig)), 0)
    high = min(math.ceil(yarn_correction_dim(yarn.beta_slow, dim, theta,
                                             orig)), dim - 1)
    if low == high:
        high += 0.001
    ramp = (torch.arange(dim // 2, dtype=torch.float32, device=device)
            - low) / (high - low)
    return ramp.clamp(0, 1)


def rope_freqs(dim: int, theta: float, device=None, yarn=None):
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device) / dim
    freqs = 1.0 / (theta ** exponent)  # (dim/2,)
    if yarn is None:
        return freqs
    ramp = yarn_ramp(yarn, dim, theta, device)
    return freqs / yarn.factor * ramp + freqs * (1 - ramp)


def apply_rope(x, positions, theta: float = 10000.0, yarn=None):
    """x: (..., seq, heads, head_dim) or (..., seq, head_dim);
    positions: (..., seq)."""
    dim = x.shape[-1]
    inv = rope_freqs(dim, theta, x.device, yarn)           # (dim/2,)
    ang = positions[..., None].float() * inv               # (..., seq, dim/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    if yarn is not None:
        m = (yarn_mscale(yarn.factor, yarn.mscale)
             / yarn_mscale(yarn.factor, yarn.mscale_all_dim))
        if m != 1.0:
            cos, sin = cos * m, sin * m
    if x.ndim == positions.ndim + 2:                       # heads axis present
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
