"""RMSNorm / LayerNorm, computed in float32."""

from __future__ import annotations

import torch

from repro_torch.layers.initializers import WSpec


def norm_specs(d: int, kind: str = "rmsnorm"):
    specs = {"scale": WSpec((d,), ("norm",), init="ones")}
    if kind == "layernorm":
        specs["bias"] = WSpec((d,), ("norm",), init="zeros")
    return specs


def apply_norm(params, x, kind: str = "rmsnorm", eps: float = 1e-5, *,
               split=None):
    """Normalise over the last dim.  With ``split`` (a
    ``common.sharding.Split``, inside ``shard_map``) ``x`` and the norm's
    weights hold this rank's columns of a vector split over the split's
    axes, and the statistics are the whole vector's: the sums are
    all-reduced over them."""
    xf = x.float()
    if split:
        n = x.shape[-1] * split.size

        def mean(t):
            return split.sum(t.sum(-1, keepdim=True)) / n

        if kind == "rmsnorm":
            y = xf * torch.rsqrt(mean(xf * xf) + eps)
        else:
            mu = mean(xf)
            y = (xf - mu) * torch.rsqrt(mean((xf - mu) * (xf - mu)) + eps)
    elif kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * params["scale"].float()
    if kind != "rmsnorm":
        y = y + params["bias"].float()
    return y.to(x.dtype)
