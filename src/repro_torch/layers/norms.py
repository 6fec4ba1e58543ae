"""RMSNorm / LayerNorm, computed in float32."""

from __future__ import annotations

import torch

from repro_torch.layers.initializers import WSpec


def norm_specs(d: int, kind: str = "rmsnorm"):
    specs = {"scale": WSpec((d,), ("norm",), init="ones")}
    if kind == "layernorm":
        specs["bias"] = WSpec((d,), ("norm",), init="zeros")
    return specs


def apply_norm(params, x, kind: str = "rmsnorm", eps: float = 1e-5):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
        y = y * params["scale"].float()
    else:
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * params["scale"].float() + params["bias"].float()
    return y.to(x.dtype)
