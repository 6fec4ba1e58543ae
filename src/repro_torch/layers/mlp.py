"""Gated MLP (SwiGLU / GeGLU)."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.layers.initializers import WSpec


def mlp_specs(d_model: int, d_ff: int):
    return {
        "wi_gate": WSpec((d_model, d_ff), ("embed", "mlp")),
        "wi_up": WSpec((d_model, d_ff), ("embed", "mlp")),
        "wo": WSpec((d_ff, d_model), ("mlp", "embed")),
    }


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation, so "gelu" is the
    # tanh form here too
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
        "relu": F.relu,
    }[name]


def mlp_apply(params, x, act_fn: str = "silu"):
    act = activation(act_fn)
    g = x @ params["wi_gate"].to(x.dtype)
    u = x @ params["wi_up"].to(x.dtype)
    return (act(g) * u) @ params["wo"].to(x.dtype)
