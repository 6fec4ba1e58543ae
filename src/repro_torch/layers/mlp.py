"""Gated MLP (SwiGLU / GeGLU)."""

from __future__ import annotations

import torch.nn.functional as F

from repro_torch.common import sharding
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
    if sharding.is_dtensor(params["wo"]):
        return _mlp_sharded(params, x, act_fn)
    act = activation(act_fn)
    g = x @ params["wi_gate"].to(x.dtype)
    u = x @ params["wi_up"].to(x.dtype)
    return (act(g) * u) @ params["wo"].to(x.dtype)


def _mlp_sharded(params, x, act_fn):
    """The MLP on each rank's local tensors, as GSPMD lays it out for
    these rules: x keeps its batch and sequence sharding with d whole,
    the weights are gathered over their d (FSDP) axes and keep their
    hidden ("mlp") sharding, and an all_reduce over the hidden axes sums
    the down projection's partial products (tensor parallelism).
    DTensor's own products may gather the hidden dim whole on every rank
    of the model axis instead (16 times the work on 16 x 16)."""
    mesh = params["wo"].device_mesh
    x, lead = sharding.lead_spec(x)
    hidden = sharding.unless_used(sharding.spec_of(params["wo"])[0], lead)
    act = activation(act_fn)

    def f(xl, wg, wu, wo):
        h = act(xl @ wg.to(xl.dtype)) * (xl @ wu.to(xl.dtype))
        return sharding.all_reduce(h @ wo.to(xl.dtype), mesh, hidden)

    w_in = (None, hidden)
    return sharding.shard_map(f, mesh, ((*lead, None), w_in, w_in,
                                        (hidden, None)), (*lead, None))(
        x, params["wi_gate"], params["wi_up"], params["wo"])
