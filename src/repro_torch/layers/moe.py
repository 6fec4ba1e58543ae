"""Mixture-of-Experts, the dense form.

The JAX package has two execution paths over one weight layout: ``dense``
(every expert runs on every token, combined with the top-k gates; the
oracle of its tests) and ``ep`` (expert-parallel ``shard_map``).  The
port serves on one card and computes the dense form, the same function
as the reference's oracle (held to it at float32 2e-4).  ``impl="ep"``
waits for the distributed slice.

No Pallas kernel stands behind either path in the reference; the
experts are plain batched matrix products here too.  At granite-moe-3b-
a800m's width the dense form reads all 48 experts' weights for every
token (14.5 GB a decode step in float32); at deepseek-v3-671b's, 256
experts of (7168, 2048) are 15.03 GB a leaf, read in place.

The router is the reference's: softmax over the experts, top-k, gates
renormalised to sum to 1.  DeepSeek-V3's own router (sigmoid scores
with a selection bias) is not what the reference computes, so the port
does not compute it either.

Expert counts that do not divide an expert-parallel axis are padded
(granite: 40 -> 48); the router has ``n_experts`` columns only, so a
padded expert is never chosen.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.layers.initializers import WSpec
from repro_torch.layers.mlp import activation, mlp_apply, mlp_specs


def padded_experts(cfg) -> int:
    return cfg.expert_pad_to or cfg.n_experts


def moe_specs(cfg):
    E = padded_experts(cfg)
    f = cfg.moe_d_ff or cfg.d_ff
    specs = {
        "router": WSpec((cfg.d_model, cfg.n_experts), (None, None), init="small"),
        "wi_gate": WSpec((E, cfg.d_model, f), ("experts", "embed", "expert_mlp")),
        "wi_up": WSpec((E, cfg.d_model, f), ("experts", "embed", "expert_mlp")),
        "wo": WSpec((E, f, cfg.d_model), ("experts", "expert_mlp", "embed")),
    }
    if cfg.n_shared_experts:
        specs["shared"] = mlp_specs(cfg.d_model, f * cfg.n_shared_experts)
    return specs


def _route(tokens, router, cfg):
    """tokens: (T, D) -> (gates (T,k), idx (T,k), aux_loss scalar).
    Softmax over the real experts in float32, top-k, gates renormalised
    to sum to 1; the Switch-style load-balancing loss."""
    logits = tokens.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    frac = F.one_hot(idx, cfg.n_experts).float().mean(dim=(0, 1))
    imp = probs.mean(dim=0)
    aux = cfg.n_experts * (frac * imp).sum()
    return gates, idx, aux


def moe_apply_dense(params, x, cfg):
    """Run all (padded) experts on every token, combine with the top-k
    gate weights.  x: (B, S, D) -> (y (B, S, D), aux)."""
    B, S, D = x.shape
    E = padded_experts(cfg)
    tokens = x.reshape(-1, D)
    gates, idx, aux = _route(tokens, params["router"], cfg)
    comb = (F.one_hot(idx, E).float() * gates[..., None]).sum(dim=1)  # (T, E)
    act = activation(cfg.act_fn)
    # (T, D) @ (E, D, f) broadcasts to one batched product over the
    # experts that reads each weight in place (an einsum here copied
    # every expert's weights into another layout on each call)
    h_g = torch.matmul(tokens, params["wi_gate"].to(x.dtype))     # (E, T, f)
    h_u = torch.matmul(tokens, params["wi_up"].to(x.dtype))
    y_e = torch.bmm(act(h_g) * h_u, params["wo"].to(x.dtype))     # (E, T, D)
    y = torch.einsum("etd,te->td", y_e.float(), comb).to(x.dtype)
    y = y.reshape(B, S, D)
    if cfg.n_shared_experts:
        y = y + mlp_apply(params["shared"], x, cfg.act_fn)
    return y, aux


def moe_apply(params, x, cfg, impl: str = "dense"):
    if impl == "ep":
        raise NotImplementedError(
            "moe_apply(impl='ep'): the expert-parallel path needs the "
            "distributed slice of the port (torch.distributed)")
    if impl != "dense":
        raise ValueError(f"moe_apply: unknown impl {impl!r}")
    return moe_apply_dense(params, x, cfg)
