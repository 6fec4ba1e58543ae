"""Mixture-of-Experts.

Two execution paths sharing one weight layout, as in the JAX package:

* ``dense`` — every expert runs on every token, masked by top-k gates:
  the reference's oracle.  Plain batched matrix products; at
  granite-moe-3b-a800m's width it reads all 48 experts' weights for
  every token (14.5 GB a decode step in float32), at deepseek-v3-671b's
  256 experts of (7168, 2048) are 15.03 GB a leaf, read in place.
* ``ep`` — the expert-parallel path (``moe_apply_ep``).  Tokens stay
  batch-sharded and replicated over the ``model`` axis; each model rank
  scatters its local experts' tokens into a capacity-bounded buffer
  (sort-based dispatch), runs the expert FFNs, scatters the results
  back, and an all_reduce over ``model`` combines them.  Expert weights
  are EP-sharded over ``model`` and FSDP-sharded over (pod, data), the
  dp shards all-gathered inside (ZeRO-3 style).  It runs on each rank's
  local tensors (``common.sharding.shard_map``) with autograd-aware
  collectives, so gradients flow through it.

No Pallas kernel stands behind either path in the reference; the
experts are plain batched matrix products here too.

The router is the reference's: softmax over the experts, top-k, gates
renormalised to sum to 1.  DeepSeek-V3's own router (sigmoid scores
with a selection bias) is not what the reference computes, so the port
does not compute it either.

Expert counts that do not divide an expert-parallel axis are padded
(granite: 40 -> 48); the router has ``n_experts`` columns only, so a
padded expert is never chosen.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import sharding
from repro_torch.common.pytree import tree_leaves, tree_unflatten
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


def moe_apply_dense(params, x, cfg, mesh=None):
    """Run all (padded) experts on every token, combine with the top-k
    gate weights.  x: (B, S, D) -> (y (B, S, D), aux).  Under a mesh
    every rank computes it whole (tokens and weights gathered), the
    function GSPMD computes for the reference: aux over all the tokens."""
    if mesh is not None:
        leaves = tree_leaves(params)

        def f(x_all, *leaves_all):
            return moe_apply_dense(tree_unflatten(params, list(leaves_all)),
                                   x_all, cfg)

        def whole(t):
            return (None,) * t.ndim

        return sharding.shard_map(f, mesh, (whole(x), *map(whole, leaves)),
                                  [whole(x), ()])(x, *leaves)
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


def _dp_axes(mesh, batch: int) -> tuple[str, ...]:
    """Data axes usable for the token shard (must divide batch)."""
    sizes = sharding.mesh_shape(mesh)
    axes = []
    prod = 1
    for a in ("pod", "data"):
        if a in sizes and batch % (prod * sizes[a]) == 0:
            axes.append(a)
            prod *= sizes[a]
    return tuple(axes)


def moe_apply_ep(params, x, cfg, mesh, *, capacity_factor: float = 1.25,
                 ep_axis: str = "model"):
    """Expert-parallel path (see the module docstring).  Falls back to
    the dense form where the reference does: no ``ep_axis`` in the mesh,
    or a padded expert count it does not divide.  Each data shard routes
    its own tokens with its own capacity ``C = max(1, ceil(T_loc * k *
    capacity_factor / n_experts))``; a token past its expert's capacity is
    dropped from that expert (earliest tokens first), and ``aux`` is the
    mean over the data shards of each shard's own loss.  Returns (y
    placed as x's batch shard, aux replicated)."""
    B, S, D = x.shape
    E = padded_experts(cfg)
    k = cfg.experts_top_k
    sizes = sharding.mesh_shape(mesh)
    if ep_axis not in sizes or E % sizes[ep_axis] != 0:
        return moe_apply_dense(params, x, cfg, mesh=mesh)
    E_loc = E // sizes[ep_axis]
    dp = _dp_axes(mesh, B)
    dp_size = math.prod(sizes[a] for a in dp)
    T_loc = (B // dp_size) * S
    C = max(1, int(math.ceil(T_loc * k * capacity_factor / cfg.n_experts)))

    dp_spec = dp if len(dp) > 1 else (dp[0] if dp else None)
    x_spec = (dp_spec, None, None)
    # expert weights: EP over model, FSDP over dp when divisible
    fsdp = dp_spec if (dp and D % dp_size == 0) else None
    w_spec = (ep_axis, fsdp, None)
    wo_spec = (ep_axis, None, fsdp)
    act = activation(cfg.act_fn)

    def f(x_loc, router, wig, wiu, wo):
        if fsdp is not None:
            wig = sharding.all_gather(wig, mesh, fsdp, dim=1)
            wiu = sharding.all_gather(wiu, mesh, fsdp, dim=1)
            wo = sharding.all_gather(wo, mesh, fsdp, dim=2)
        tokens = x_loc.reshape(-1, D)
        T = tokens.shape[0]
        gates, idx, aux = _route(tokens, router, cfg)

        flat_e = idx.reshape(-1)                       # (T*k,)
        flat_g = gates.reshape(-1)
        order = torch.argsort(flat_e, stable=True)     # jnp.argsort's order
        se = flat_e[order]
        tok_ids = order // k
        sg = flat_g[order]
        starts = torch.searchsorted(
            se, torch.arange(E, device=se.device, dtype=se.dtype),
            side="left")
        pos = torch.arange(T * k, device=se.device) - starts[se]
        e0 = sharding.axis_index(mesh, ep_axis) * E_loc
        local = (se >= e0) & (se < e0 + E_loc) & (pos < C)
        slot = torch.where(local, (se - e0) * C + pos,
                           torch.full_like(se, E_loc * C))

        gathered = tokens[tok_ids] * local[:, None].to(tokens.dtype)
        buf = torch.zeros((E_loc * C + 1, D), dtype=x_loc.dtype,
                          device=x_loc.device).index_put((slot,), gathered)
        bufe = buf[:-1].reshape(E_loc, C, D)

        h = act(torch.bmm(bufe, wig.to(x_loc.dtype)))
        h = h * torch.bmm(bufe, wiu.to(x_loc.dtype))
        out_flat = torch.bmm(h, wo.to(x_loc.dtype)).reshape(E_loc * C, D)

        contrib = out_flat[torch.where(local, slot, torch.zeros_like(slot))]
        contrib = contrib * (sg * local).to(contrib.dtype)[:, None]
        y = torch.zeros((T, D), dtype=x_loc.dtype,
                        device=x_loc.device).index_add(0, tok_ids, contrib)
        y = sharding.all_reduce(y, mesh, ep_axis)
        # aux identical on every ep rank (same tokens): mean over dp shards
        if dp:
            aux = sharding.all_reduce(aux, mesh, dp, "mean")
        return y.reshape(x_loc.shape), aux

    # x as a DTensor from here on: the shared branch's backward meets it
    x = sharding.to_placements(x, mesh, sharding.placements_for(x_spec, mesh))
    y, aux = sharding.shard_map(
        f, mesh, (x_spec, (None, None), w_spec, w_spec, wo_spec),
        [x_spec, ()])(x, params["router"], params["wi_gate"],
                      params["wi_up"], params["wo"])
    if cfg.n_shared_experts:
        with sharding.mesh_scope(mesh):
            y = y + mlp_apply(params["shared"], x, cfg.act_fn)
    return y, aux


def moe_apply(params, x, cfg, mesh=None, impl: str = "dense", *,
              capacity_factor: float = 1.25):
    """The dense form, or with ``impl="ep"`` and a mesh the
    expert-parallel one at ``capacity_factor`` (the reference's
    default)."""
    if impl not in ("dense", "ep"):
        raise ValueError(f"moe_apply: unknown impl {impl!r}")
    if impl == "ep" and mesh is not None:
        return moe_apply_ep(params, x, cfg, mesh,
                            capacity_factor=capacity_factor)
    return moe_apply_dense(params, x, cfg, mesh=mesh)
