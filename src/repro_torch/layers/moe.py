"""Mixture-of-Experts.

Two execution paths sharing one weight layout, as in the JAX package
(and a third of the port's own for a rank's held experts, below):

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

The router is the reference's by default (``cfg.moe_router ==
"softmax"``): softmax over the experts, top-k, gates renormalised to sum
to 1.  With ``"noaux_tc"`` it is DeepSeek-V3's published one, which the
reference does not compute: sigmoid scores ``s`` in float32, a selection
score ``s + e_score_correction_bias``; each of ``n_group`` groups scored
by the sum of its two best selection scores and the ``topk_group`` best
groups kept; the top-k experts by selection score inside them (the
others at -inf); the gates ``s`` at those experts normalised to sum to 1,
times ``routed_scaling_factor``.  No auxiliary loss (0).

Held experts (``cfg.experts_held`` > 0): the layer is one rank's share
of an expert-parallel deployment.  The router keeps all ``n_experts``
columns; the weights hold experts [experts_offset, experts_offset +
experts_held) only, and the layer returns what they give for the pairs
routed to them, no token dropped, plus the shared expert whole.  The
absent ranks' part is left out (one chip of the deployment; no
exchange).  ``moe_apply_dense`` runs every held expert over every token
and masks by the gates (static shapes: a CUDA graph holds it, as the
decode tick does); ``moe_apply_routed`` (the prefill's path) computes
only the routed pairs, one segment an expert, in the order the
expert-parallel path sorts them (``_sort_pairs``), after one read of the
segments' lengths.

``counting_pairs()`` collects, for the layers run inside it without a
mesh, each layer's count of the (token, expert) pairs routed to the
experts the weights hold, over the tokens ``valid`` marks: a 0-d int64
tensor on the device a layer, read by the caller with what it reads
anyway (the serving decode's tick, its prefill).  Beside them it sums
the (token, expert) rows the held experts computed, a host integer:
every token times every held expert in the dense form, the routed pairs
alone in the routed one.

Expert counts that do not divide an expert-parallel axis are padded
(granite: 40 -> 48); the router has ``n_experts`` columns only, so a
padded expert is never chosen.
"""

from __future__ import annotations

import contextlib
import math
import threading

import torch
import torch.nn.functional as F

from repro_torch.common import sharding
from repro_torch.common.pytree import tree_leaves, tree_unflatten
from repro_torch.layers.initializers import WSpec
from repro_torch.layers.mlp import activation, mlp_apply, mlp_specs


def padded_experts(cfg) -> int:
    """The expert weights' leading size: the held experts, or every
    expert padded to ``expert_pad_to``."""
    return (cfg.experts_held or cfg.expert_pad_to
            or cfg.n_experts)


def _first_held(cfg) -> int:
    """The global id of the weights' first expert."""
    return (cfg.experts_offset if cfg.experts_held else 0)


def _noaux_tc(cfg) -> bool:
    return cfg.moe_router == "noaux_tc"


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
    if _noaux_tc(cfg):
        specs["e_score_correction_bias"] = WSpec((cfg.n_experts,), (None,),
                                                 init="zeros")
    return specs


_PAIRS = threading.local()


class PairCount:
    """What ``counting_pairs`` collects: ``pairs``, each layer's routed
    pairs (0-d tensors on the device), and ``rows``, the rows the held
    experts computed over those layers."""

    def __init__(self):
        self.pairs: list = []
        self.rows = 0


@contextlib.contextmanager
def counting_pairs():
    """Collect the routed pairs and computed rows of each MoE layer run
    in this thread inside (see the module docstring); yields a
    ``PairCount``."""
    outer = getattr(_PAIRS, "counts", None)
    counts = _PAIRS.counts = PairCount()
    try:
        yield counts
    finally:
        _PAIRS.counts = outer


def _note_pairs(idx, cfg, valid, rows: int) -> None:
    """Count the pairs of ``idx`` (T, k) routed to the held experts,
    over the tokens ``valid`` (T,) marks (all without it), and the
    ``rows`` the held experts computed."""
    counts = getattr(_PAIRS, "counts", None)
    if counts is None:
        return
    e0 = _first_held(cfg)
    hit = (idx >= e0) & (idx < e0 + padded_experts(cfg))
    if valid is not None:
        hit = hit & valid.reshape(-1, 1)
    counts.pairs.append(hit.sum())
    counts.rows += rows


def _route_noaux_tc(tokens, params, cfg):
    """DeepSeek-V3's router (see the module docstring): (gates (T,k),
    idx (T,k), aux 0)."""
    s = torch.sigmoid(tokens.float() @ params["router"].float())  # (T, E)
    sel = s + params["e_score_correction_bias"].float()
    T, E = s.shape
    g = cfg.n_group
    grp = sel.view(T, g, E // g).topk(2, dim=-1).values.sum(-1)   # (T, g)
    keep = torch.zeros_like(grp, dtype=torch.bool).scatter_(
        1, grp.topk(cfg.topk_group, dim=-1).indices, True)
    sel = sel.masked_fill(~keep.repeat_interleave(E // g, dim=1),
                          float("-inf"))
    idx = sel.topk(cfg.experts_top_k, dim=-1).indices
    gates = s.gather(1, idx)
    gates = gates / gates.sum(-1, keepdim=True) * cfg.routed_scaling_factor
    return gates, idx, torch.zeros((), dtype=torch.float32,
                                   device=tokens.device)


def _route(tokens, router, cfg, params=None):
    """tokens: (T, D) -> (gates (T,k), idx (T,k), aux_loss scalar).
    Softmax over the real experts in float32, top-k, gates renormalised
    to sum to 1; the Switch-style load-balancing loss.  With
    ``cfg.moe_router == "noaux_tc"`` DeepSeek-V3's router instead, which
    reads ``params``' correction bias."""
    if _noaux_tc(cfg):
        return _route_noaux_tc(tokens, params, cfg)
    logits = tokens.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, cfg.experts_top_k, dim=-1)
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)
    frac = F.one_hot(idx, cfg.n_experts).float().mean(dim=(0, 1))
    imp = probs.mean(dim=0)
    aux = cfg.n_experts * (frac * imp).sum()
    return gates, idx, aux


def _held_comb(idx, gates, cfg):
    """(T, E) float32 combine weights over the weights' experts: each
    pair's gate at its expert's local index, pairs to experts the
    weights do not hold left out."""
    E = padded_experts(cfg)
    e0 = _first_held(cfg)
    local = idx - e0
    hit = (local >= 0) & (local < E)
    return (F.one_hot(local.clamp(0, E - 1), E).float()
            * (gates * hit)[..., None]).sum(dim=1)


def moe_apply_dense(params, x, cfg, mesh=None, valid=None):
    """Run all (padded, or held) experts on every token, combine with the
    top-k gate weights.  x: (B, S, D) -> (y (B, S, D), aux).  Under a mesh
    every rank computes it whole (tokens and weights gathered), the
    function GSPMD computes for the reference: aux over all the tokens.
    ``valid`` (B, S) marks the tokens whose pairs ``counting_pairs``
    counts."""
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
    tokens = x.reshape(-1, D)
    gates, idx, aux = _route(tokens, params["router"], cfg, params)
    _note_pairs(idx, cfg, valid, tokens.shape[0] * padded_experts(cfg))
    comb = _held_comb(idx, gates, cfg)                            # (T, E)
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


def _sort_pairs(idx, gates):
    """The (token, expert) pairs of ``idx`` (T, k) sorted by expert,
    stably (``jnp.argsort``'s order): (experts, tokens, gates), each
    (T*k,)."""
    k = idx.shape[1]
    order = torch.argsort(idx.reshape(-1), stable=True)
    return idx.reshape(-1)[order], order // k, gates.reshape(-1)[order]


def moe_apply_routed(params, x, cfg, valid=None):
    """The held experts over the pairs routed to them alone (see the
    module docstring): x (B, S, D) -> (y, aux).  One read of the held
    experts' pair counts sizes the segments."""
    B, S, D = x.shape
    E = padded_experts(cfg)
    e0 = _first_held(cfg)
    tokens = x.reshape(-1, D)
    gates, idx, aux = _route(tokens, params["router"], cfg, params)
    se, tok_ids, sg = _sort_pairs(idx, gates)
    bounds = torch.searchsorted(
        se, torch.arange(e0, e0 + E + 1, device=se.device, dtype=se.dtype))
    act = activation(cfg.act_fn)
    y = torch.zeros((tokens.shape[0], D), dtype=torch.float32,
                    device=x.device)
    edges = bounds.tolist()
    _note_pairs(idx, cfg, valid, edges[E] - edges[0])
    for e in range(E):
        a, b = edges[e], edges[e + 1]
        if a == b:
            continue
        ids = tok_ids[a:b]
        xe = tokens[ids]
        h = act(xe @ params["wi_gate"][e].to(x.dtype)) * (
            xe @ params["wi_up"][e].to(x.dtype))
        ye = h @ params["wo"][e].to(x.dtype)
        y.index_add_(0, ids, ye.float() * sg[a:b, None])
    y = y.to(x.dtype).reshape(B, S, D)
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
    if _noaux_tc(cfg) or cfg.experts_held:
        raise NotImplementedError(
            "moe_apply_ep: the expert-parallel path takes the softmax "
            "router over every expert")
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

        se, tok_ids, sg = _sort_pairs(idx, gates)
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
              capacity_factor: float = 1.25, valid=None):
    """The dense form, or with ``impl="ep"`` and a mesh the
    expert-parallel one at ``capacity_factor`` (the reference's
    default), or with ``impl="pairs"`` and no mesh the routed pairs
    alone (``moe_apply_routed``).  ``valid`` (B, S) marks the tokens
    ``counting_pairs`` counts."""
    if impl not in ("dense", "ep", "pairs"):
        raise ValueError(f"moe_apply: unknown impl {impl!r}")
    if impl == "ep" and mesh is not None:
        return moe_apply_ep(params, x, cfg, mesh,
                            capacity_factor=capacity_factor)
    if impl == "pairs" and mesh is None:
        return moe_apply_routed(params, x, cfg, valid=valid)
    return moe_apply_dense(params, x, cfg, mesh=mesh, valid=valid)
