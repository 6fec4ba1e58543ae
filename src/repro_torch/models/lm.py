"""Decoder-only LM blocks: embedding -> [stage] -> final norm -> head.

A model is a short sequence of stages, each a stack of homogeneous
blocks whose weights are stacked on a leading axis, as in the JAX
package.  The port covers:

* dense/vlm ``"blocks"``: attention + gated-MLP blocks;
* dense ``"pairs"`` (gemma2): one stacked entry per ``attn_pattern``
  pair, ``sub0``/``sub1`` each an attention + MLP block; a ``"local"``
  sub-block attends within ``sliding_window`` keys of its query;
* moe ``"moe"`` (granite, non-MLA): attention + mixture-of-experts
  blocks (``layers.moe``, the dense form);
* moe with MLA (deepseek): a ``"dense"`` stage of ``first_dense_layers``
  MLA + gated-MLP blocks, then a ``"moe"`` stage of MLA + MoE blocks
  (routed experts and the shared one); each layer caches the latent
  ``ckv`` and the rotary key ``kr`` (``layers.mla``), which page as
  (n_pages, page_size, width) pools;
* hybrid (zamba2) ``"super"``: superblocks of ``n_mamba_per_super``
  Mamba2 blocks (weights ``(n_super, k, ...)``) followed by one
  attention + MLP block whose weights exist once, under
  ``params["stages"]["super"]["shared"]``, and a ``"tail"`` of the
  leftover Mamba2 blocks;
* ssm (xLSTM) ``"xgroup"``: groups of ``mlstm_to_slstm`` mLSTM blocks
  (weights ``(n_groups, m, ...)``) and one sLSTM block.

Where the reference scans a stack, the port loops over the block index;
each block's weights and cache are views into the stacked tensors, so
cache writes land in place.  A block returns its residual stream and
its router loss (0 but in a MoE block), which the backbone sums over
layers as the reference's scan carry does.

Modes: "train" (no cache; attention, Mamba2's SSD and sLSTM through
``ctx["attn_impl"]``: "xla" is plain torch that differentiates,
"kernel" the kernels, which have no backward), "prefill" (fills the
caches: attention through the flash kernel, windowed for local layers,
Mamba2 through the SSD kernel, sLSTM through its kernel) and "decode"
(one token per row: attention against a dense cache through the decode
kernel, or a paged pool through the paged kernel, both with the window
of a local layer; MLA attends over a dense latent cache with plain
products, as the reference does, and over its paged latent pools in
the absorbed form through its own kernel; the recurrent blocks step
their state).

Under a mesh (``ctx["mesh"]``, see ``models.api``) every attention and
MLA block constrains its residual stream first, as the reference's do;
caches are DTensors written in each rank's local tile (``cache_update``
picks the decode write: "scatter", "blend" or "shard"); decode attends
through the decode kernel per rank, or with ``decode_attn="shardmap"``
by the partial softmax over the sequence-sharded cache
(``layers.attention.decode_attention_shardmap``); the MoE runs
expert-parallel (``moe_impl="ep"``).  A recurrent block (Mamba2, mLSTM,
sLSTM) runs whole in one ``sharding.shard_map`` on its rank's heads
(``_on_ranks``): the layer module's layout gives each weight's per-rank
spec, the state caches come in at their own placements and are written
in the rank's tile, and the block's collectives are the layer's own
(``common.sharding.Split``).  Inside a superblock or an xLSTM group the
blocks are rematerialised one by one inside the layer's own
rematerialisation, as the reference scans them (``_inner_stack``).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.common import sharding
from repro_torch.common.pytree import (
    tree_leaves, tree_map, tree_map_with_path, tree_unflatten,
)
from repro_torch.layers import attention as attn
from repro_torch.layers import mamba2 as m2
from repro_torch.layers import mla as mla_lib
from repro_torch.layers import moe as moe_lib
from repro_torch.layers import xlstm as xl
from repro_torch.layers.initializers import WSpec, stack_specs
from repro_torch.layers.mlp import mlp_apply, mlp_specs
from repro_torch.layers.norms import apply_norm, norm_specs
from repro_torch.layers.remat import remat_call


def _attn_block_specs(cfg, use_moe: bool, post_norm: bool):
    d = cfg.d_model
    specs = {
        "ln_attn": norm_specs(d, cfg.norm),
        "attn": attn.attention_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "ln_mlp": norm_specs(d, cfg.norm),
    }
    if use_moe:
        specs["moe"] = moe_lib.moe_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(d, cfg.d_ff)
    if post_norm:
        specs["ln_attn_post"] = norm_specs(d, cfg.norm)
        specs["ln_mlp_post"] = norm_specs(d, cfg.norm)
    return specs


def _mla_block_specs(cfg, use_moe: bool):
    d = cfg.d_model
    specs = {
        "ln_attn": norm_specs(d, cfg.norm),
        "attn": mla_lib.mla_specs(cfg),
        "ln_mlp": norm_specs(d, cfg.norm),
    }
    if use_moe:
        specs["moe"] = moe_lib.moe_specs(cfg)
    else:
        specs["mlp"] = mlp_specs(d, cfg.dense_d_ff or cfg.d_ff)
    return specs


def _constrain(ctx, h):
    """The reference's per-block ``with_sharding_constraint`` of the
    residual stream (identity without a mesh)."""
    return ctx["constrain"](h) if "constrain" in ctx else h


def _constrain_kv_fn(ctx):
    """Sequence parallelism (``attn_sp``): pin k/v replicated over the
    model axis, as the reference constrains them (None otherwise)."""
    if not ctx.get("attn_sp") or ctx.get("mesh") is None:
        return None

    def constrain(kv):
        return sharding.constrain(kv, ("batch", None, None, None),
                                  ctx["rules"], ctx["mesh"])

    return constrain


def _apply_attn_sub(p, h, cache, ctx, cfg, *, local: bool, post_norm: bool):
    """Norm + attention + residual (+post-norm); writes the layer's
    cache in place (train has none).  Returns the new residual stream.
    A local layer attends to the ``cfg.sliding_window`` keys up to its
    query.  Under a mesh the caches are DTensors written in each rank's
    local tile; decode attends through the decode kernel over the
    gathered cache, or with ``decode_attn="shardmap"`` by the per-rank
    partial softmax over the sequence-sharded cache."""
    x = apply_norm(p["ln_attn"], h, cfg.norm, cfg.norm_eps)
    window = cfg.sliding_window if local else 0
    mesh, rules = ctx.get("mesh"), ctx.get("rules")
    if ctx["mode"] == "train":
        y, _ = attn.attention_apply(p["attn"], x, positions=ctx["positions"],
                                    cfg=cfg, local=local,
                                    impl=ctx["attn_impl"], mesh=mesh,
                                    rules=rules,
                                    constrain_kv=_constrain_kv_fn(ctx),
                                    softmax_dtype=ctx["softmax_dtype"])
    elif ctx["mode"] == "prefill":
        y, (k, v) = attn.attention_apply(p["attn"], x,
                                         positions=ctx["positions"], cfg=cfg,
                                         local=local, mesh=mesh, rules=rules,
                                         constrain_kv=_constrain_kv_fn(ctx))
        attn.cache_write_prefix(cache["k"], k)
        attn.cache_write_prefix(cache["v"], v)
    else:  # decode: one token per row at position `lengths`
        lengths = ctx["lengths"]
        q, k_new, v_new = attn.project_qkv(p["attn"], x, ctx["positions"], cfg)
        if ctx.get("decode_attn") == "gatherq" and mesh is not None:
            # release q's head sharding (the reference's constraint)
            q = sharding.constrain(q, ("batch", None, None, None), rules,
                                   mesh)
        if ctx.get("cache_layout") == "paged":
            return _paged_attn_decode(p, h, x, cache, q, k_new, v_new, ctx,
                                      cfg, window=window, post_norm=post_norm)
        mode = ctx.get("cache_update", "scatter")
        attn.cache_insert(cache["k"], k_new, lengths, mode=mode, mesh=mesh,
                          rules=rules)
        attn.cache_insert(cache["v"], v_new, lengths, mode=mode, mesh=mesh,
                          rules=rules)
        if ctx.get("decode_attn") == "shardmap" and mesh is not None:
            out = attn.decode_attention_shardmap(
                q, cache["k"], cache["v"], lengths, mesh=mesh, rules=rules,
                window=window, softcap=cfg.attn_logit_softcap)
        else:
            out = attn.decode_attend(q, cache["k"], cache["v"], lengths + 1,
                                     window=window,
                                     softcap=cfg.attn_logit_softcap,
                                     mesh=mesh, rules=rules)
        y = attn.output_proj(p["attn"], out, x.dtype)
    if post_norm:
        y = apply_norm(p["ln_attn_post"], y, cfg.norm, cfg.norm_eps)
    return h + y


def _paged_attn_decode(p, h, x, cache, q, k_new, v_new, ctx, cfg, *,
                       window: int, post_norm: bool):
    """Decode step against a paged KV cache: the layer's cache leaves
    are global page pools (n_pages, page_size, K, D) and
    ``ctx["block_tables"]`` (B, n_max) names each row's pages.  One
    batched paged decode kernel launch serves every row, a local layer's
    within its ``window`` (the reference gathers the pages and masks
    instead: its kernel has no window).  Under a mesh the pools are
    DTensors laid out as the reference's (pages over "cache_batch", each
    page's slots over "cache_seq"): each rank writes the step's tokens in
    its tile and runs the kernel once over it, and the ranks' partial
    softmaxes are combined (``attn.paged_decode_attention_shardmap``)."""
    lengths = ctx["lengths"]
    tables = ctx["block_tables"]
    mesh = ctx.get("mesh")
    attn.paged_cache_insert(cache["k"], k_new, tables, lengths)
    attn.paged_cache_insert(cache["v"], v_new, tables, lengths)
    if mesh is not None:
        out = attn.paged_decode_attention_shardmap(
            q, cache["k"], cache["v"], tables, lengths + 1, mesh=mesh,
            window=window, softcap=cfg.attn_logit_softcap)
    else:
        out = attn.paged_attend(q, cache["k"], cache["v"], tables,
                                lengths + 1, window=window,
                                softcap=cfg.attn_logit_softcap)
    y = attn.output_proj(p["attn"], out, x.dtype)
    if post_norm:
        y = apply_norm(p["ln_attn_post"], y, cfg.norm, cfg.norm_eps)
    return h + y


def _apply_ffn_sub(p, h, ctx, cfg, *, use_moe: bool, post_norm: bool):
    """Norm + MLP (or MoE) + residual (+post-norm).  Returns (h, the
    MoE's router loss, 0.0 without one); serving drops the loss.  The
    MoE runs ``ctx["moe_impl"]`` ("dense" without a mesh, "ep" by default
    under one, at ``ctx["moe_capacity_factor"]``); a prefill over held
    experts (``cfg.experts_held``) without a mesh runs the routed pairs
    alone.  ``ctx["valid"]`` marks the tokens whose routed pairs
    ``moe.counting_pairs`` counts."""
    x = apply_norm(p["ln_mlp"], h, cfg.norm, cfg.norm_eps)
    aux = 0.0
    if use_moe:
        impl = ctx.get("moe_impl", "dense")
        if cfg.experts_held and ctx["mode"] == "prefill":
            impl = "pairs"
        y, aux = moe_lib.moe_apply(
            p["moe"], x, cfg, mesh=ctx.get("mesh"), impl=impl,
            capacity_factor=ctx.get("moe_capacity_factor", 1.25),
            valid=ctx.get("valid"))
    else:
        y = mlp_apply(p["mlp"], x, cfg.act_fn)
    if post_norm:
        y = apply_norm(p["ln_mlp_post"], y, cfg.norm, cfg.norm_eps)
    return h + y, aux


def _attn_block(p, h, cache, ctx, cfg, *, local: bool, use_moe: bool,
                post_norm: bool):
    h = _constrain(ctx, h)
    h = _apply_attn_sub(p, h, cache, ctx, cfg, local=local,
                        post_norm=post_norm)
    return _apply_ffn_sub(p, h, ctx, cfg, use_moe=use_moe,
                          post_norm=post_norm)


def _mla_block(p, h, cache, ctx, cfg, *, use_moe: bool):
    """Norm + MLA + residual, then norm + MLP (or MoE) + residual.
    Train attends over the segment's own latents; prefill writes the
    latent cache's first S slots; decode inserts one token per row at
    ``lengths`` (``ctx["cache_update"]``'s mode) and attends over the
    slots below ``lengths + 1``: over a dense cache with plain products,
    over the paged latent pools (``ctx["cache_layout"] == "paged"``) in
    the absorbed form through the ``paged_mla_decode`` kernel."""
    h = _constrain(ctx, h)
    x = apply_norm(p["ln_attn"], h, cfg.norm, cfg.norm_eps)
    if ctx["mode"] == "train":
        y, _ = mla_lib.mla_apply(p["attn"], x, positions=ctx["positions"],
                                 cfg=cfg)
    elif ctx["mode"] == "prefill":
        y, (ckv, kr) = mla_lib.mla_apply(p["attn"], x,
                                         positions=ctx["positions"], cfg=cfg)
        attn.cache_write_prefix(cache["ckv"], ckv)
        attn.cache_write_prefix(cache["kr"], kr)
    elif ctx.get("cache_layout") == "paged":
        lengths, tables = ctx["lengths"], ctx["block_tables"]
        ckv_new, kr_new = mla_lib.mla_project_kv(p["attn"], x,
                                                 ctx["positions"], cfg)
        attn.paged_cache_insert(cache["ckv"], ckv_new, tables, lengths)
        attn.paged_cache_insert(cache["kr"], kr_new, tables, lengths)
        y = mla_lib.mla_decode_paged(
            p["attn"], x, positions=ctx["positions"], cfg=cfg,
            ckv_pages=cache["ckv"], kr_pages=cache["kr"],
            block_tables=tables, lengths=lengths + 1)
    else:
        lengths = ctx["lengths"]
        mesh, rules = ctx.get("mesh"), ctx.get("rules")
        mode = ctx.get("cache_update", "scatter")
        ckv_new, kr_new = mla_lib.mla_project_kv(p["attn"], x,
                                                 ctx["positions"], cfg)
        attn.cache_insert(cache["ckv"], ckv_new, lengths, mode=mode,
                          mesh=mesh, rules=rules)
        attn.cache_insert(cache["kr"], kr_new, lengths, mode=mode, mesh=mesh,
                          rules=rules)
        B, T = cache["ckv"].shape[:2]
        kv_pos = torch.arange(T, dtype=torch.int32,
                              device=x.device).expand(B, T)
        y = mla_lib.mla_attend(
            p["attn"], x, positions=ctx["positions"], cfg=cfg,
            ckv_all=cache["ckv"].to(x.dtype), kr_all=cache["kr"].to(x.dtype),
            kv_positions=kv_pos, kv_valid=kv_pos < (lengths + 1)[:, None])
    return _apply_ffn_sub(p, h + y, ctx, cfg, use_moe=use_moe,
                          post_norm=False)


def _pair_block(p, h, cache, ctx, cfg, *, pat):
    """One entry of an ``attn_pattern`` stack (gemma2: local, global):
    sub-block i is an attention + MLP block, windowed where pat[i] is
    "local"; its cache is the i-th of the entry's list."""
    for i, kind in enumerate(pat):
        h, _ = _attn_block(p[f"sub{i}"], h, _field(cache, i), ctx, cfg,
                           local=kind == "local", use_moe=False,
                           post_norm=cfg.post_norm)
    return h, 0.0


def _sub(tree, i):
    """The i-th slice of every leaf of a stacked tree (None stays None:
    train mode has no cache)."""
    return None if tree is None else tree_map(lambda t: t[i], tree)


def _field(cache, key):
    return None if cache is None else cache[key]


def _write_state(cache, new):
    """Copy a block's new recurrent state into its cache views (train
    mode has no cache); under a mesh, into the rank's local tiles."""
    if cache is not None:
        def write(c, x):
            if c.shape != x.shape:
                raise ValueError(f"a state of shape {tuple(x.shape)} for a "
                                 f"cache tile of {tuple(c.shape)}")
            c.copy_(x)

        tree_map(write, cache, new)


def _on_ranks(run, layout, p, h, cache, ctx):
    """A recurrent block under a mesh, on each rank's local tensors
    (``sharding.shard_map``): ``run(p, h, cache, **splits)`` gets the
    rank's weights, laid out by ``layout(p, lead)`` (the block's split
    axes by name, and each weight's spec by its path), its rows of the
    constrained residual stream with the sequence whole, and its tiles of
    the cache leaves at their own placements (the views it writes in
    place); it returns the new residual stream's rows, replicated over
    every other axis.  The rows follow the cache's batch spec where
    there is a cache."""
    mesh = ctx["mesh"]
    h, lead = sharding.lead_spec(_constrain(ctx, h))
    c_leaves = [] if cache is None else tree_leaves(cache)
    rows = sharding.spec_of(c_leaves[0])[0] if c_leaves else lead[0]
    axes, spec = layout(p, (rows,))
    splits = {k: sharding.Split(mesh, a) for k, a in axes.items()}
    p_leaves, p_specs = tree_leaves(p), []
    tree_map_with_path(lambda path, t: p_specs.append(spec(path, t)), p)
    n = len(p_leaves)

    def f(hl, *locs):
        cl = None if cache is None else tree_unflatten(cache, list(locs[n:]))
        return run(tree_unflatten(p, list(locs[:n])), hl, cl, **splits)

    io = (rows, None, None)
    return sharding.shard_map(
        f, mesh, (io, *p_specs, *map(sharding.spec_of, c_leaves)), io)(
            h, *p_leaves, *c_leaves)


def _mamba_block_specs(cfg):
    return {"ln": norm_specs(cfg.d_model, cfg.norm), "mamba": m2.mamba2_specs(cfg)}


def _shared_attn_specs(cfg):
    d = cfg.d_model
    return {
        "ln_attn": norm_specs(d, cfg.norm),
        "attn": attn.attention_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "ln_mlp": norm_specs(d, cfg.norm),
        "mlp": mlp_specs(d, cfg.shared_attn_d_ff or cfg.d_ff),
    }


def _impl(ctx) -> str:
    """The recurrent layers' path: train follows ``attn_impl``; prefill
    and decode run the kernels."""
    return ctx["attn_impl"] if ctx["mode"] == "train" else "kernel"


def _mamba_run(p, h, cache, *, cfg, read, impl, inner=sharding.WHOLE):
    x = apply_norm(p["ln"], h, cfg.norm, cfg.norm_eps)
    y, new_state = m2.mamba2_apply(p["mamba"], x, cfg,
                                   state=cache if read else None, impl=impl,
                                   inner=inner)
    _write_state(cache, new_state)
    return h + y


def _mamba_layout(p, lead):
    """``m2.rank_layout`` for the block's mixer; its norm whole."""
    axes, spec = m2.rank_layout(p["mamba"], lead)
    return axes, lambda path, t: (
        spec(path[1:], t) if path[0] == "mamba" else (None,) * t.ndim)


def _mamba_block(p, h, cache, ctx, cfg):
    run = partial(_mamba_run, cfg=cfg, read=ctx["mode"] == "decode",
                  impl=_impl(ctx))
    if ctx.get("mesh") is not None:
        return _on_ranks(run, _mamba_layout, p, h, cache, ctx), 0.0
    return run(p, h, cache), 0.0


def _xlstm_run(apply, p, h, cache, *, cfg, read, **splits):
    """An mLSTM or sLSTM block (``apply`` norms its own input); its cache
    is the state list, written in place."""
    y, new_state = apply(p, h, cfg, state=tuple(cache) if read else None,
                         **splits)
    _write_state(cache, new_state)
    return h + y


def _xlstm_block(apply, layout, p, h, cache, ctx, cfg):
    run = partial(_xlstm_run, apply, cfg=cfg, read=ctx["mode"] == "decode")
    if ctx.get("mesh") is not None:
        return _on_ranks(run, layout, p, h, cache, ctx)
    return run(p, h, cache)


def _inner_stack(block, p, h, cache, ctx, k: int):
    """``block(p_j, h, cache_j)`` over the k blocks of a stacked group,
    each under ``ctx["remat"]`` inside the group's own (the reference
    scans them as a stack of its own, rematerialised per block)."""
    for j in range(k):
        h = remat_call(ctx.get("remat", "none"),
                       partial(block, _sub(p, j), cache=_sub(cache, j)), h)
    return h


def _super_block(p, h, cache, ctx, cfg, *, k: int):
    """k Mamba2 blocks, then the shared attention + MLP block."""
    h = _inner_stack(lambda pj, hj, cache: _mamba_block(pj, hj, cache, ctx,
                                                        cfg)[0],
                     p["mamba"], h, _field(cache, "mamba"), ctx, k)
    return _attn_block(ctx["shared_attn"], h, _field(cache, "attn"), ctx,
                       cfg, local=False, use_moe=False, post_norm=False)


def _xgroup_block(p, h, cache, ctx, cfg, *, m: int):
    """m mLSTM blocks, then one sLSTM block."""
    h = _inner_stack(lambda pj, hj, cache: _xlstm_block(
        xl.mlstm_apply, xl.mlstm_layout, pj, hj, cache, ctx, cfg),
        p["mlstm"], h, _field(cache, "mlstm"), ctx, m)
    return _xlstm_block(partial(xl.slstm_apply, impl=_impl(ctx)),
                        xl.slstm_layout, p["slstm"], h, _field(cache, "slstm"),
                        ctx, cfg), 0.0


@dataclass
class StageDef:
    name: str
    n: int                                   # stacked length
    block_specs: Any                         # unstacked per-block spec tree
    block_fn: Callable                       # (p, h, cache_l, ctx) -> (h, aux)
    cache_specs: Callable                    # (cfg, B, T, dtype) -> per-layer WSpecs
    shared_specs: Any = None                 # unstacked weights (zamba2 shared attn)


def _kv_cache_specs(cfg, B, T, dtype):
    K, D = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": WSpec((B, T, K, D), ("cache_batch", "cache_seq", "cache_heads", None),
                   init="zeros", dtype=dtype),
        "v": WSpec((B, T, K, D), ("cache_batch", "cache_seq", "cache_heads", None),
                   init="zeros", dtype=dtype),
    }


def _mla_cache_specs(cfg, B, T, dtype):
    return {
        "ckv": WSpec((B, T, cfg.kv_lora_rank),
                     ("cache_batch", "cache_seq", None), init="zeros", dtype=dtype),
        "kr": WSpec((B, T, cfg.qk_rope_dim),
                    ("cache_batch", "cache_seq", None), init="zeros", dtype=dtype),
    }


def _mamba_cache_specs(cfg, B, T, dtype):
    d_in, H, N = m2.mamba2_dims(cfg)
    W = cfg.mamba_conv_width
    return {
        "ssm": WSpec((B, H, N, cfg.mamba_head_dim),
                     ("cache_batch", "ssm_heads", None, None), init="zeros",
                     dtype=torch.float32),
        "conv_x": WSpec((B, W - 1, d_in), ("cache_batch", None, "ssm_inner"),
                        init="zeros", dtype=dtype),
        "conv_B": WSpec((B, W - 1, N), ("cache_batch", None, None), init="zeros",
                        dtype=dtype),
        "conv_C": WSpec((B, W - 1, N), ("cache_batch", None, None), init="zeros",
                        dtype=dtype),
    }


def _mlstm_cache_specs(cfg, B, T, dtype):
    d_in, H, hd = xl.mlstm_dims(cfg)
    return [
        WSpec((B, H, hd, hd), ("cache_batch", "ssm_heads", None, None),
              init="zeros", dtype=torch.float32),
        WSpec((B, H, hd), ("cache_batch", "ssm_heads", None), init="zeros",
              dtype=torch.float32),
        WSpec((B, H), ("cache_batch", "ssm_heads"), init="zeros",
              dtype=torch.float32),
    ]


def _slstm_cache_specs(cfg, B, T, dtype):
    return [WSpec((B, cfg.d_model), ("cache_batch", None), init="zeros",
                  dtype=torch.float32) for _ in range(4)]


def _stacked(spec_tree, k):
    """Per-layer cache specs with a leading stacked axis of length k."""
    return tree_map(lambda ws: replace(ws, shape=(k, *ws.shape),
                                       axes=("layers", *ws.axes)), spec_tree)


def make_stages(cfg) -> list[StageDef]:
    fam = cfg.family
    if fam in ("dense", "vlm") and cfg.attn_pattern:  # gemma2 pairs
        pat = cfg.attn_pattern
        return [StageDef(
            "pairs", cfg.n_layers // len(pat),
            {f"sub{i}": _attn_block_specs(cfg, False, cfg.post_norm)
             for i in range(len(pat))},
            partial(_pair_block, cfg=cfg, pat=pat),
            lambda cfg_, B, T, dtype, k=len(pat): [
                _kv_cache_specs(cfg_, B, T, dtype) for _ in range(k)])]
    if fam in ("dense", "vlm") or (fam == "moe" and not cfg.use_mla):
        use_moe = fam == "moe"
        return [StageDef(
            "moe" if use_moe else "blocks", cfg.n_layers,
            _attn_block_specs(cfg, use_moe, cfg.post_norm),
            partial(_attn_block, cfg=cfg, local=False, use_moe=use_moe,
                    post_norm=cfg.post_norm),
            _kv_cache_specs,
        )]
    if fam == "moe":  # deepseek: MLA, a dense stage, then the moe stage
        stages = []
        if cfg.first_dense_layers:
            stages.append(StageDef(
                "dense", cfg.first_dense_layers, _mla_block_specs(cfg, False),
                partial(_mla_block, cfg=cfg, use_moe=False), _mla_cache_specs))
        stages.append(StageDef(
            "moe", cfg.n_layers - cfg.first_dense_layers,
            _mla_block_specs(cfg, True),
            partial(_mla_block, cfg=cfg, use_moe=True), _mla_cache_specs))
        return stages
    if fam == "hybrid":  # zamba2: superblocks of mamba + shared attention
        k = cfg.n_mamba_per_super
        n_super = cfg.n_layers // k
        tail = cfg.n_layers - n_super * k
        stages = [StageDef(
            "super", n_super,
            {"mamba": stack_specs(_mamba_block_specs(cfg), k)},
            partial(_super_block, cfg=cfg, k=k),
            lambda cfg_, B, T, dtype, k=k: {
                "mamba": _stacked(_mamba_cache_specs(cfg_, B, T, dtype), k),
                "attn": _kv_cache_specs(cfg_, B, T, dtype)},
            shared_specs=_shared_attn_specs(cfg))]
        if tail:
            stages.append(StageDef(
                "tail", tail, _mamba_block_specs(cfg),
                partial(_mamba_block, cfg=cfg), _mamba_cache_specs))
        return stages
    if fam == "ssm":  # xLSTM m:1 groups
        m = cfg.mlstm_to_slstm
        return [StageDef(
            "xgroup", cfg.n_layers // (m + 1),
            {"mlstm": stack_specs(xl.mlstm_specs(cfg), m),
             "slstm": xl.slstm_specs(cfg)},
            partial(_xgroup_block, cfg=cfg, m=m),
            lambda cfg_, B, T, dtype, m=m: {
                "mlstm": [_stacked(ws, m)
                          for ws in _mlstm_cache_specs(cfg_, B, T, dtype)],
                "slstm": _slstm_cache_specs(cfg_, B, T, dtype)})]
    raise ValueError(f"make_stages: unsupported family {fam}")
