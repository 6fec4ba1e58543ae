"""Decoder-only LM blocks: embedding -> [stage] -> final norm -> head.

The port covers the dense/vlm ``"blocks"`` stage: a stack of
homogeneous attention + gated-MLP blocks whose weights are stacked on a
leading layer axis, as in the JAX package.  Where the reference scans
the stack, the port loops over the layer index; each layer's weights
and cache are views into the stacked tensors, so cache writes land in
place.

Modes: "prefill" (fills the dense cache through the flash attention
kernel) and "decode" (one token per row against a dense cache through
the decode attention kernel, or against a paged pool through the paged
decode kernel).  Windowed (local) layers and the pairs / moe / hybrid /
ssm stages are not ported yet and raise.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.kernels import ops as kops
from repro_torch.layers import attention as attn
from repro_torch.layers.initializers import WSpec
from repro_torch.layers.mlp import mlp_apply, mlp_specs
from repro_torch.layers.norms import apply_norm, norm_specs


def _attn_block_specs(cfg, post_norm: bool):
    d = cfg.d_model
    specs = {
        "ln_attn": norm_specs(d, cfg.norm),
        "attn": attn.attention_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "ln_mlp": norm_specs(d, cfg.norm),
        "mlp": mlp_specs(d, cfg.d_ff),
    }
    if post_norm:
        specs["ln_attn_post"] = norm_specs(d, cfg.norm)
        specs["ln_mlp_post"] = norm_specs(d, cfg.norm)
    return specs


def _apply_attn_sub(p, h, cache, ctx, cfg, *, local: bool, post_norm: bool):
    """Norm + attention + residual (+post-norm); writes the layer's
    cache in place.  Returns the new residual stream."""
    if local:
        raise NotImplementedError(
            "windowed (local) attention layers are not ported yet")
    x = apply_norm(p["ln_attn"], h, cfg.norm, cfg.norm_eps)
    if ctx["mode"] == "prefill":
        S = x.shape[1]
        y, (k, v) = attn.attention_apply(p["attn"], x,
                                         positions=ctx["positions"], cfg=cfg)
        cache["k"][:, :S] = k.to(cache["k"].dtype)
        cache["v"][:, :S] = v.to(cache["v"].dtype)
    else:  # decode: one token per row at position `lengths`
        lengths = ctx["lengths"]
        q, k_new, v_new = attn.project_qkv(p["attn"], x, ctx["positions"], cfg)
        if ctx.get("cache_layout") == "paged":
            return _paged_attn_decode(p, h, x, cache, q, k_new, v_new, ctx,
                                      cfg, post_norm=post_norm)
        attn.cache_insert(cache["k"], k_new, lengths)
        attn.cache_insert(cache["v"], v_new, lengths)
        out = kops.decode_attention(
            q[:, 0].contiguous(), cache["k"], cache["v"],
            (lengths + 1).to(torch.int32),
            softcap=cfg.attn_logit_softcap)[:, None]
        y = attn.output_proj(p["attn"], out, x.dtype)
    if post_norm:
        y = apply_norm(p["ln_attn_post"], y, cfg.norm, cfg.norm_eps)
    return h + y


def _paged_attn_decode(p, h, x, cache, q, k_new, v_new, ctx, cfg, *,
                       post_norm: bool):
    """Decode step against a paged KV cache: the layer's cache leaves
    are global page pools (n_pages, page_size, K, D) and
    ``ctx["block_tables"]`` (B, n_max) names each row's pages.  One
    batched paged decode kernel launch serves every row."""
    lengths = ctx["lengths"]
    tables = ctx["block_tables"]
    attn.paged_cache_insert(cache["k"], k_new, tables, lengths)
    attn.paged_cache_insert(cache["v"], v_new, tables, lengths)
    out = kops.paged_decode_attention(
        q[:, 0].contiguous(), cache["k"], cache["v"], tables, (lengths + 1).to(torch.int32),
        softcap=cfg.attn_logit_softcap)[:, None]
    y = attn.output_proj(p["attn"], out, x.dtype)
    if post_norm:
        y = apply_norm(p["ln_attn_post"], y, cfg.norm, cfg.norm_eps)
    return h + y


def _apply_ffn_sub(p, h, cfg, *, post_norm: bool):
    x = apply_norm(p["ln_mlp"], h, cfg.norm, cfg.norm_eps)
    y = mlp_apply(p["mlp"], x, cfg.act_fn)
    if post_norm:
        y = apply_norm(p["ln_mlp_post"], y, cfg.norm, cfg.norm_eps)
    return h + y


def _attn_block(p, h, cache, ctx, cfg, *, local: bool, post_norm: bool):
    h = _apply_attn_sub(p, h, cache, ctx, cfg, local=local,
                        post_norm=post_norm)
    return _apply_ffn_sub(p, h, cfg, post_norm=post_norm)


@dataclass
class StageDef:
    name: str
    n: int                                   # stacked length
    block_specs: Any                         # unstacked per-block spec tree
    block_fn: Callable                       # (p, h, cache_l, ctx) -> h
    cache_specs: Callable                    # (cfg, B, T, dtype) -> per-layer WSpecs


def _kv_cache_specs(cfg, B, T, dtype):
    K, D = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": WSpec((B, T, K, D), ("cache_batch", "cache_seq", "cache_heads", None),
                   init="zeros", dtype=dtype),
        "v": WSpec((B, T, K, D), ("cache_batch", "cache_seq", "cache_heads", None),
                   init="zeros", dtype=dtype),
    }


def make_stages(cfg) -> list[StageDef]:
    if cfg.family not in ("dense", "vlm") or cfg.attn_pattern:
        raise NotImplementedError(
            f"make_stages: only the dense/vlm 'blocks' stage is ported; "
            f"{cfg.name!r} (family {cfg.family!r}, attn_pattern "
            f"{cfg.attn_pattern!r}) needs a later slice")
    return [StageDef(
        "blocks", cfg.n_layers, _attn_block_specs(cfg, cfg.post_norm),
        partial(_attn_block, cfg=cfg, local=False, post_norm=cfg.post_norm),
        _kv_cache_specs,
    )]
