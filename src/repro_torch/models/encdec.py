"""Encoder-decoder model (whisper-tiny family).

The conv audio frontend is a STUB, as in the JAX package: requests carry
precomputed frame embeddings (B, encoder_seq, d_model).  The encoder is
a bidirectional transformer; the decoder adds cross-attention over the
encoder output.  Positions are sinusoidal (parameter-free).

S2M3 view: the encoder is a modality-wise *encoder module*; the decoder
is the *task head module*.

Where the reference scans the stacked layers, the port loops over the
layer index and writes each layer's cache slice in place.  Attention
goes through the kernels: the encoder's non-causal self-attention and
the decoder's causal self-attention and non-causal cross-attention
(S prompt queries against the T encoder keys) through the flash kernel
in prefill; in decode, the self-attention through the decode kernel
over the dense cache up to ``lengths + 1`` and the cross-attention
through the decode kernel over the cached cross K/V with lengths = T.
``loss_fn`` (train mode, no cache) runs all three attentions through
``attn_impl`` (plain torch by default: the kernels have no backward)
and each encoder and decoder layer under ``remat``.  The activations
are in ``compute_dtype`` (bfloat16 by default, as in the reference: the
audio frames, their projection, the token embedding and the sinusoids
are cast to it), the logits float32.

Under a mesh (``build_encdec(cfg, mesh, rules)``) the weights and caches
are DTensors placed by the rules, each decoder block constrains its
residual stream as the reference's does, every attention core and
decode kernel runs per rank on local tensors (``layers.attention``),
and cache writes land in each rank's local tile.  As in the reference,
the decoder's self-attention cache takes the "scatter" update.
"""

from __future__ import annotations

import math
from functools import partial
from typing import Any

import torch

from repro_torch.common import sharding
from repro_torch.common.pytree import tree_map
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.embedding import embed_apply, embed_specs, head_apply
from repro_torch.layers.initializers import WSpec, stack_specs
from repro_torch.layers.mlp import mlp_apply, mlp_specs
from repro_torch.layers.norms import apply_norm, norm_specs
from repro_torch.layers.remat import remat_call


def sinusoid(positions, d_model):
    """positions: (B, S) -> (B, S, d) float32 sinusoidal embedding."""
    half = d_model // 2
    freq = torch.exp(-torch.arange(half, dtype=torch.float32,
                                   device=positions.device)
                     * (math.log(10000.0) / max(half - 1, 1)))
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _enc_block_specs(cfg):
    d = cfg.d_model
    return {
        "ln_attn": norm_specs(d, cfg.norm),
        "attn": attn_lib.attention_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "ln_mlp": norm_specs(d, cfg.norm),
        "mlp": mlp_specs(d, cfg.d_ff),
    }


def _dec_block_specs(cfg):
    d = cfg.d_model
    return {
        "ln_self": norm_specs(d, cfg.norm),
        "self_attn": attn_lib.attention_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "ln_cross": norm_specs(d, cfg.norm),
        "cross_attn": attn_lib.attention_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim),
        "ln_mlp": norm_specs(d, cfg.norm),
        "mlp": mlp_specs(d, cfg.d_ff),
    }


def _enc_block(p, positions, cfg, impl, mesh, rules, h):
    x = apply_norm(p["ln_attn"], h, cfg.norm, cfg.norm_eps)
    y, _ = attn_lib.attention_apply(p["attn"], x, positions=positions,
                                    cfg=cfg, causal=False, impl=impl,
                                    mesh=mesh, rules=rules)
    h = h + y
    x = apply_norm(p["ln_mlp"], h, cfg.norm, cfg.norm_eps)
    return h + mlp_apply(p["mlp"], x, cfg.act_fn)


def _dec_block(p, cache, ctx, cfg, enc_out, enc_positions, h):
    """cache: {self: {k,v}, cross: {k,v}}, this layer's views, written in
    place (prefill fills both; decode appends one self k/v per row;
    train has none)."""
    mode = ctx["mode"]
    positions = ctx["positions"]
    mesh, rules = ctx.get("mesh"), ctx.get("rules")
    h = ctx["constrain"](h)

    # --- self attention ---
    x = apply_norm(p["ln_self"], h, cfg.norm, cfg.norm_eps)
    if mode == "train":
        y, _ = attn_lib.attention_apply(p["self_attn"], x,
                                        positions=positions, cfg=cfg,
                                        impl=ctx["attn_impl"], mesh=mesh,
                                        rules=rules)
    elif mode == "prefill":
        y, (k, v) = attn_lib.attention_apply(p["self_attn"], x,
                                             positions=positions, cfg=cfg,
                                             mesh=mesh, rules=rules)
        attn_lib.cache_write_prefix(cache["self"]["k"], k)
        attn_lib.cache_write_prefix(cache["self"]["v"], v)
    else:
        lengths = ctx["lengths"]
        q, k_new, v_new = attn_lib.project_qkv(p["self_attn"], x, positions, cfg)
        attn_lib.cache_insert(cache["self"]["k"], k_new, lengths, mesh=mesh,
                              rules=rules)
        attn_lib.cache_insert(cache["self"]["v"], v_new, lengths, mesh=mesh,
                              rules=rules)
        out = attn_lib.decode_attend(
            q, cache["self"]["k"], cache["self"]["v"], lengths + 1,
            softcap=cfg.attn_logit_softcap, mesh=mesh, rules=rules)
        y = attn_lib.output_proj(p["self_attn"], out, x.dtype)
    h = h + y

    # --- cross attention ---
    x = apply_norm(p["ln_cross"], h, cfg.norm, cfg.norm_eps)
    if mode == "train":
        y, _ = attn_lib.attention_apply(
            p["cross_attn"], x, positions=positions, cfg=cfg,
            cross_kv=attn_lib.cross_kv_project(p["cross_attn"], enc_out, cfg),
            cross_positions=enc_positions, impl=ctx["attn_impl"], mesh=mesh,
            rules=rules)
    elif mode == "prefill":
        ck, cv = attn_lib.cross_kv_project(p["cross_attn"], enc_out, cfg)
        attn_lib.cache_write_prefix(cache["cross"]["k"], ck)
        attn_lib.cache_write_prefix(cache["cross"]["v"], cv)
        y, _ = attn_lib.attention_apply(
            p["cross_attn"], x, positions=positions, cfg=cfg,
            cross_kv=(ck, cv), cross_positions=enc_positions, mesh=mesh,
            rules=rules)
    else:
        y = attn_lib.cross_attention_decode(
            p["cross_attn"], x, cache["cross"]["k"], cache["cross"]["v"], cfg,
            positions=positions, mesh=mesh, rules=rules)
    h = h + y

    x = apply_norm(p["ln_mlp"], h, cfg.norm, cfg.norm_eps)
    return h + mlp_apply(p["mlp"], x, cfg.act_fn)


def _layer(tree, i):
    return tree_map(lambda t: t[i], tree)


def _encode(cfg, params, frames, dtype, impl="kernel", remat="none",
            mesh=None, rules=None):
    B, S = frames.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=frames.device).expand(B, S)
    h = frames.to(dtype) @ params["audio_proj"]["w"].to(dtype)
    h = h + sinusoid(positions, cfg.d_model).to(dtype)
    for i in range(cfg.n_encoder_layers):
        h = remat_call(remat, partial(_enc_block, _layer(params["encoder"], i),
                                      positions, cfg, impl, mesh, rules), h)
    h = apply_norm(params["enc_norm"], h, cfg.norm, cfg.norm_eps)
    return h, positions


def build_encdec(cfg, mesh=None, rules=None, **opts):
    from repro_torch.models.api import (
        ModelBundle, _constrainer, _token_batch, compute_dtype, cross_entropy,
        last_rows, train_options,
    )

    # z_loss is not read: the reference's encoder-decoder loss is the
    # plain cross entropy
    attn_impl, remat, _ = train_options(opts)
    dt = compute_dtype(opts)
    rules = sharding.merge_rules(rules if isinstance(rules, dict) else None)
    scope = partial(sharding.mesh_scope, mesh)

    def _ctx(mode, positions, lengths):
        return {"mode": mode, "positions": positions, "lengths": lengths,
                "attn_impl": attn_impl, "mesh": mesh, "rules": rules,
                "constrain": _constrainer(mesh, rules)}
    n_dec = cfg.n_layers
    specs: dict[str, Any] = {
        "audio_proj": {"w": WSpec((cfg.d_model, cfg.d_model), (None, "embed"))},
        "encoder": stack_specs(_enc_block_specs(cfg), cfg.n_encoder_layers),
        "enc_norm": norm_specs(cfg.d_model, cfg.norm),
        "embed": embed_specs(cfg.vocab_size, cfg.d_model),
        "decoder": stack_specs(_dec_block_specs(cfg), n_dec),
        "final_norm": norm_specs(cfg.d_model, cfg.norm),
    }

    def _dec_embed(params, tokens, positions):
        h = embed_apply(params["embed"], tokens, dtype=dt)
        return h + sinusoid(positions, cfg.d_model).to(dt)

    def _head(params, h):
        # whisper ties the decoder embedding and the output head
        return head_apply(None, h, tied_table=params["embed"]["table"])

    def _run_decoder(params, h, ctx, cache, enc_out, enc_positions,
                     remat="none"):
        for i in range(n_dec):
            cl = None if cache is None else _layer(cache, i)
            h = remat_call(remat, partial(
                _dec_block, _layer(params["decoder"], i), cl, ctx, cfg,
                enc_out, enc_positions), h)
        return h

    def loss_fn(params, batch):
        with scope():
            enc_out, enc_pos = _encode(cfg, params, batch["audio_frames"], dt,
                                       attn_impl, remat, mesh, rules)
            tokens = batch["tokens"]
            B, S = tokens.shape
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
            h = _dec_embed(params, tokens, positions)
            h = _run_decoder(params, h, _ctx("train", positions, None), None,
                             enc_out, enc_pos, remat)
            h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
            loss = cross_entropy(_head(params, h), batch["targets"],
                                 batch["mask"])
            return loss, {"loss": loss, "ce": loss}

    def prefill(params, batch, cache):
        with scope():
            enc_out, enc_pos = _encode(cfg, params, batch["audio_frames"], dt,
                                       mesh=mesh, rules=rules)
            tokens = batch["tokens"]
            B, S = tokens.shape
            positions = torch.arange(S, dtype=torch.int32,
                                     device=tokens.device).expand(B, S)
            lengths = batch.get("lengths")
            if lengths is None:
                lengths = torch.full((B,), S, dtype=torch.int32,
                                     device=tokens.device)
            h = _dec_embed(params, tokens, positions)
            h = _run_decoder(params, h, _ctx("prefill", positions, lengths),
                             cache, enc_out, enc_pos)
            h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
            return _head(params, last_rows(h, lengths))[:, 0], cache

    def decode_step(params, tokens, cache, lengths):
        with scope():
            positions = lengths[:, None].to(torch.int32)
            h = _dec_embed(params, tokens, positions)
            h = _run_decoder(params, h, _ctx("decode", positions, lengths),
                             cache, None, None)
            h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
            return _head(params, h)[:, 0], cache

    def cache_specs(B, T, dtype=torch.bfloat16):
        K, D = cfg.n_kv_heads, cfg.head_dim

        def kv(t):
            return {
                "k": WSpec((n_dec, B, t, K, D),
                           ("layers", "cache_batch", "cache_seq", "cache_heads", None),
                           init="zeros", dtype=dtype),
                "v": WSpec((n_dec, B, t, K, D),
                           ("layers", "cache_batch", "cache_seq", "cache_heads", None),
                           init="zeros", dtype=dtype),
            }

        return {"self": kv(T), "cross": kv(cfg.encoder_seq)}

    def batch_specs(shape):
        """The reference's: the decoder's tokens and the encoder's audio
        frames (none at decode, which reads the cached cross k/v)."""
        B, S = shape.global_batch, shape.seq_len
        frames = {} if shape.kind == "decode" else {"audio_frames": WSpec(
            (B, cfg.encoder_seq, cfg.d_model), ("batch", None, None),
            dtype=dt)}
        return _token_batch(shape, B, S, frames)

    return ModelBundle(cfg=cfg, specs=specs, loss_fn=loss_fn, prefill=prefill,
                       decode_step=decode_step, cache_specs=cache_specs,
                       mesh=mesh, rules=rules, batch_specs=batch_specs,
                       compute_dtype=dt)
