"""Public model API: build_model(cfg) -> ModelBundle.

A ModelBundle packages weight specs with the step functions of one
architecture: ``loss_fn`` (the training loss and its metrics),
``prefill`` (batch prefill into a dense cache), ``decode_step`` (one
token per row against the dense cache) and ``paged_decode_step`` (one
token per row against a global page pool).  Caches are updated in place
and returned for symmetry with the JAX package, whose functions return
new caches.  A config with ``mtp_depth`` (deepseek) carries the
reference's multi-token-prediction weights (``params["mtp"]``); only the
loss reads them (``_mtp_loss``), as in the reference.

``build_model(cfg, mesh=None, rules=None, **opts)`` reads the
reference's options that shape the loss: ``attn_impl`` ("xla", the
default, differentiates through plain torch; "kernel" runs the
hand-written kernels, which have no backward, so only under
``torch.no_grad()`` on the card), ``remat`` ("full" by default; "none",
"dots": ``layers.remat``), ``z_loss`` and ``softmax_dtype`` (the plain
attention's softmax, float32 by default).  Serving runs the kernels
whatever they say.  ``compute_dtype`` (a torch dtype, or "bfloat16" /
"float32") is read as the reference's ``build_model`` reads it, with its
default of bfloat16: the embedding, the image prefix and the MTP input
come out in it, and every projection casts its weight to its input's
dtype at use, so float32 weights under bfloat16 compute make a
transient bfloat16 copy a use.  Norms, rotary angles, softmaxes, router
logits and the recurrences (SSD, mLSTM, sLSTM) widen to float32 where
the reference's do and narrow back after; the logits are float32.
``init_cache``, ``init_paged_cache``, ``cache_specs`` and
``paged_cache_specs`` default to bfloat16, as the reference's do; the
serving engine asks for float32 caches, as the reference's engine does,
and the decode attention widens q to a wider cache's dtype
(``layers.attention.decode_attend``).  Callers held to the reference at
float32 pass ``compute_dtype=torch.float32``.  The paged serving knobs
are accepted and not read.

With a ``mesh`` (a ``DeviceMesh`` named ("data", "model") or ("pod",
"data", "model"), see ``common.sharding``) the bundle is the
reference's sharded model: ``init``/``init_cache`` return DTensors
placed by the logical-axis ``rules`` (``merge_rules(rules)``), each
step runs as DTensor ops (plain tensors met inside count as replicated)
with the residual stream constrained to ("batch", "seq", "act_embed")
at every block, the attention cores, the decode kernels and the
expert-parallel MoE run per rank on local tensors, and the logits come
back as DTensors (``.full_tensor()``).  The reference's serving options
are read under a mesh: ``moe_impl`` ("ep" by default there, "dense"),
``cache_update`` ("scatter", "blend", "shard"), ``decode_attn``
("default", "gatherq", "shardmap") and ``attn_sp``; and one the
reference does not have, ``moe_capacity_factor`` (1.25, the capacity
factor the reference's ``moe_apply_ep`` is called with: at
``n_experts / experts_top_k`` no token is ever dropped).  The recurrent
families (hybrid, ssm) run each Mamba2, mLSTM and sLSTM block on its
rank's heads (``models.lm``), their state caches DTensors placed by the
same rules.  ``init_paged_cache`` returns DTensor pools placed by the
same rules (pages over "cache_batch", each page's slots over
"cache_seq"), and ``paged_decode_step`` runs the paged kernel on each
rank's tile of them with the ranks' partial softmaxes combined
(``models.lm._paged_attn_decode``); ``serving.kvcache.insert_pages``
copies a one-row prefill cache into such a pool, each rank its tile.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from functools import partial
from typing import Any, Callable

import torch

from repro_torch.common import sharding
from repro_torch.common.config import ArchConfig
from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.layers import attention as attn_lib
from repro_torch.layers import mla as mla_lib
from repro_torch.layers.embedding import embed_apply, embed_specs, head_apply, head_specs
from repro_torch.layers.initializers import (
    WSpec, abstract_tree, init_leaf, init_tree, spec_param_count, stack_specs,
)
from repro_torch.layers.mlp import mlp_apply, mlp_specs
from repro_torch.layers.moe import padded_experts
from repro_torch.layers.norms import apply_norm, norm_specs
from repro_torch.layers.remat import REMATS, remat_call
from repro_torch.models.lm import make_stages


def _is_ws(x):
    return isinstance(x, WSpec)


@dataclass
class ModelBundle:
    cfg: ArchConfig
    specs: Any                       # weights WSpec tree
    loss_fn: Callable                # (params, batch) -> (loss, metrics)
    prefill: Callable                # (params, batch, cache) -> (logits_last, cache)
    decode_step: Callable            # (params, tokens, cache, lengths) -> (logits, cache)
    cache_specs: Callable            # (B, T, dtype) -> WSpec tree
    paged_decode_step: Callable | None = None   # (params, tokens, cache,
    #                                              block_tables, lengths)
    paged_cache_specs: Callable | None = None   # (n_pages, page_size, dtype)
    mesh: Any = None                 # a DeviceMesh: the sharded model
    rules: Any = None                # the merged logical-axis rules
    batch_specs: Callable | None = None  # (ShapeConfig) -> WSpec tree
    compute_dtype: torch.dtype = torch.bfloat16  # the activations' dtype

    # ``device=None`` is the card (``common.device.resolve_device``):
    # with no CUDA device these raise unless the caller names "cpu".
    # Under a mesh each leaf is drawn whole on every rank (the same
    # seeded draws) and only this rank's slice is kept.
    def init(self, generator: torch.Generator, dtype=torch.float32,
             device=None):
        return self._init(self.specs, generator, dtype, device)

    def _init(self, specs, generator, dtype, device):
        dev = resolve_device(device)
        if self.mesh is None:
            return init_tree(specs, generator, dtype, dev)
        pl = sharding.tree_placements(specs, self.rules, self.mesh)
        return tree_map(lambda ws, p: sharding.shard_leaf(
            init_leaf(ws, generator, dtype, dev), self.mesh, p), specs, pl)

    def abstract_params(self, param_dtype=torch.bfloat16):
        """The weights as ``meta`` tensors (``abstract``)."""
        return self.abstract(self.specs, param_dtype)

    def abstract(self, specs, dtype):
        """Any spec tree of this model (weights, cache, batch, optimizer
        state) as ``meta`` tensors (``layers.initializers.abstract_tree``):
        under a mesh, DTensors placed by the rules, with this rank's local
        shapes."""
        if self.mesh is None:
            return abstract_tree(specs, dtype)
        return abstract_tree(specs, dtype, sharding.tree_placements(
            specs, self.rules, self.mesh), self.mesh)

    def param_count(self) -> int:
        return spec_param_count(self.specs)

    @property
    def supports_paged_decode(self) -> bool:
        return self.paged_decode_step is not None

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top-k of routed experts)."""
        cfg = self.cfg
        total = self.param_count()
        if not cfg.n_experts:
            return total
        per_expert = 3 * cfg.d_model * (cfg.moe_d_ff or cfg.d_ff)
        n_moe_layers = cfg.n_layers - cfg.first_dense_layers
        routed = padded_experts(cfg) * per_expert * n_moe_layers
        active = cfg.experts_top_k * per_expert * n_moe_layers
        return total - routed + active

    def kv_bytes_per_token(self) -> int:
        """Float32 cache bytes one token takes over every layer (what
        ``ModuleSpec.kv_bytes_per_token`` declares for the page-budget
        pre-flight): the cache specs at one row of one position.  Only
        a family with a paged layout has a cache that grows by token."""
        if self.paged_cache_specs is None:
            raise NotImplementedError(
                f"family {self.cfg.family!r} has no per-token KV cache")
        return sum(math.prod(ws.shape) * ws.dtype.itemsize for ws in
                   tree_leaves(self.cache_specs(1, 1, torch.float32)))

    def init_cache(self, B: int, T: int, dtype=torch.bfloat16, device=None):
        return self._init(self.cache_specs(B, T, dtype), None, dtype, device)

    def init_paged_cache(self, n_pages: int, page_size: int,
                         dtype=torch.bfloat16, device=None):
        if self.paged_cache_specs is None:
            raise NotImplementedError(
                f"family {self.cfg.family!r} has no paged-KV cache layout")
        return self._init(self.paged_cache_specs(n_pages, page_size, dtype),
                          None, dtype, device)


def _lm_specs(cfg, stages):
    sp: dict[str, Any] = {
        "embed": embed_specs(cfg.vocab_size, cfg.d_model),
        "stages": {},
        "final_norm": norm_specs(cfg.d_model, cfg.norm),
    }
    for st in stages:
        entry = {"blocks": stack_specs(st.block_specs, st.n)}
        if st.shared_specs is not None:
            entry["shared"] = st.shared_specs
        sp["stages"][st.name] = entry
    if not cfg.tie_embeddings:
        sp["head"] = head_specs(cfg.d_model, cfg.vocab_size)
    if cfg.has_vision_stub and cfg.image_proj:
        sp["img_proj"] = {"w": WSpec((cfg.d_model, cfg.d_model), (None, "embed"))}
    if cfg.mtp_depth:
        d = cfg.d_model
        sp["mtp"] = {
            "proj": WSpec((2 * d, d), (None, "embed")),
            "norm_h": norm_specs(d, cfg.norm),
            "norm_e": norm_specs(d, cfg.norm),
            "block": {
                "ln_attn": norm_specs(d, cfg.norm),
                "attn": mla_lib.mla_specs(cfg) if cfg.use_mla
                else attn_lib.attention_specs(d, cfg.n_heads, cfg.n_kv_heads,
                                              cfg.head_dim),
                "ln_mlp": norm_specs(d, cfg.norm),
                "mlp": mlp_specs(d, cfg.dense_d_ff or cfg.d_ff),
            },
            "final_norm": norm_specs(d, cfg.norm),
        }
    return sp


def lm_batch_specs(cfg, shape, dtype=torch.bfloat16):
    """The reference's batch WSpec tree for a ``ShapeConfig``: train
    (tokens, targets, mask), prefill (tokens, lengths) or decode (one
    token a row, lengths); a VLM's text is shorter by its image tokens,
    whose embeddings come first, in the compute ``dtype``."""
    B, S = shape.global_batch, shape.seq_len
    text, extra = S, {}
    if cfg.has_vision_stub:
        text = S - cfg.n_image_tokens
        extra["image_embeds"] = WSpec((B, cfg.n_image_tokens, cfg.d_model),
                                      ("batch", None, None), dtype=dtype)
    return _token_batch(shape, B, text, extra)


def _token_batch(shape, B, S, extra):
    i32 = torch.int32
    if shape.kind == "train":
        return {"tokens": WSpec((B, S), ("batch", "seq"), dtype=i32),
                "targets": WSpec((B, S), ("batch", "seq"), dtype=i32),
                "mask": WSpec((B, S), ("batch", "seq"), dtype=torch.float32),
                **extra}
    if shape.kind == "prefill":
        return {"tokens": WSpec((B, S), ("batch", "seq"), dtype=i32),
                "lengths": WSpec((B,), ("batch",), dtype=i32), **extra}
    return {"tokens": WSpec((B, 1), ("batch", None), dtype=i32),
            "lengths": WSpec((B,), ("batch",), dtype=i32)}


def _embed_scale(cfg) -> float:
    return math.sqrt(cfg.d_model) if cfg.embed_scale_by_dim else 1.0


def _embed_inputs(cfg, params, batch, dtype):
    """Token embedding, behind the image prefix for VLMs (through
    ``img_proj`` where ``cfg.image_proj``, else as it comes), both in
    the compute ``dtype``."""
    h = embed_apply(params["embed"], batch["tokens"], scale=_embed_scale(cfg),
                    dtype=dtype)
    if cfg.has_vision_stub:
        img = batch["image_embeds"].to(dtype)
        if cfg.image_proj:
            img = img @ params["img_proj"]["w"].to(dtype)
        h = torch.cat([img, h], dim=1)
    return h


def _logits(cfg, params, h):
    tied = params["embed"]["table"] if cfg.tie_embeddings else None
    return head_apply(params.get("head"), h, softcap=cfg.final_logit_softcap,
                      tied_table=tied)


def _block(fn, p, cache, ctx, h):
    return fn(p, h, cache, ctx)


def _run_backbone(stages, params, h, ctx, caches):
    """Run every stage's layers in order; layer i reads the i-th slice of
    the stacked weights and (``caches`` given) writes the i-th slice of
    the stage cache.  A stage's unstacked weights (zamba2's shared
    attention block) reach every one of its layers as
    ``ctx["shared_attn"]``.  Each layer runs under ``ctx["remat"]``.
    Returns (h, the layers' router losses summed, float32)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = ctx.get("remat", "none")
    for st in stages:
        p_st = params["stages"][st.name]
        ctx_st = dict(ctx)
        if st.shared_specs is not None:
            ctx_st["shared_attn"] = p_st["shared"]
        cache_st = None if caches is None else caches[st.name]
        for i in range(st.n):
            lp = tree_map(lambda t, i=i: t[i], p_st["blocks"])
            cl = (None if cache_st is None
                  else tree_map(lambda t, i=i: t[i], cache_st))
            h, a = remat_call(remat, partial(_block, st.block_fn, lp, cl,
                                             ctx_st), h)
            aux = aux + a
    return h, aux


def last_rows(h, lengths):
    """(B, 1, d): each row's hidden state at its last valid position,
    ``lengths - 1`` (clamped into the sequence).  Under a mesh on each
    rank's own rows: DTensor's index over a batch sharded on two mesh
    dims (pod and data) is a strategy torch 2.11 does not have."""
    def pick(hl, ln):
        last = (ln.long() - 1).clamp(0, hl.shape[1] - 1)
        return hl[torch.arange(hl.shape[0], device=hl.device), last][:, None]

    if not sharding.is_dtensor(h):
        return pick(h, lengths)
    h = sharding.settle(h)
    rows, _, emb = sharding.spec_of(h)
    return sharding.shard_map(pick, h.device_mesh,
                              ((rows, None, emb), (rows,)),
                              (rows, None, emb))(h, lengths)


def _lse_and_target(logits, targets):
    """(log-partition, target logit) over the last dim.  DTensor logits
    are reduced on each rank's local tensors: over a sharded vocabulary
    all_reduces combine the slices' max (held constant, as the gradient
    does not depend on it), sum of exponentials and target logit, a
    masked sum.  DTensor's own gather is a ``_MaskPartial``, which has
    no backward from a partial sum, and its backward over a whole
    vocabulary scatters into a zero tensor of the *global* logits'
    shape on every rank."""
    if not sharding.is_dtensor(logits):
        return (torch.logsumexp(logits, dim=-1),
                logits.gather(-1, targets.long()[..., None])[..., 0])
    logits = sharding.settle(logits)
    spec = sharding.spec_of(logits)
    mesh, vocab = logits.device_mesh, spec[-1]

    def f(lg, t):
        n = lg.shape[-1]
        m = sharding.all_reduce(lg.detach().amax(-1), mesh, vocab, "max")
        s = sharding.all_reduce((lg - m[..., None]).exp().sum(-1), mesh,
                                vocab)
        rel = t.long() - sharding.axis_index(mesh, vocab) * n
        hit = (rel >= 0) & (rel < n)
        tgt = lg.gather(-1, rel.clamp(0, n - 1)[..., None])[..., 0]
        return m + s.log(), sharding.all_reduce(tgt * hit, mesh, vocab)

    rows = spec[:-1]
    return sharding.shard_map(f, mesh, (spec, rows), [rows, rows])(
        logits, targets)


def cross_entropy(logits, targets, mask, z_loss=0.0):
    """Masked mean token cross entropy in float32, plus ``z_loss`` times
    the masked mean squared log-partition."""
    lse, tgt = _lse_and_target(logits.float(), targets)
    mask = mask.float()
    denom = mask.sum().clamp_min(1.0)
    loss = ((lse - tgt) * mask).sum() / denom
    if z_loss:
        loss = loss + z_loss * ((lse * mask) ** 2).sum() / denom
    return loss


def _mtp_loss(cfg, params, h, batch, positions, attn_impl, dtype):
    """Simplified DeepSeek MTP, as the reference computes it: one extra
    block over [norm(h_t), norm(embed(token_{t+1}))] predicting token
    t + 2, in the compute ``dtype``; the last position has no target."""
    p = params["mtp"]
    emb = embed_apply(params["embed"], batch["tokens"][:, 1:], dtype=dtype)
    hh = apply_norm(p["norm_h"], h[:, :-1], cfg.norm, cfg.norm_eps)
    ee = apply_norm(p["norm_e"], emb, cfg.norm, cfg.norm_eps)
    x = torch.cat([hh, ee], dim=-1) @ p["proj"].to(dtype)
    positions = positions[:, 1:]
    blk = p["block"]
    xn = apply_norm(blk["ln_attn"], x, cfg.norm, cfg.norm_eps)
    if cfg.use_mla:
        y, _ = mla_lib.mla_apply(blk["attn"], xn, positions=positions,
                                 cfg=cfg)
    else:
        y, _ = attn_lib.attention_apply(blk["attn"], xn, positions=positions,
                                        cfg=cfg, impl=attn_impl)
    x = x + y
    x = x + mlp_apply(blk["mlp"], apply_norm(blk["ln_mlp"], x, cfg.norm,
                                             cfg.norm_eps), cfg.act_fn)
    x = apply_norm(p["final_norm"], x, cfg.norm, cfg.norm_eps)
    tgt = batch["targets"][:, 1:]
    n = tgt.shape[1]
    msk = batch["mask"][:, 1:].float() * (
        torch.arange(n, device=tgt.device) < n - 1)
    return cross_entropy(_logits(cfg, params, x), tgt, msk)


def train_options(opts) -> tuple[str, str, float]:
    """(attn_impl, remat, z_loss) from ``build_model``'s options."""
    attn_impl = opts.get("attn_impl", "xla")
    if attn_impl not in ("kernel", "xla"):
        raise ValueError(f"attn_impl {attn_impl!r} is not 'kernel' or 'xla'")
    remat = opts.get("remat", "full")
    if remat not in REMATS:
        raise ValueError(f"remat {remat!r} is not one of {REMATS}")
    return attn_impl, remat, float(opts.get("z_loss", 0.0))


def _constrainer(mesh, rules):
    """The residual stream's ``with_sharding_constraint`` at ("batch",
    "seq", "act_embed"): a redistribute under a mesh, else identity."""
    if mesh is None:
        return lambda h: h
    return lambda h: sharding.constrain(h, ("batch", "seq", "act_embed"),
                                        rules, mesh)


def _make_ctx(mesh, rules, mode, positions, lengths, opts):
    """The per-call context every block reads: the reference's keys
    (``_make_ctx`` there) that the port computes with."""
    attn_impl, remat, _ = train_options(opts)
    return {
        "mode": mode,
        "positions": positions,
        "lengths": lengths,
        "mesh": mesh,
        "rules": rules,
        "remat": remat if mode == "train" else "none",
        "attn_impl": attn_impl,
        "moe_impl": opts.get("moe_impl", "ep" if mesh is not None
                             else "dense"),
        "moe_capacity_factor": opts.get("moe_capacity_factor", 1.25),
        "cache_update": opts.get("cache_update", "scatter"),
        "decode_attn": opts.get("decode_attn", "default"),
        "attn_sp": opts.get("attn_sp", False),
        "softmax_dtype": softmax_dtype(opts),
        "constrain": _constrainer(mesh, rules),
    }


def _dtype_opt(opts, key, default) -> torch.dtype:
    """A dtype option: a torch dtype, or the name "bfloat16" / "float32"."""
    dt = opts.get(key, default)
    if isinstance(dt, str):
        if dt not in ("bfloat16", "float32"):
            raise ValueError(f"{key} {dt!r} is not 'bfloat16' or 'float32'")
        return getattr(torch, dt)
    return dt


def softmax_dtype(opts) -> torch.dtype:
    """The ``softmax_dtype`` option (as the dry run's ``bf16sm`` variant
    passes "bfloat16"): the dtype of the plain-torch attention's masked
    softmax, float32 by default."""
    return _dtype_opt(opts, "softmax_dtype", torch.float32)


def compute_dtype(opts) -> torch.dtype:
    """The ``compute_dtype`` option: the activations' dtype, bfloat16 by
    default as in the reference (whose ``build_model`` reads
    ``opts.get("compute_dtype", jnp.bfloat16)``)."""
    return _dtype_opt(opts, "compute_dtype", torch.bfloat16)


def build_model(cfg: ArchConfig, mesh=None, rules=None, **opts) -> ModelBundle:
    rules = sharding.merge_rules(rules if isinstance(rules, dict) else None)
    if cfg.is_encoder_decoder:
        # encoder-decoder families have no paged layout: the paged
        # fields stay None, as in the JAX package
        from repro_torch.models.encdec import build_encdec

        return build_encdec(cfg, mesh=mesh, rules=rules, **opts)
    stages = make_stages(cfg)
    specs = _lm_specs(cfg, stages)
    attn_impl, _, z_loss = train_options(opts)
    dt = compute_dtype(opts)
    scope = partial(sharding.mesh_scope, mesh)

    def loss_fn(params, batch):
        with scope():
            h = _embed_inputs(cfg, params, batch, dt)
            n_prefix = h.shape[1] - batch["tokens"].shape[1]
            B, S = h.shape[:2]
            positions = torch.arange(S, dtype=torch.int32,
                                     device=h.device).expand(B, S)
            ctx = _make_ctx(mesh, rules, "train", positions, None, opts)
            h, aux = _run_backbone(stages, params, ctx["constrain"](h), ctx,
                                   None)
            h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
            h = h[:, n_prefix:]
            loss = cross_entropy(_logits(cfg, params, h), batch["targets"],
                                 batch["mask"], z_loss)
            metrics = {"ce": loss, "aux": aux}
            if cfg.router_aux_loss and cfg.n_experts:
                loss = loss + cfg.router_aux_loss * aux
            if cfg.mtp_depth:
                mtp = _mtp_loss(cfg, params, h, batch, positions, attn_impl,
                                dt)
                metrics["mtp"] = mtp
                loss = loss + 0.3 * mtp
            metrics["loss"] = loss
            return loss, metrics

    def prefill(params, batch, cache):
        with scope():
            h = _embed_inputs(cfg, params, batch, dt)
            B, S = h.shape[:2]
            positions = torch.arange(S, dtype=torch.int32,
                                     device=h.device).expand(B, S)
            lengths = batch.get("lengths")
            if lengths is None:
                lengths = torch.full((B,), S, dtype=torch.int32,
                                     device=h.device)
            ctx = _make_ctx(mesh, rules, "prefill", positions, lengths, opts)
            if mesh is None and cfg.n_experts:
                ctx["valid"] = positions < lengths[:, None]
            h, _ = _run_backbone(stages, params, ctx["constrain"](h), ctx,
                                 cache)
            h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
            return _logits(cfg, params, last_rows(h, lengths))[:, 0], cache

    def _decode(params, tokens, cache, lengths, **extra):
        with scope():
            h = embed_apply(params["embed"], tokens, scale=_embed_scale(cfg),
                            dtype=dt)
            ctx = _make_ctx(mesh, rules, "decode",
                            lengths[:, None].to(torch.int32), lengths, opts)
            if mesh is None and cfg.n_experts:
                ctx["valid"] = (lengths > 0)[:, None]
            ctx.update(extra)
            h, _ = _run_backbone(stages, params, ctx["constrain"](h), ctx,
                                 cache)
            h = apply_norm(params["final_norm"], h, cfg.norm, cfg.norm_eps)
            return _logits(cfg, params, h)[:, 0], cache

    def decode_step(params, tokens, cache, lengths):
        return _decode(params, tokens, cache, lengths)

    # Every attention cache leaf is (B, T, ...): {"k","v"} with (B, T,
    # K, D) leaves (a list of two per gemma2 pair), MLA's latent
    # {"ckv","kr"} with (B, T, kv_lora_rank) and (B, T, qk_rope_dim).
    # Re-reading (B, T) as (n_pages, page_size) gives the global page
    # pools the paged decode kernels and the block-table scatter consume.
    # The JAX package pages dense/vlm only; the port's moe family has the
    # same caches (MLA's latent pools decode through their own kernel),
    # so it pages too.  The recurrent (hybrid/ssm) caches do not fit the
    # page layout; those bundles keep the paged fields None and serve
    # solo, as in the reference.
    paged_supported = cfg.family in ("dense", "vlm", "moe")

    def paged_decode_step(params, tokens, cache, block_tables, lengths):
        return _decode(params, tokens, cache, lengths, cache_layout="paged",
                       block_tables=block_tables)

    def cache_specs(B, T, dtype=torch.bfloat16):
        out = {}
        for st in stages:
            per_layer = st.cache_specs(cfg, B, T, dtype)
            out[st.name] = tree_map(
                lambda ws, n=st.n: replace(ws, shape=(n, *ws.shape),
                                           axes=("layers", *ws.axes)),
                per_layer)
        return out

    def paged_cache_specs(n_pages, page_size, dtype=torch.bfloat16):
        return cache_specs(n_pages, page_size, dtype)

    return ModelBundle(
        cfg=cfg, specs=specs, loss_fn=loss_fn, prefill=prefill,
        decode_step=decode_step, cache_specs=cache_specs,
        paged_decode_step=paged_decode_step if paged_supported else None,
        paged_cache_specs=paged_cache_specs if paged_supported else None,
        mesh=mesh, rules=rules, compute_dtype=dt,
        batch_specs=partial(lm_batch_specs, cfg, dtype=dt))
