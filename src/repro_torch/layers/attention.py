"""GQA self-attention, KV-cache insertion and paged-cache gathers.

API:
  project_qkv(params, x, positions, cfg)   -> q, k, v (rope applied)
  gqa_scores(q, k, v, ...)                 -> attention output (pre-wo),
                                              plain tensor ops
  attention_apply(params, x, ...)          -> full self-attention
                                              (train, prefill), or
                                              cross-attention over an
                                              encoder's k/v, through
                                              the flash attention kernel
                                              or (impl="xla")
                                              gqa_scores
  cross_kv_project(params, enc_out, cfg)   -> cross-attention k, v
  cross_attention_decode(params, x, k, v, cfg)
                                           -> one query per row over
                                              cached cross k/v, through
                                              the decode kernel
  decode_attend(q, k_cache, v_cache, lengths, ...)
                                           -> one query per row over a
                                              dense cache, through the
                                              decode kernel
  paged_attend(q, k_pages, v_pages, tables, lengths, ...)
                                           -> one query per row over a
                                              whole page pool, through
                                              the paged decode kernel
  decode_attention_shardmap(q, k_cache, v_cache, lengths, mesh=, rules=)
                                           -> the same over a
                                              sequence-sharded cache,
                                              partial softmax per rank
  paged_decode_attention_shardmap(q, k_pages, v_pages, tables, lengths,
                                  mesh=)   -> one query per row over a
                                              page pool sharded by pages
                                              and by slots, the paged
                                              kernel on each rank's tile
                                              and a softmax combine
  cache_insert(cache, new, lengths, mode=, mesh=, rules=)
  paged_cache_insert(pages, new, tables, lengths)
                                           -> one token a row into a
                                              page pool (a rank's tile
                                              of a sharded one)
  cache_write_prefix(cache, new)           -> prefill's cache[:, :S] = new

Weights keep the JAX package's layouts: ``wq`` (d, H, hd), ``wk``/``wv``
(d, K, hd), ``wo`` (H, hd, d), each cast to its input's dtype at use.
Cache updates write in place.  The decode paths run at the wider of
q's and the cache's dtypes and return q's (``decode_attend``).

Under a mesh (``mesh``/``rules`` given, tensors ``DTensor``s placed by
the logical-axis rules, see ``common.sharding``) the projections run as
DTensor ops, and every attention core runs on each rank's local tensors
through ``sharding.shard_map``: q with its heads over the axes the
rules give "heads", k and v with theirs over "kv_heads".  The per-rank
GQA grouping holds only when both resolve to the same axes; otherwise
both are replicated for the call.  Cache writes land in place in each
rank's local tile.
"""

from __future__ import annotations

import functools
import math

import torch

from repro_torch.common import sharding
from repro_torch.kernels import ops as kops
from repro_torch.layers.initializers import WSpec
from repro_torch.layers.rope import apply_rope

NEG_INF = -2.0e38


def attention_specs(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int):
    return {
        "wq": WSpec((d_model, n_heads, head_dim), ("embed", "heads", None)),
        "wk": WSpec((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", None)),
        "wv": WSpec((d_model, n_kv_heads, head_dim), ("embed", "kv_heads", None)),
        "wo": WSpec((n_heads, head_dim, d_model), ("heads", None, "embed")),
    }


def _proj(x, w):
    """x (B,S,d) @ w (d, n, hd) -> (B,S,n,hd).  Under a mesh it runs
    per rank (``_proj_sharded``)."""
    if sharding.is_dtensor(w):
        return _proj_sharded(x, w)
    d, n, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, n * hd)).reshape(
        *x.shape[:-1], n, hd)


def _proj_sharded(x, w):
    """``_proj`` on each rank's local tensors, as GSPMD lays it out: x
    keeps its batch and sequence sharding with the embed dim whole, the
    weight is gathered over its embed (FSDP) axes and keeps its heads
    sharding, so the output's heads are the weight's.  DTensor's own
    matmul may instead shard a replicated weight's columns over any
    mesh dim (a free local slice), and the view to (n, hd) then fails
    where that dim's size does not divide n (four kv heads over a model
    axis of 16), forward or backward."""
    x, lead = sharding.lead_spec(x)
    heads = sharding.unless_used(sharding.spec_of(w)[1], lead)
    d, _, hd = w.shape

    def f(xl, wl):
        n = wl.shape[1]
        return (xl @ wl.to(xl.dtype).reshape(d, n * hd)).reshape(
            *xl.shape[:-1], n, hd)

    return sharding.shard_map(f, w.device_mesh,
                              ((*lead, None), (None, heads, None)),
                              (*lead, heads, None))(x, w)


def project_qkv(params, x, positions, cfg):
    """Project and (optionally) rope q/k.  x: (B,S,D) -> q (B,S,H,hd),
    k/v (B,S,K,hd)."""
    q = _proj(x, params["wq"])
    k = _proj(x, params["wk"])
    v = _proj(x, params["wv"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def output_proj(params, out, dtype):
    """out (B,S,H,hd) @ wo (H,hd,d) -> (B,S,d).  Under a mesh it runs
    per rank (``_output_proj_sharded``)."""
    if sharding.is_dtensor(params["wo"]):
        return _output_proj_sharded(out, params["wo"], dtype)
    H, hd, d = params["wo"].shape
    return out.reshape(*out.shape[:-2], H * hd).to(dtype) @ \
        params["wo"].to(dtype).reshape(H * hd, d)


def _output_proj_sharded(out, wo, dtype):
    """``output_proj`` on each rank's local tensors, as GSPMD lays it
    out: ``out`` keeps its batch and sequence sharding, both it and
    ``wo`` keep their heads sharding with ``wo`` gathered over its embed
    (FSDP) axes, and an all_reduce over the heads axes sums the partial
    products.  DTensor's own product computes the forward so, but its
    backward gathered both operands' heads whole and ran the gradient
    products at their global size on every rank of the model axis."""
    out = sharding.settle(out)
    lead = sharding.spec_of(out)[:-2] if sharding.is_dtensor(out) \
        else (None,) * (out.ndim - 2)
    heads = sharding.unless_used(sharding.spec_of(wo)[0], lead)
    mesh = wo.device_mesh

    def f(ol, wl):
        h, hd, d = wl.shape
        y = ol.reshape(*ol.shape[:-2], h * hd).to(dtype) @ \
            wl.to(dtype).reshape(h * hd, d)
        return sharding.all_reduce(y, mesh, heads)

    return sharding.shard_map(f, mesh, ((*lead, heads, None),
                                        (heads, None, None)),
                              (*lead, None))(out, wo)


def gqa_scores(q, k, v, *, q_positions, kv_positions, causal: bool = True,
               window: int = 0, softcap: float = 0.0, kv_valid=None,
               scale: float | None = None, softmax_dtype=torch.float32):
    """Grouped-query attention core with plain tensor ops.

    q: (B, S, H, D); k, v: (B, T, K, D) with H = K * G; positions
    (B, S) / (B, T); ``kv_valid`` (B, T) bool masks cache slots.
    The masked softmax runs in ``softmax_dtype`` (float32 by default;
    the reference's ``bf16sm`` dry-run variant asks for bfloat16, masked
    at that dtype's most negative value).
    """
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k).to(softmax_dtype) * scale
    if softcap and softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    qp = q_positions[:, :, None]                      # (B, S, 1)
    kp = kv_positions[:, None, :]                     # (B, 1, T)
    mask = torch.ones((B, S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window and window > 0:
        mask &= kp > qp - window
    if kv_valid is not None:
        mask &= kv_valid[:, None, :]
    neg = NEG_INF if softmax_dtype == torch.float32 else \
        torch.finfo(softmax_dtype).min
    logits = torch.where(mask[:, None], logits, torch.full_like(logits, neg))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def _head_specs(q_shape, kv_shape, rules, mesh, batch="batch"):
    """The specs the attention core runs at: q (B, S, H, D) heads over
    "heads", k/v (B, T, K, D) over "kv_heads".  Where the kv heads do not
    shard as the q heads do (four kv heads over a model axis of 16), k/v
    keep their heads whole and each rank slices the groups its q heads
    read, as the reference's k/v repeated to H heads shard with q's
    (``_kv_slicer``); where no slice fits, or the batch rows differ,
    both are replicated."""
    q_spec = sharding.spec_for(q_shape, (batch, None, "heads", None),
                               rules, mesh)
    kv_spec = sharding.spec_for(kv_shape, (batch, None, "kv_heads", None),
                                rules, mesh)
    if q_spec[0] != kv_spec[0]:
        whole = (q_spec[0], None, None, None)
        return whole, whole
    if q_spec[2] != kv_spec[2]:
        H, K = q_shape[2], kv_shape[2]
        n = sharding.axis_size(mesh, q_spec[2]) if q_spec[2] else 1
        h_loc, G = H // n, H // K
        kv_spec = (q_spec[0], None, None, None)
        if not q_spec[2] or (h_loc % G and G % h_loc):
            q_spec = kv_spec
    return q_spec, kv_spec


def _kv_slicer(fn, q_spec, kv_spec, H, K, mesh):
    """``fn`` with k/v cut to the kv heads of this rank's q heads, when q
    shards its heads and k/v do not: H_loc q heads from h0 read kv heads
    h0 // G on, H_loc // G of them (one when H_loc divides G)."""
    if q_spec[2] is None or kv_spec[2] is not None:
        return fn
    G = H // K

    def sliced(q_, k_, v_):
        h_loc = q_.shape[2]
        g0 = sharding.axis_index(mesh, q_spec[2]) * h_loc // G
        sl = slice(g0, g0 + max(1, h_loc // G))
        return fn(q_, k_[:, :, sl], v_[:, :, sl])

    return sliced


def attention_core(fn, q, k, v, *, mesh=None, rules=None):
    """``fn(q, k, v)`` on plain tensors; under a mesh on each rank's
    local heads (``_head_specs``) and batch rows, the output placed as
    q."""
    if mesh is None:
        return fn(q, k, v)
    q_spec, kv_spec = _head_specs(q.shape, k.shape, rules, mesh)
    fn = _kv_slicer(fn, q_spec, kv_spec, q.shape[2], k.shape[2], mesh)
    return sharding.shard_map(fn, mesh, (q_spec, kv_spec, kv_spec),
                              q_spec)(q, k, v)


def attention_apply(params, x, *, positions, cfg, local: bool = False,
                    causal: bool = True, cross_kv=None, cross_positions=None,
                    impl: str = "kernel", mesh=None, rules=None,
                    constrain_kv=None, softmax_dtype=torch.float32):
    """Self- (or cross-) attention over one segment (train or prefill).
    ``impl="kernel"`` runs the flash attention kernel, which assumes
    ``positions`` is the trivial arange; ``impl="xla"`` runs
    ``gqa_scores``, plain tensor ops that differentiate (the reference's
    XLA path).  A ``local`` layer sees only the ``cfg.sliding_window``
    keys up to each query.  With ``cross_kv`` = (k, v) from an encoder
    (B, T, K, D), the S queries attend to all T keys, non-causally, at
    ``cross_positions`` (the encoder's arange).  Under ``mesh`` the core
    runs per rank (``attention_core``); ``constrain_kv`` is applied to
    the fresh k and v first (the reference's sequence-parallel pin).
    Returns (out, (k, v)) — the freshly projected k/v for cache
    insertion, or the cross k/v.  ``softmax_dtype`` is ``gqa_scores``'s
    (the kernel's softmax is float32)."""
    if impl not in ("kernel", "xla"):
        raise ValueError(f"attention_apply: unknown impl {impl!r}")
    if cross_kv is not None:
        q = _proj(x, params["wq"])
        if cfg.use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
        k, v = cross_kv
        causal, window, kv_positions = False, 0, cross_positions
    else:
        q, k, v = project_qkv(params, x, positions, cfg)
        if constrain_kv is not None:
            k, v = constrain_kv(k), constrain_kv(v)
        window = cfg.sliding_window if local else 0
        kv_positions = positions

    def fn(q_, k_, v_):
        if impl == "kernel":
            return kops.flash_attention(
                q_.contiguous(), k_.contiguous(), v_.contiguous(),
                causal=causal, window=window, softcap=cfg.attn_logit_softcap)
        # the mask reads positions only through differences, so a rank's
        # local rows take the arange
        qp, kp = positions, kv_positions
        if mesh is not None:
            B = q_.shape[0]
            qp, kp = _arange(q_.shape[1], B, q_.device), \
                _arange(k_.shape[1], B, q_.device)
        return gqa_scores(q_, k_, v_, q_positions=qp, kv_positions=kp,
                          causal=causal, window=window,
                          softcap=cfg.attn_logit_softcap,
                          softmax_dtype=softmax_dtype)

    out = attention_core(fn, q, k, v, mesh=mesh, rules=rules)
    return output_proj(params, out, x.dtype), (k, v)


def _arange(n, B, device):
    return torch.arange(n, dtype=torch.int32, device=device).expand(B, n)


def cross_kv_project(params, enc_out, cfg):
    """Project encoder output into cross-attention K/V once (cached)."""
    return _proj(enc_out, params["wk"]), _proj(enc_out, params["wv"])


def wider_dtype(*tensors) -> torch.dtype:
    """The widest dtype of ``tensors`` (float32 over bfloat16): the one a
    decode launch over q and a cache of another dtype runs at."""
    return functools.reduce(torch.promote_types, (t.dtype for t in tensors))


def decode_attend(q, k_cache, v_cache, lengths, *, window=0, softcap=0.0,
                  mesh=None, rules=None):
    """q (B, 1, H, D) against a dense cache (B, T, K, D) up to
    ``lengths`` (B,) valid keys, through the decode kernel.  Under a mesh
    the kernel runs per rank on its cache rows and its heads
    (``_head_specs``) with the whole sequence (the cache gathered over
    the rest, as GSPMD gathers the reference's seq-sharded cache on this
    path).

    The launch runs at the wider of q's and the cache's dtypes and
    returns q's: a bfloat16 q (bfloat16 compute) against a float32 cache
    (the serving engine's) is widened, the float32 instance runs and its
    output is narrowed back, which is the reference's arithmetic (its
    decode kernels read every operand as float32 and write q's dtype);
    the cache, the larger operand, is never narrowed or copied.  A cache
    narrower than q (a bfloat16 cache under float32 compute) is widened
    to q's dtype, as the reference widens it to the activations'.  With
    the bundle's own bfloat16 cache under its default compute both are
    bfloat16 and the bfloat16 instance runs."""
    def fn(q_, k_, v_, len_):
        dt = wider_dtype(q_, k_)
        return kops.decode_attention(
            q_[:, 0].to(dt).contiguous(), k_.to(dt).contiguous(),
            v_.to(dt).contiguous(), len_.to(torch.int32),
            window=window, softcap=softcap)[:, None].to(q_.dtype)

    if mesh is None:
        return fn(q, k_cache, v_cache, lengths)
    spec_q, spec_c = _head_specs(q.shape, k_cache.shape, rules, mesh,
                                 batch="cache_batch")
    spec_l = sharding.spec_for(lengths.shape, ("cache_batch",), rules, mesh)
    sliced = _kv_slicer(lambda q_, k_, v_: (q_, k_, v_), spec_q, spec_c,
                        q.shape[2], k_cache.shape[2], mesh)
    return sharding.shard_map(lambda q_, k_, v_, len_: fn(
        *sliced(q_, k_, v_), len_), mesh, (spec_q, spec_c, spec_c, spec_l),
        spec_q)(q, k_cache, v_cache, lengths)


def cross_attention_decode(params, x, k, v, cfg, positions=None, *,
                           mesh=None, rules=None):
    """One decode step's cross-attention: x (B, 1, d) queries every one
    of the T cached encoder keys k/v (B, T, K, D), through the decode
    kernel with lengths = T."""
    q = _proj(x, params["wq"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    B, T = k.shape[:2]
    lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
    out = decode_attend(q, k, v, lengths, softcap=cfg.attn_logit_softcap,
                        mesh=mesh, rules=rules)
    return output_proj(params, out, x.dtype)


def decode_attention_shardmap(q, k_cache, v_cache, lengths, *, mesh, rules,
                              window: int = 0, softcap: float = 0.0):
    """Distributed partial-softmax decode attention, per rank.

    q: (B, 1, H, D) batch-sharded; cache: (B, T, K, D) batch-sharded over
    the data axes and seq-sharded over 'model'.  Each rank computes
    logits/softmax partials over its local seq tile; an all_reduce MAX
    and two SUMs (of s and o) combine them — the cache never moves.
    Plain tensor ops, as the reference's are plain ``jnp``, at the wider
    of q's and the cache's dtypes (``decode_attend``'s rule); the output
    is in q's dtype.
    """
    B, _, H, D = q.shape
    K = k_cache.shape[2]
    G = H // K
    scale = 1.0 / math.sqrt(D)
    # q follows the CACHE's batch sharding
    spec_q = sharding.spec_for(q.shape, ("cache_batch", None, None, None),
                               rules, mesh)
    spec_c = sharding.spec_for(k_cache.shape,
                               ("cache_batch", "cache_seq", None, None),
                               rules, mesh)
    spec_l = sharding.spec_for(lengths.shape, ("cache_batch",), rules, mesh)
    seq_axes = spec_c[1]

    def f(q_l, k_l, v_l, len_l):
        out_dtype = q_l.dtype
        q_l = q_l.to(wider_dtype(q_l, k_l))
        T_loc = k_l.shape[1]
        t_off = sharding.axis_index(mesh, seq_axes) * T_loc
        kv_pos = t_off + torch.arange(T_loc, dtype=torch.int32,
                                      device=q_l.device)          # (T_loc,)
        if G > 1:
            k_rep = k_l.repeat_interleave(G, dim=2)
            v_rep = v_l.repeat_interleave(G, dim=2)
        else:
            k_rep, v_rep = k_l, v_l
        logits = torch.einsum("bshd,bthd->bhst", q_l,
                              k_rep.to(q_l.dtype)).float() * scale
        if softcap and softcap > 0.0:
            logits = softcap * torch.tanh(logits / softcap)
        len_l = len_l.to(torch.int32)
        pos = len_l[:, None]                                       # (B,1)
        valid = kv_pos[None, :] < (len_l + 1)[:, None]             # (B,T_loc)
        if window and window > 0:
            valid &= kv_pos[None, :] > pos - window
        vmask = valid[:, None, None, :]
        logits = torch.where(vmask, logits, torch.full_like(logits, NEG_INF))
        m = sharding.all_reduce(logits.amax(dim=-1), mesh, seq_axes,
                                "max")                             # (B,H,1)
        safe_m = torch.where(m > NEG_INF / 2, m, torch.zeros_like(m))
        p = torch.exp(logits - safe_m[..., None])
        p = torch.where(vmask, p, torch.zeros_like(p))
        s = sharding.all_reduce(p.sum(dim=-1), mesh, seq_axes)     # (B,H,1)
        o = torch.einsum("bhst,bthd->bshd", p.to(q_l.dtype),
                         v_rep.to(q_l.dtype))
        o = sharding.all_reduce(o.float(), mesh, seq_axes)
        out = o / s.clamp_min(1e-30).transpose(1, 2)[..., None]
        return out.to(out_dtype)

    return sharding.shard_map(f, mesh, (spec_q, spec_c, spec_c, spec_l),
                              spec_q)(q, k_cache, v_cache, lengths)


def _tile(cache):
    """(this rank's local tile of a DTensor ``cache`` (B, T, ...), the
    sequence offset of its first position): the row-major index over
    the mesh dims that shard dim 1, times the tile's length."""
    loc = cache.to_local()
    mesh = cache.device_mesh
    idx = 0
    for i, pl in enumerate(cache.placements):
        if pl.is_shard(1):
            idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return loc, idx * loc.shape[1]


def _like_cache(x, cache):
    """``x`` (B, S, ...) or (B,) as this rank's local tensor laid out as
    ``cache``'s tile along every dim but the sequence (dim 1), which
    stays whole (``sharding.local_as``: over gloo on a card, k and v
    sharded by heads are gathered for a cache that holds the heads whole
    by the c10d all-gather)."""
    from torch.distributed.tensor import Replicate

    pl = [p if p.is_shard() and p.dim != 1 and p.dim < x.ndim
          else Replicate() for p in cache.placements]
    return sharding.local_as(x, cache.device_mesh, pl)


def cache_write_prefix(cache, new):
    """Prefill's ``cache[:, :S] = new`` in place (new: (B, S, ...)); on a
    sequence-sharded cache each rank writes the part of [0, S) that
    falls in its tile, with no collective."""
    if not sharding.is_dtensor(cache):
        cache[:, :new.shape[1]] = new.to(cache.dtype)
        return cache
    new_l = _like_cache(new, cache)
    c, t_off = _tile(cache)
    hi = min(t_off + c.shape[1], new_l.shape[1])
    if hi > t_off:
        c[:, :hi - t_off] = new_l[:, t_off:hi].to(c.dtype)
    return cache


def cache_insert(cache_arr, new_val, lengths, *, mode: str = "scatter",
                 mesh=None, rules=None):
    """Write new_val (B, 1, ...) into cache (B, T, ...) at per-row
    position ``lengths``, in place.  Returns the cache.

    mode="scatter": an indexed write at (row, lengths).
    mode="blend": a one-hot masked rewrite of the whole cache.
    mode="shard" (with a mesh): the reference's ``shard_map`` update —
    each rank writes into its local (batch, seq) tile only the rows whose
    position falls inside it, with no collective.
    A DTensor cache is written that way, in its local tile, whatever
    the mode (blend still rewrites the tile).
    """
    if mode not in ("scatter", "blend", "shard"):
        raise ValueError(f"cache_insert: unknown mode {mode!r}")
    if mode == "shard" and mesh is not None:
        return _cache_insert_shardmap(cache_arr, new_val, lengths, mesh,
                                      rules)
    if sharding.is_dtensor(cache_arr):
        return _insert_tile(cache_arr, new_val, lengths, blend=mode == "blend")
    B, T = cache_arr.shape[:2]
    if mode == "blend":
        onehot = (torch.arange(T, device=cache_arr.device)[None, :]
                  == lengths[:, None])                        # (B, T)
        oh = onehot.reshape(B, T, *([1] * (cache_arr.ndim - 2)))
        cache_arr.copy_(torch.where(oh, new_val[:, :1].to(cache_arr.dtype),
                                    cache_arr))
        return cache_arr
    rows = torch.arange(B, device=cache_arr.device)
    cache_arr[rows, lengths.long()] = new_val[:, 0].to(cache_arr.dtype)
    return cache_arr


def _cache_insert_shardmap(cache_arr, new_val, lengths, mesh, rules):
    """A plain cache is placed at the reference's shard_map spec (batch
    over "cache_batch", sequence over "cache_seq") first; a DTensor one
    keeps its own placements, so the write stays in place."""
    if not sharding.is_dtensor(cache_arr):
        axes = ("cache_batch", "cache_seq") + (None,) * (cache_arr.ndim - 2)
        cache_arr = sharding.constrain(cache_arr, axes, rules, mesh)
    return _insert_tile(cache_arr, new_val, lengths, blend=False)


def _insert_tile(cache, new_val, lengths, *, blend: bool):
    """Each rank updates its tile of the DTensor ``cache`` in place: a
    row whose position falls outside the tile keeps its old value (the
    reference's clipped update), or with ``blend`` the tile is rewritten
    through a one-hot mask."""
    c, t_off = _tile(cache)
    nv = _like_cache(new_val, cache)[:, 0].to(c.dtype)
    pos = _like_cache(lengths, cache).long() - t_off       # (B_loc,)
    B_loc, T_loc = c.shape[:2]
    tail = [1] * (c.ndim - 2)
    if blend:
        oh = torch.arange(T_loc, device=c.device)[None, :] == pos[:, None]
        c.copy_(torch.where(oh.reshape(B_loc, T_loc, *tail), nv[:, None], c))
        return cache
    inb = (pos >= 0) & (pos < T_loc)
    posc = pos.clamp(0, T_loc - 1)
    rows = torch.arange(B_loc, device=c.device)
    c[rows, posc] = torch.where(inb.reshape(B_loc, *tail), nv, c[rows, posc])
    return cache


def pool_tile(pages):
    """A page pool (n_pages, page_size, ...) as this rank holds it: (its
    local tile (P, ps, ...), the tile (p0, n_pages, s0, page_size) the
    paged kernel's tile mode takes, the mesh axes its pages are sharded
    over, those of its slots).  The reference's pool lays the pages out
    over "cache_batch" and each page's slots over "cache_seq"
    (``models.lm._kv_cache_specs``); a plain pool is one whole tile.  A
    pool whose kv heads or head dim are sharded is not that layout and
    raises."""
    if not sharding.is_dtensor(pages):
        return pages, (0, pages.shape[0], 0, pages.shape[1]), None, None
    spec = sharding.spec_of(pages)
    if any(e is not None for e in spec[2:]):
        raise ValueError(f"a page pool sharded as {spec}: the paged decode "
                         "takes its pages and slots sharded, its heads whole")
    loc, mesh = pages.to_local(), pages.device_mesh
    P, ps = loc.shape[:2]
    return loc, (sharding.axis_index(mesh, spec[0]) * P, pages.shape[0],
                 sharding.axis_index(mesh, spec[1]) * ps,
                 pages.shape[1]), spec[0], spec[1]


def _whole(x, mesh):
    """This rank's copy of the whole of ``x`` (every row, every head):
    ``sharding.local_as``, which gathers through c10d where two gloo ranks
    share a card."""
    from torch.distributed.tensor import Replicate

    return sharding.local_as(x, mesh, [Replicate()] * mesh.ndim)


def _paged_write_index(block_tables, lengths, tile, P_loc, ps_loc):
    """Where a decode step writes its one token a row in a rank's tile of
    the pool: (the rows the tile holds, their local pages, their local
    slots).  Row b writes position ``lengths[b]``: page ``tables[b,
    lengths[b] // page_size]`` (the column clamped into the table; dead
    rows point at the dummy page 0), slot ``lengths[b] % page_size``; a
    row is the tile's where both fall in its ranges (a page id outside
    the pool falls in no tile: its write is dropped, as the reference's
    scatter drops it)."""
    p0, _, s0, ps = tile
    n_max = block_tables.shape[1]
    lengths = lengths.long()
    rows = torch.arange(lengths.shape[0], device=block_tables.device)
    page = block_tables.long()[rows, (lengths // ps).clamp(0, n_max - 1)] - p0
    slot = lengths % ps - s0
    held = (page >= 0) & (page < P_loc) & (slot >= 0) & (slot < ps_loc)
    rows = held.nonzero()[:, 0]
    return rows, page[rows], slot[rows]


def paged_cache_insert(pages, new_val, block_tables, lengths):
    """Write new_val (B, 1, ...) into a paged cache (n_pages, page_size,
    ...) at per-row position ``lengths``, resolving the owning page
    through ``block_tables`` (B, n_max); in place.  Returns the pages.

    Live sequences never share pages, so the batched scatter indices
    are unique across rows; rows whose table points at a dummy page
    (dead decode rows) collide only with each other, on a page no
    sequence reads.

    A DTensor pool (``pool_tile``'s layout) is written in each rank's
    tile: ``new_val`` (rows over the data axes, kv heads over "model",
    as ``project_qkv`` gives it) is gathered whole, and the rank writes
    the rows whose page and slot it holds (``_paged_write_index``; dead
    rows on page 0 land on whichever rank holds their slot of it).
    """
    if sharding.is_dtensor(pages):
        loc, tile, _, _ = pool_tile(pages)
        rows, page, slot = _paged_write_index(block_tables, lengths, tile,
                                              *loc.shape[:2])
        nv = _whole(new_val, pages.device_mesh)
        loc[page, slot] = nv[rows, 0].to(loc.dtype)
        return pages
    ps = pages.shape[1]
    B = new_val.shape[0]
    n_max = block_tables.shape[1]
    lengths = lengths.long()
    rows = torch.arange(B, device=pages.device)
    page = block_tables.long()[rows, (lengths // ps).clamp(0, n_max - 1)]
    pages[page, lengths % ps] = new_val[:, 0].to(pages.dtype)
    return pages


def paged_decode_attention_shardmap(q, k_pages, v_pages, block_tables,
                                    lengths, *, mesh, window: int = 0,
                                    softcap: float = 0.0):
    """Paged decode attention over a pool sharded as the reference lays
    it out (pages over "cache_batch", each page's slots over
    "cache_seq", kv heads whole: ``pool_tile``), without moving the pool.

    q (B, 1, H, D) is gathered to every row and head (the pool holds
    every row's keys on any data rank and every kv head); each rank runs
    the paged kernel once over its own tile, in its tile mode, giving
    its normalised o and log-sum-exp over the live keys it holds (key t
    of a row up to ``lengths``, within ``window``); an all_reduce MAX of
    the log-sum-exps and two SUMs over the pool's sharded mesh axes
    combine them, as ``decode_attention_shardmap`` combines its partial
    softmaxes (a row with no live key gives 0).  Returned at q's
    placement and dtype; the kernel runs at the wider of q's and the
    pool's dtypes (``decode_attend``'s rule).  ``lengths`` and
    ``block_tables`` are the step's plain tensors; the function is the
    unsharded paged step's."""
    from torch.distributed.tensor import DTensor, Replicate

    q = sharding.settle(q)
    q_l = _whole(q, mesh)[:, 0]
    out_dtype = q_l.dtype
    k_l, tile, page_axes, slot_axes = pool_tile(k_pages)
    v_l = pool_tile(v_pages)[0]
    dt = wider_dtype(q_l, k_l)
    q_l, k_l, v_l = (t.to(dt).contiguous() for t in (q_l, k_l, v_l))
    axes = tuple(a for e in (page_axes, slot_axes) if e is not None
                 for a in ((e,) if isinstance(e, str) else e))
    o, lse = kops.paged_decode_attention(
        q_l, k_l, v_l, block_tables, lengths.to(torch.int32), window=window,
        softcap=softcap, tile=tile)
    m = sharding.all_reduce(lse, mesh, axes, "max")
    safe_m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lse - safe_m)                       # 0 where lse = -inf
    num = sharding.all_reduce(w[..., None] * o.float(), mesh, axes)
    den = sharding.all_reduce(w, mesh, axes)
    out = (num / den.clamp_min(1e-30)[..., None]).to(out_dtype)[:, None]
    out = DTensor.from_local(out, mesh, [Replicate()] * mesh.ndim,
                             run_check=False)
    if sharding.is_dtensor(q):
        out = sharding.to_placements(out, mesh, q.placements)
    return out


def paged_attend(q, k_pages, v_pages, block_tables, lengths, *, window=0,
                 softcap=0.0):
    """q (B, 1, H, D) against a whole page pool (n_pages, page_size, K,
    D) through the block tables, up to ``lengths`` (B,) valid keys: one
    paged kernel launch at the wider of q's and the pool's dtypes
    (``decode_attend``'s rule: a bfloat16 q is widened against the
    engine's float32 pool, which is never narrowed or copied; the
    bundle's bfloat16 pool under bfloat16 compute runs the bfloat16
    instance).  Returns (B, 1, H, D) in q's dtype."""
    dt = wider_dtype(q, k_pages)
    return kops.paged_decode_attention(
        q[:, 0].to(dt).contiguous(), k_pages.to(dt), v_pages.to(dt),
        block_tables, lengths.to(torch.int32), window=window,
        softcap=softcap)[:, None].to(q.dtype)


def paged_gather(pages, block_tables):
    """Materialize each sequence's pages contiguously: (n_pages, ps,
    ...) + tables (B, n_max) -> (B, n_max*ps, ...)."""
    B, n_max = block_tables.shape
    ps = pages.shape[1]
    return pages[block_tables.long()].reshape(B, n_max * ps, *pages.shape[2:])
