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

Weights keep the JAX package's layouts: ``wq`` (d, H, hd), ``wk``/``wv``
(d, K, hd), ``wo`` (H, hd, d).  Cache updates write in place.
"""

from __future__ import annotations

import math

import torch

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
    """x (B,S,d) @ w (d, n, hd) -> (B,S,n,hd)."""
    d, n, hd = w.shape
    return (x @ w.to(x.dtype).reshape(d, n * hd)).reshape(
        *x.shape[:-1], n, hd)


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
    """out (B,S,H,hd) @ wo (H,hd,d) -> (B,S,d)."""
    H, hd, d = params["wo"].shape
    return out.reshape(*out.shape[:-2], H * hd).to(dtype) @ \
        params["wo"].to(dtype).reshape(H * hd, d)


def gqa_scores(q, k, v, *, q_positions, kv_positions, causal: bool = True,
               window: int = 0, softcap: float = 0.0, kv_valid=None,
               scale: float | None = None):
    """Grouped-query attention core with plain tensor ops.

    q: (B, S, H, D); k, v: (B, T, K, D) with H = K * G; positions
    (B, S) / (B, T); ``kv_valid`` (B, T) bool masks cache slots.
    Softmax in float32.
    """
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    logits = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
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
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


def attention_apply(params, x, *, positions, cfg, local: bool = False,
                    causal: bool = True, cross_kv=None, cross_positions=None,
                    impl: str = "kernel"):
    """Self- (or cross-) attention over one segment (train or prefill).
    ``impl="kernel"`` runs the flash attention kernel, which assumes
    ``positions`` is the trivial arange; ``impl="xla"`` runs
    ``gqa_scores``, plain tensor ops that differentiate (the reference's
    XLA path).  A ``local`` layer sees only the ``cfg.sliding_window``
    keys up to each query.  With ``cross_kv`` = (k, v) from an encoder
    (B, T, K, D), the S queries attend to all T keys, non-causally, at
    ``cross_positions`` (the encoder's arange).  Returns (out, (k, v)) —
    the freshly projected k/v for cache insertion, or the cross k/v."""
    if impl not in ("kernel", "xla"):
        raise ValueError(f"attention_apply: unknown impl {impl!r}")
    if cross_kv is not None:
        q = _proj(x, params["wq"])
        if cfg.use_rope:
            q = apply_rope(q, positions, cfg.rope_theta)
        k, v = cross_kv
        if impl == "xla":
            out = gqa_scores(q, k, v, q_positions=positions,
                             kv_positions=cross_positions, causal=False,
                             softcap=cfg.attn_logit_softcap)
        else:
            out = kops.flash_attention(
                q.contiguous(), k.contiguous(), v.contiguous(), causal=False,
                softcap=cfg.attn_logit_softcap)
        return output_proj(params, out, x.dtype), (k, v)
    q, k, v = project_qkv(params, x, positions, cfg)
    window = cfg.sliding_window if local else 0
    if impl == "xla":
        out = gqa_scores(q, k, v, q_positions=positions,
                         kv_positions=positions, causal=causal, window=window,
                         softcap=cfg.attn_logit_softcap)
    else:
        out = kops.flash_attention(
            q.contiguous(), k.contiguous(), v.contiguous(), causal=causal,
            window=window, softcap=cfg.attn_logit_softcap)
    return output_proj(params, out, x.dtype), (k, v)


def cross_kv_project(params, enc_out, cfg):
    """Project encoder output into cross-attention K/V once (cached)."""
    return _proj(enc_out, params["wk"]), _proj(enc_out, params["wv"])


def cross_attention_decode(params, x, k, v, cfg, positions=None):
    """One decode step's cross-attention: x (B, 1, d) queries every one
    of the T cached encoder keys k/v (B, T, K, D), through the decode
    kernel with lengths = T."""
    q = _proj(x, params["wq"])
    if cfg.use_rope:
        q = apply_rope(q, positions, cfg.rope_theta)
    B, T = k.shape[:2]
    lengths = torch.full((B,), T, dtype=torch.int32, device=x.device)
    out = kops.decode_attention(q[:, 0].contiguous(), k, v, lengths,
                                softcap=cfg.attn_logit_softcap)[:, None]
    return output_proj(params, out, x.dtype)


def cache_insert(cache_arr, new_val, lengths):
    """Write new_val (B, 1, ...) into cache (B, T, ...) at per-row
    position ``lengths``, in place.  Returns the cache."""
    B = cache_arr.shape[0]
    rows = torch.arange(B, device=cache_arr.device)
    cache_arr[rows, lengths.long()] = new_val[:, 0].to(cache_arr.dtype)
    return cache_arr


def paged_cache_insert(pages, new_val, block_tables, lengths):
    """Write new_val (B, 1, ...) into a paged cache (n_pages, page_size,
    ...) at per-row position ``lengths``, resolving the owning page
    through ``block_tables`` (B, n_max); in place.  Returns the pages.

    Live sequences never share pages, so the batched scatter indices
    are unique across rows; rows whose table points at a dummy page
    (dead decode rows) collide only with each other, on a page no
    sequence reads.
    """
    ps = pages.shape[1]
    B = new_val.shape[0]
    n_max = block_tables.shape[1]
    lengths = lengths.long()
    rows = torch.arange(B, device=pages.device)
    page = block_tables.long()[rows, (lengths // ps).clamp(0, n_max - 1)]
    pages[page, lengths % ps] = new_val[:, 0].to(pages.dtype)
    return pages


def paged_gather(pages, block_tables):
    """Materialize each sequence's pages contiguously: (n_pages, ps,
    ...) + tables (B, n_max) -> (B, n_max*ps, ...)."""
    B, n_max = block_tables.shape
    ps = pages.shape[1]
    return pages[block_tables.long()].reshape(B, n_max * ps, *pages.shape[2:])
