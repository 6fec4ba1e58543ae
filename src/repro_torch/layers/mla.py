"""Multi-head Latent Attention (DeepSeek-V2/V3).

K/V are reconstructed from a low-rank latent ``c_kv`` plus one shared
rotary key ``k_rope``; only (c_kv, k_rope) are cached: 576 floats a
token and layer for deepseek-v3 (kv_lora_rank 512 + qk_rope_dim 64).

API:
  mla_project_kv(params, x, positions, cfg) -> (ckv, k_rope)
  mla_attend(params, x, positions, cfg, ckv_all, kr_all, ...) -> out
  mla_apply(...) -> (out, (ckv, k_rope))    # prefill
  mla_decode_paged(params, x, positions, cfg, ckv_pages, kr_pages,
                   block_tables, lengths) -> out   # paged decode

The reference computes MLA as plain products outside any Pallas kernel,
and so do the port's training, prefill and dense-cache decode
(``torch.einsum``): like the reference, they reconstruct ``k_nope`` and
``v`` from the whole latent cache on every call.  The port's paged
decode (which the reference does not have) attends in the absorbed
form instead: ``W_uk`` folded into the query gives each head a
latent query, the ``paged_mla_decode`` kernel takes its scores against
``ckv || k_rope`` over the row's pages, the softmax and the weighted sum
of ``ckv``, and ``W_uv`` and ``W_o`` are applied after it.  The
rebuilt form would cost 2 H T r (nope + v) FLOPs a row and layer
every step, the absorbed one 2 H T (r + rope + r).

Rotary angles follow ``cfg.rope_yarn`` (YaRN, ``layers.rope``); the
softmax scale is ``softmax_scale(cfg)``.
"""

from __future__ import annotations

import math

import torch

from repro_torch.layers.initializers import WSpec
from repro_torch.layers.norms import apply_norm, norm_specs
from repro_torch.layers.rope import apply_rope, yarn_mscale

NEG_INF = -2.0e38


def softmax_scale(cfg) -> float:
    """1/sqrt(qk head dim), times YaRN's mscale(factor, mscale_all_dim)
    squared where the config has YaRN (DeepSeek-V3's modelling code)."""
    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
    yarn = cfg.rope_yarn
    if yarn is not None and yarn.mscale_all_dim:
        scale *= yarn_mscale(yarn.factor, yarn.mscale_all_dim) ** 2
    return scale


def mla_specs(cfg):
    H = cfg.n_heads
    return {
        "w_dq": WSpec((cfg.d_model, cfg.q_lora_rank), ("embed", "mla_rank")),
        "q_norm": norm_specs(cfg.q_lora_rank),
        "w_uq": WSpec(
            (cfg.q_lora_rank, H, cfg.qk_nope_dim + cfg.qk_rope_dim),
            ("mla_rank", "heads", None),
        ),
        "w_dkv": WSpec((cfg.d_model, cfg.kv_lora_rank), ("embed", "mla_rank")),
        "kv_norm": norm_specs(cfg.kv_lora_rank),
        "w_kr": WSpec((cfg.d_model, cfg.qk_rope_dim), ("embed", None)),
        "w_uk": WSpec(
            (cfg.kv_lora_rank, H, cfg.qk_nope_dim), ("mla_rank", "heads", None)
        ),
        "w_uv": WSpec(
            (cfg.kv_lora_rank, H, cfg.v_head_dim), ("mla_rank", "heads", None)
        ),
        "w_o": WSpec((H, cfg.v_head_dim, cfg.d_model), ("heads", None, "embed")),
    }


def mla_project_kv(params, x, positions, cfg):
    """x (B, S, d) -> the latent ckv (B, S, kv_lora_rank), normed, and
    the rotary key (B, S, qk_rope_dim), shared by every head."""
    dt = x.dtype
    ckv = apply_norm(params["kv_norm"], x @ params["w_dkv"].to(dt),
                     cfg.norm, cfg.norm_eps)
    k_rope = apply_rope(x @ params["w_kr"].to(dt), positions, cfg.rope_theta,
                        cfg.rope_yarn)
    return ckv, k_rope


def _queries(params, x, positions, cfg):
    """(q_nope (B, S, H, nope), q_rope (B, S, H, rope)), rope applied."""
    dt = x.dtype
    cq = apply_norm(params["q_norm"], x @ params["w_dq"].to(dt),
                    cfg.norm, cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"].to(dt))
    return q[..., :cfg.qk_nope_dim], apply_rope(
        q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta,
        cfg.rope_yarn)


def mla_attend(params, x, *, positions, cfg, ckv_all, kr_all, kv_positions,
               kv_valid=None, causal: bool = True):
    """The S queries of x (B, S, d) at ``positions`` (B, S) attend over
    the latent cache ckv_all (B, T, r) / kr_all (B, T, rope) at
    ``kv_positions`` (B, T), masked causally and by ``kv_valid`` (B, T);
    logits and softmax in float32.  Returns (B, S, d)."""
    dt = x.dtype
    q_nope, q_rope = _queries(params, x, positions, cfg)

    k_nope = torch.einsum("btr,rhk->bthk", ckv_all, params["w_uk"].to(dt))
    v = torch.einsum("btr,rhv->bthv", ckv_all, params["w_uv"].to(dt))

    scale = softmax_scale(cfg)
    logits = (torch.einsum("bshk,bthk->bhst", q_nope, k_nope)
              + torch.einsum("bshk,btk->bhst", q_rope, kr_all)).float() * scale

    qp = positions[:, :, None]
    kp = kv_positions[:, None, :]
    mask = (kp <= qp) if causal else torch.ones_like(kp <= qp)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, :]
    logits = torch.where(mask[:, None], logits,
                         torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1).to(dt)

    out = torch.einsum("bhst,bthv->bshv", probs, v)
    return torch.einsum("bshv,hvd->bsd", out, params["w_o"].to(dt))


def mla_apply(params, x, *, positions, cfg):
    """Causal self-attention over x (prefill).  Returns (out, (ckv,
    k_rope)) for the cache."""
    ckv, kr = mla_project_kv(params, x, positions, cfg)
    out = mla_attend(params, x, positions=positions, cfg=cfg,
                     ckv_all=ckv, kr_all=kr, kv_positions=positions)
    return out, (ckv, kr)


def mla_decode_paged(params, x, *, positions, cfg, ckv_pages, kr_pages,
                     block_tables, lengths):
    """One query a row, x (B, 1, d) at ``positions`` (B, 1), over the
    latent page pools ckv_pages (P, page_size, r) / kr_pages (P,
    page_size, rope), the rows' pages in ``block_tables`` (B, n_max) and
    their ``lengths`` (B,) live keys, in the absorbed form (see the
    module docstring).  Returns (B, 1, d)."""
    from repro_torch.kernels import ops

    dt = x.dtype
    q_nope, q_rope = _queries(params, x, positions, cfg)
    q_lat = torch.einsum("bhk,rhk->bhr", q_nope[:, 0],
                         params["w_uk"].to(dt))
    pool_dt = ckv_pages.dtype
    o_lat = ops.paged_mla_decode(
        q_lat.to(pool_dt).contiguous(), q_rope[:, 0].to(pool_dt).contiguous(),
        ckv_pages, kr_pages, block_tables, lengths,
        scale=softmax_scale(cfg)).to(dt)
    out = torch.einsum("bhr,rhv->bhv", o_lat, params["w_uv"].to(dt))
    return torch.einsum("bhv,hvd->bd", out, params["w_o"].to(dt))[:, None]
