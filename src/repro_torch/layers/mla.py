"""Multi-head Latent Attention (DeepSeek-V2/V3).

K/V are reconstructed from a low-rank latent ``c_kv`` plus one shared
rotary key ``k_rope``; only (c_kv, k_rope) are cached: 576 floats a
token and layer for deepseek-v3 (kv_lora_rank 512 + qk_rope_dim 64).

API:
  mla_project_kv(params, x, positions, cfg) -> (ckv, k_rope)
  mla_attend(params, x, positions, cfg, ckv_all, kr_all, ...) -> out
  mla_apply(...) -> (out, (ckv, k_rope))    # prefill

The reference computes MLA as plain products outside any Pallas kernel,
and so does the port (``torch.einsum``).  Like the reference, it
reconstructs ``k_nope`` and ``v`` from the whole latent cache on every
call; the absorbed form (``W_uk`` folded into the query, ``W_uv`` into
``W_o``) rounds differently and is not used.
"""

from __future__ import annotations

import math

import torch

from repro_torch.layers.initializers import WSpec
from repro_torch.layers.norms import apply_norm, norm_specs
from repro_torch.layers.rope import apply_rope

NEG_INF = -2.0e38


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
    k_rope = apply_rope(x @ params["w_kr"].to(dt), positions, cfg.rope_theta)
    return ckv, k_rope


def mla_attend(params, x, *, positions, cfg, ckv_all, kr_all, kv_positions,
               kv_valid=None, causal: bool = True):
    """The S queries of x (B, S, d) at ``positions`` (B, S) attend over
    the latent cache ckv_all (B, T, r) / kr_all (B, T, rope) at
    ``kv_positions`` (B, T), masked causally and by ``kv_valid`` (B, T);
    logits and softmax in float32.  Returns (B, S, d)."""
    dt = x.dtype
    cq = apply_norm(params["q_norm"], x @ params["w_dq"].to(dt),
                    cfg.norm, cfg.norm_eps)
    q = torch.einsum("bsr,rhk->bshk", cq, params["w_uq"].to(dt))
    q_nope = q[..., :cfg.qk_nope_dim]
    q_rope = apply_rope(q[..., cfg.qk_nope_dim:], positions, cfg.rope_theta)

    k_nope = torch.einsum("btr,rhk->bthk", ckv_all, params["w_uk"].to(dt))
    v = torch.einsum("btr,rhv->bthv", ckv_all, params["w_uv"].to(dt))

    scale = 1.0 / math.sqrt(cfg.qk_nope_dim + cfg.qk_rope_dim)
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
