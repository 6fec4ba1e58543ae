"""DeepSeek-V3's language model, as dots.vlm1 serves it behind its
vision tower, in plain PyTorch: the reference the port's paged MLA, its
noaux_tc router over held experts and its YaRN are held to.

It imports nothing of the port or of the JAX package and no kernel:
float32 throughout (``allow_tf32`` off on both backends, set by each
entry point), no cache and no batching: one sequence's whole forward
pass, its attention computed in blocks of query rows so that a long
sequence fits.  It follows DeepSeek-V3's published description
(arXiv:2412.19437; the model's published ``modeling_deepseek.py``):

* the image prefix (the merger's output) ahead of the prompt's token
  embeddings, no further map;
* ``n_dense`` blocks of RMSNorm, MLA, RMSNorm and a SwiGLU MLP, then
  blocks whose MLP is the mixture of experts; a final RMSNorm and an
  untied output head;
* MLA, not absorbed: the query through its low-rank pair (``w_dq``,
  RMSNorm, ``w_uq``), split into ``nope`` and rotary parts; the latent
  ``ckv = RMSNorm(x w_dkv)`` and the shared rotary key ``x w_kr``; keys
  ``[ckv w_uk, k_rope]`` and values ``ckv w_uv`` per head; the causal
  softmax at scale ``(nope + rope)^-0.5 * mscale(factor,
  mscale_all_dim)^2``; the heads' outputs through ``w_o``;
* YaRN's rotary frequencies: each of theta's frequencies blended with
  itself over ``factor`` along a linear ramp between the correction dims
  of ``beta_fast`` and ``beta_slow`` rotations over the original
  context, cos and sin scaled by ``mscale(factor, mscale) /
  mscale(factor, mscale_all_dim)``;
* the noaux_tc router: ``s = sigmoid(x W_r)``; selection scores ``s +
  e_score_correction_bias``; per group of ``E / n_group`` experts the sum
  of its two best selection scores, the ``topk_group`` best groups kept;
  the top-k experts by selection score in the kept groups; their gates
  ``s`` normalised to sum 1, times ``routed_scaling_factor``;
* the routed experts' SwiGLU FFNs weighted by their gates, plus the
  shared expert.

Departures, each noted:

* Held experts: the model is one rank's share of a deployment whose MoE
  layers spread the routed experts over several ranks.  The router
  scores all of them; only the experts [e0, e0 + n_held) have weights
  here, and only their part of the routed sum is added (the other ranks'
  parts are left out), the shared expert whole.  With every expert held
  this is the published layer.
* Masked groups are set to -inf before the top-k, as DeepSeek's own
  inference code does (its ``modeling_deepseek.py`` fills 0.0, which
  differs only where a kept expert's selection score is below 0).
* Rotary angles in the half-rotation layout (x1, x2 halves), not the
  published interleaved pairs: a fixed permutation of the rotary
  weights' columns, the same function of other weights.
* Multi-token prediction is not run: inference without it is the
  model's standard path.
* The weights are read by the port's parameter names (a tree of
  tensors); stacked layers on a leading axis.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PRECISIONS = ("float32", "tf32")
#: query rows of one block of the attention
Q_BLOCK = 256


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round float32 ``x`` to TF32's 10 mantissa bits (nearest, ties to
    even): the control's operands."""
    i = x.float().contiguous().view(torch.int32)
    lsb = torch.bitwise_and(torch.bitwise_right_shift(i, 13), 1)
    i = torch.bitwise_and(i + 0x0FFF + lsb, -8192)
    return i.view(torch.float32)


def mm(a, b, precision="float32"):
    """A product at the reference's precision ("float32") or the
    control's ("tf32": both operands rounded to TF32, summed in
    float32)."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r} is not one of {PRECISIONS}")
    if precision == "tf32":
        a, b = round_tf32(a), round_tf32(b)
    return torch.matmul(a.float(), b.float())


def rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


# --------------------------------------------------------------------------
# YaRN
# --------------------------------------------------------------------------

def yarn_get_mscale(scale: float, mscale: float = 1.0) -> float:
    if scale <= 1:
        return 1.0
    return 0.1 * mscale * math.log(scale) + 1.0


def yarn_find_correction_dim(num_rotations, dim, base, max_positions):
    return (dim * math.log(max_positions / (num_rotations * 2 * math.pi))) \
        / (2 * math.log(base))


def yarn_find_correction_range(low_rot, high_rot, dim, base, max_positions):
    low = math.floor(yarn_find_correction_dim(low_rot, dim, base,
                                              max_positions))
    high = math.ceil(yarn_find_correction_dim(high_rot, dim, base,
                                              max_positions))
    return max(low, 0), min(high, dim - 1)


def yarn_linear_ramp_mask(lo, hi, dim, device=None):
    if lo == hi:
        hi += 0.001
    ramp = (torch.arange(dim, dtype=torch.float32, device=device) - lo) \
        / (hi - lo)
    return ramp.clamp(0, 1)


def inv_freq(dim, theta, yarn=None, device=None):
    """(dim/2,) the rotary frequencies: theta's, or YaRN's where ``yarn``
    (a dict of the config's ``rope_scaling``) is given."""
    extra = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim)
    if not yarn:
        return extra
    inter = extra / yarn["factor"]
    lo, hi = yarn_find_correction_range(
        yarn["beta_fast"], yarn["beta_slow"], dim, theta,
        yarn["original_max_position_embeddings"])
    mask = 1.0 - yarn_linear_ramp_mask(lo, hi, dim // 2, device)
    return inter * (1 - mask) + extra * mask


def cos_sin_scale(yarn) -> float:
    if not yarn:
        return 1.0
    return yarn_get_mscale(yarn["factor"], yarn["mscale"]) \
        / yarn_get_mscale(yarn["factor"], yarn["mscale_all_dim"])


def softmax_scale(c) -> float:
    scale = (c["nope"] + c["rope"]) ** -0.5
    yarn = c.get("yarn")
    if yarn and yarn.get("mscale_all_dim"):
        scale *= yarn_get_mscale(yarn["factor"], yarn["mscale_all_dim"]) ** 2
    return scale


def rope(x, positions, c):
    """x (S, ..., dim) rotated at ``positions`` (S,)."""
    dim = x.shape[-1]
    ang = positions.float()[:, None] * inv_freq(dim, c["theta"], c.get("yarn"),
                                                x.device)
    m = cos_sin_scale(c.get("yarn"))
    cos, sin = torch.cos(ang) * m, torch.sin(ang) * m
    while cos.ndim < x.ndim:
        cos, sin = cos[:, None], sin[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


# --------------------------------------------------------------------------
# the blocks
# --------------------------------------------------------------------------

def mla(a, i, x, c, precision="float32"):
    """Causal MLA over x (S, d) at positions 0..S-1; layer i of the
    stacked weights ``a``.  Returns (S, d)."""
    S = x.shape[0]
    H, nope, rp, vd = c["H"], c["nope"], c["rope"], c["v"]
    pos = torch.arange(S, device=x.device)
    cq = rms(mm(x, a["w_dq"][i], precision), a["q_norm"]["scale"][i], c["eps"])
    q = mm(cq, a["w_uq"][i].reshape(cq.shape[-1], -1), precision).view(
        S, H, nope + rp)
    q_nope, q_pe = q[..., :nope], rope(q[..., nope:], pos, c)
    ckv = rms(mm(x, a["w_dkv"][i], precision), a["kv_norm"]["scale"][i],
              c["eps"])
    k_pe = rope(mm(x, a["w_kr"][i], precision), pos, c)          # (S, rope)
    r = ckv.shape[-1]
    k_nope = mm(ckv, a["w_uk"][i].reshape(r, -1), precision).view(S, H, nope)
    v = mm(ckv, a["w_uv"][i].reshape(r, -1), precision).view(S, H, vd)
    k = torch.cat([k_nope, k_pe[:, None].expand(S, H, rp)], dim=-1)
    qh, kh, vh = (t.transpose(0, 1) for t in (torch.cat([q_nope, q_pe], -1),
                                              k, v))            # (H, S, *)
    scale = softmax_scale(c)
    out = torch.empty((H, S, vd), device=x.device)
    for a0 in range(0, S, Q_BLOCK):
        a1 = min(a0 + Q_BLOCK, S)
        s = mm(qh[:, a0:a1], kh[:, :a1].transpose(-1, -2), precision) * scale
        mask = torch.ones(a1 - a0, a1, dtype=torch.bool,
                          device=x.device).tril(a0)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[:, a0:a1] = mm(p, vh[:, :a1], precision)
    o = out.transpose(0, 1).reshape(S, H * vd)
    return mm(o, a["w_o"][i].reshape(H * vd, -1), precision)


def swiglu(m, x, precision="float32", i=None):
    """SwiGLU over x; ``i`` picks the layer of stacked weights."""
    sel = (lambda w: w) if i is None else (lambda w: w[i])
    g = F.silu(mm(x, sel(m["wi_gate"]), precision))
    return mm(g * mm(x, sel(m["wi_up"]), precision), sel(m["wo"]), precision)


def route(x, w_r, bias, c, precision="float32"):
    """The noaux_tc router over x (T, d): (gates (T, k), experts (T, k))."""
    s = torch.sigmoid(mm(x, w_r, precision))
    sel = s + bias.float()
    T, E = s.shape
    g = c["n_group"]
    group = sel.view(T, g, E // g).topk(2, dim=-1).values.sum(-1)
    kept = torch.zeros_like(group).scatter_(
        1, group.topk(c["topk_group"], dim=-1).indices, 1.0).bool()
    sel = sel.masked_fill(~kept.repeat_interleave(E // g, dim=1),
                          float("-inf"))
    idx = sel.topk(c["top_k"], dim=-1).indices
    gates = s.gather(1, idx)
    gates = gates / gates.sum(-1, keepdim=True) * c["routed_scale"]
    return gates, idx


def moe(m, i, x, c, precision="float32"):
    """Layer i's MoE over x (T, d): the held experts' share of the routed
    sum plus the shared expert (see the module docstring)."""
    gates, idx = route(x, m["router"][i], m["e_score_correction_bias"][i], c,
                       precision)
    e0 = c["e0"]
    y = swiglu(m["shared"], x, precision, i)
    for e in range(m["wi_gate"].shape[1]):
        tok, slot = torch.nonzero(idx == e0 + e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        g = F.silu(mm(xe, m["wi_gate"][i, e], precision))
        ye = mm(g * mm(xe, m["wi_up"][i, e], precision), m["wo"][i, e],
                precision)
        y = y.index_add(0, tok, ye * gates[tok, slot][:, None])
    return y


def hidden(p, c, image_embeds, tokens, precision="float32"):
    """The final hidden states (S, d) of one sequence: the image prefix
    (n_img, d), then ``tokens``' embeddings."""
    no_tf32()
    h = torch.cat([image_embeds.float(),
                   p["embed"]["table"][tokens.long()].float()], dim=0)
    for stage in ("dense", "moe"):
        blk = p["stages"][stage]["blocks"]
        for i in range(blk["ln_attn"]["scale"].shape[0]):
            x = rms(h, blk["ln_attn"]["scale"][i], c["eps"])
            h = h + mla(blk["attn"], i, x, c, precision)
            x = rms(h, blk["ln_mlp"]["scale"][i], c["eps"])
            h = h + (moe(blk["moe"], i, x, c, precision) if stage == "moe"
                     else swiglu(blk["mlp"], x, precision, i))
    return h


def logits_at(p, c, image_embeds, tokens, rows, precision="float32"):
    """The logits (len(rows), vocab) at positions ``rows`` of one
    sequence."""
    h = hidden(p, c, image_embeds, tokens, precision)
    h = rms(h[rows], p["final_norm"]["scale"], c["eps"])
    return mm(h, p["head"]["w"], precision)


def merger(p, patches, c, precision="float32"):
    """The vision tower's patch merger over (n_patches, context) patch
    features: LayerNorm(context), each 2 x 2 group of neighbouring
    patches (consecutive rows) concatenated, Linear, GELU, Linear ->
    (n_patches / 4, d)."""
    no_tf32()
    x = F.layer_norm(patches.float(), (patches.shape[-1],), p["ln"]["scale"],
                     p["ln"]["bias"], c["merger_eps"])
    x = x.reshape(-1, p["w1"].shape[0])
    x = F.gelu(mm(x, p["w1"], precision) + p["b1"])
    return mm(x, p["w2"], precision) + p["b2"]
