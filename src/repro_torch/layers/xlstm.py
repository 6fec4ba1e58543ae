"""xLSTM blocks: chunkwise-parallel mLSTM and recurrent sLSTM.

mLSTM is a matrix-memory cell with exponential gating: the stabilized
chunkwise form (linear in sequence length) for prefill and an O(1) step
for decode, both in torch as in the reference (it has no kernel).
sLSTM has memory mixing and cannot be parallelized over time: its whole
recurrence, prefill and decode alike, runs in one launch of the
hand-written sLSTM kernel (``kernels.ops.slstm_scan``), which has no
backward; ``impl="xla"`` (the loss) runs the same recurrence step by
step in plain torch (``kernels.ref.slstm_scan_ref``, the reference's
``lax.scan`` step), which differentiates.

Under a mesh each block runs on each rank's local tensors (inside
``common.sharding.shard_map``; ``mlstm_layout`` and ``slstm_layout``
give the per-rank specs), as GSPMD lays the reference out:

* mLSTM: ``w_up``/``w_gate`` columns and ``wq``/``wk``/``wv``/``wi``/
  ``wf`` rows are the rank's share of d_in ("ssm_inner"), so q, k, v and
  the gates are partial sums, reduced by one all_reduce; the cell runs
  on the rank's heads ("ssm_heads"), whose h columns are its d_in
  columns when both resolve to the same axes (or all heads, sliced to
  its columns, when the heads are whole); ``out_norm`` normalises over
  the whole d_in (all-reduced sums) and ``w_down``'s partial products
  are summed by an all_reduce.
* sLSTM: the gate projections' columns, the biases and R are the rank's
  heads (R gathered over "slstm_rec", once a call, before the kernel:
  its cluster plan needs a head whole); the kernel runs on them, from
  the state's columns of those heads, and the new state is gathered
  over the heads.  The post-FFN runs tensor-parallel over its hidden
  dim where "mlp" splits it (after gathering the output over the
  heads), else on the rank's columns of the output (its norm's sums
  all-reduced, ``ffn_up``'s partial products summed) before the gather.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.common import sharding
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.layers.initializers import WSpec
from repro_torch.layers.mlp import activation
from repro_torch.layers.norms import apply_norm, norm_specs

GATES = ("i", "f", "z", "o")


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_dims(cfg):
    d_in = int(cfg.mlstm_proj_factor * cfg.d_model)
    H = cfg.n_heads
    return d_in, H, d_in // H


def mlstm_specs(cfg):
    d, (d_in, H, hd) = cfg.d_model, mlstm_dims(cfg)
    return {
        "ln": norm_specs(d, cfg.norm),
        "w_up": WSpec((d, d_in), ("embed", "ssm_inner")),
        "w_gate": WSpec((d, d_in), ("embed", "ssm_inner")),
        "wq": WSpec((d_in, d_in), ("ssm_inner", None)),
        "wk": WSpec((d_in, d_in), ("ssm_inner", None)),
        "wv": WSpec((d_in, d_in), ("ssm_inner", None)),
        "wi": WSpec((d_in, H), ("ssm_inner", "ssm_heads"), init="small"),
        "wf": WSpec((d_in, H), ("ssm_inner", "ssm_heads"), init="small"),
        "b_i": WSpec((H,), ("ssm_heads",), init="zeros"),
        "b_f": WSpec((H,), ("ssm_heads",), init="ones"),
        "out_norm": norm_specs(d_in),
        "w_down": WSpec((d_in, d), ("ssm_inner", "embed")),
    }


def _fresh_mlstm_state(B, H, D, device):
    return (torch.zeros((B, H, D, D), device=device),
            torch.zeros((B, H, D), device=device),
            torch.full((B, H), -1e30, device=device))


def _mlstm_chunked(q, k, v, i_log, f_log, chunk: int, state=None):
    """Stabilized chunkwise mLSTM.

    q,k,v: (B,S,H,D); i_log,f_log: (B,S,H) log-space gates.
    state: (C (B,H,D,D), n (B,H,D), m (B,H)) or None.
    Returns (h (B,S,H,D), state')."""
    B, S, H, D = q.shape
    L = min(chunk, S)
    if S % L:  # pad tail: i_log=-1e30, f_log=0 (state-neutral)
        pad = L - S % L
        q = F.pad(q, (0, 0, 0, 0, 0, pad))
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        i_log = F.pad(i_log, (0, 0, 0, pad), value=-1e30)
        f_log = F.pad(f_log, (0, 0, 0, pad))
        out, st = _mlstm_chunked(q, k, v, i_log, f_log, chunk, state)
        return out[:, :S], st
    nc = S // L
    scale = 1.0 / math.sqrt(D)

    qc = (q.float() * scale).reshape(B, nc, L, H, D)
    kc = k.float().reshape(B, nc, L, H, D)
    vc = v.float().reshape(B, nc, L, H, D)
    il = i_log.float().reshape(B, nc, L, H)
    fl = f_log.float().reshape(B, nc, L, H)

    cumf = torch.cumsum(fl, dim=2)                     # (B,nc,L,H)
    bsrc = il - cumf                                   # source weight logs
    F_L = cumf[:, :, -1, :]                            # (B,nc,H)

    C, n, m = (_fresh_mlstm_state(B, H, D, q.device) if state is None
               else state)
    causal = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    hs = []
    for c in range(nc):
        q_, k_, v_ = qc[:, c], kc[:, c], vc[:, c]
        b_, cumf_, FL_ = bsrc[:, c], cumf[:, c], F_L[:, c]
        # stabilizers
        m_intra = cumf_ + torch.cummax(b_, dim=1).values  # (B,L,H)
        m_inter = cumf_ + m[:, None, :]
        m_t = torch.maximum(m_intra, m_inter)
        # intra scores
        logw = cumf_[:, :, None, :] + b_[:, None, :, :] - m_t[:, :, None, :]
        logw = torch.where(causal[None, :, :, None], logw,
                           torch.full_like(logw, -math.inf))
        w = torch.exp(logw)                            # (B,t,s,H)
        qk = torch.einsum("blhd,bmhd->blmh", q_, k_)
        h_num = torch.einsum("blmh,bmhd->blhd", qk * w, v_)
        # inter contributions
        w_in = torch.exp(cumf_ + m[:, None, :] - m_t)  # (B,L,H)
        h_num = h_num + torch.einsum("blhd,bhde->blhe", q_, C) * w_in[..., None]
        n_dot = torch.einsum("blhd,bhd->blh", q_, n)
        denom_intra = torch.einsum("blmh,bmhd,blhd->blh", w, k_, q_)
        denom = denom_intra + n_dot * w_in
        hs.append(h_num / torch.maximum(denom.abs(),
                                        torch.exp(-m_t))[..., None])
        # state update
        Mloc = b_.max(dim=1).values                    # (B,H)
        m_new = torch.maximum(m + FL_, FL_ + Mloc)
        wk_s = torch.exp(FL_[:, None, :] + b_ - m_new[:, None, :])  # (B,L,H)
        decay = torch.exp(m + FL_ - m_new)
        C = C * decay[:, :, None, None] + torch.einsum(
            "blhd,blhe,blh->bhde", k_, v_, wk_s)
        n = n * decay[:, :, None] + torch.einsum("blhd,blh->bhd", k_, wk_s)
        m = m_new
    h = torch.stack(hs, dim=1).reshape(B, S, H, D)
    return h.to(q.dtype), (C, n, m)


def mlstm_recurrent_ref(q, k, v, i_log, f_log, state=None):
    """Naive per-step mLSTM (the decode step, and the tests' oracle)."""
    B, S, H, D = q.shape
    scale = 1.0 / math.sqrt(D)
    C, n, m = (_fresh_mlstm_state(B, H, D, q.device) if state is None
               else state)
    qs, ks, vs, ils, fls = (t.float() for t in (q, k, v, i_log, f_log))
    hs = []
    for t in range(S):
        q_, k_, v_, il_, fl_ = qs[:, t], ks[:, t], vs[:, t], ils[:, t], fls[:, t]
        m_new = torch.maximum(fl_ + m, il_)
        f_ = torch.exp(fl_ + m - m_new)
        i_ = torch.exp(il_ - m_new)
        C = C * f_[:, :, None, None] + i_[:, :, None, None] * torch.einsum(
            "bhd,bhe->bhde", k_, v_)
        n = n * f_[:, :, None] + i_[:, :, None] * k_
        num = torch.einsum("bhd,bhde->bhe", q_ * scale, C)
        den = torch.maximum(
            torch.einsum("bhd,bhd->bh", q_ * scale, n).abs(), torch.exp(-m_new))
        m = m_new
        hs.append(num / den[..., None])
    return torch.stack(hs, dim=1).to(q.dtype), (C, n, m)


def mlstm_apply(params, x, cfg, *, state=None, inner=sharding.WHOLE,
                heads=sharding.WHOLE):
    """x: (B,S,d). state: None (fresh) or (C, n, m).  Chunkwise for a
    multi-token call, the recurrent step for one token.  With ``inner``
    and ``heads`` (``common.sharding.Split``s, inside ``shard_map``) the
    weights are this rank's share of d_in and the state its heads (see
    the module docstring).  Returns (y, state')."""
    d_in, H, hd = mlstm_dims(cfg)
    dt = x.dtype
    B, S = x.shape[:2]
    x = apply_norm(params["ln"], x, cfg.norm, cfg.norm_eps)
    xu = x @ params["w_up"].to(dt)
    z = x @ params["w_gate"].to(dt)
    # q, k, v and the gates' pre-activations: partial sums over the
    # rank's rows of d_in, reduced at once
    qkvif = inner.sum(torch.cat([xu @ params[w].to(dt) for w in
                                 ("wq", "wk", "wv", "wi", "wf")], dim=-1))
    q, k, v, gi, gf = qkvif.split([d_in, d_in, d_in, H, H], dim=-1)
    h0, n_h = heads.offset(H // heads.size), H // heads.size
    q, k, v = (t.reshape(B, S, H, hd)[:, :, h0:h0 + n_h] for t in (q, k, v))
    i_log = gi[..., h0:h0 + n_h].float() + params["b_i"].float()
    f_log = F.logsigmoid(gf[..., h0:h0 + n_h].float() + params["b_f"].float())
    if S == 1:
        h, new_state = mlstm_recurrent_ref(q, k, v, i_log, f_log, state=state)
    else:
        h, new_state = _mlstm_chunked(q, k, v, i_log, f_log, cfg.xlstm_chunk,
                                      state=state)
    h = h.reshape(B, S, n_h * hd)
    if inner and not heads:          # every head here: keep this rank's d_in
        c0 = inner.offset(z.shape[-1])
        h = h[..., c0:c0 + z.shape[-1]]
    h = apply_norm(params["out_norm"], h, cfg.norm, cfg.norm_eps, split=inner)
    h = h * F.silu(z)
    return inner.sum(h @ params["w_down"].to(dt)), new_state


def mlstm_layout(params, lead):
    """({"inner": the inner split's axes, "heads": the heads split's},
    the spec of a leaf by its path) of a sharded mLSTM block's weights
    (DTensors), the activations' batch spec ``lead`` taking its axes
    first.  Raises ``ValueError`` when the heads are split over other
    axes than d_in."""
    inner = sharding.unless_used(sharding.spec_of(params["w_up"])[1], lead)
    heads = sharding.unless_used(sharding.spec_of(params["b_i"])[0], lead)
    if heads is not None and heads != inner:
        raise ValueError(
            f"mlstm: 'ssm_heads' resolves to {heads!r} and 'ssm_inner' to "
            f"{inner!r}; a head's h columns are a block of d_in, so the "
            "heads split as d_in or not at all")
    rows = (inner, None)
    by_leaf = {"w_up": (None, inner), "w_gate": (None, inner), "wq": rows,
               "wk": rows, "wv": rows, "wi": rows, "wf": rows,
               "b_i": (heads,), "b_f": (heads,), "out_norm": (inner,),
               "w_down": rows}

    def spec(path, leaf):
        return by_leaf.get(path[0], (None,) * leaf.ndim)

    return {"inner": inner, "heads": heads}, spec


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_dims(cfg):
    H = cfg.n_heads
    return H, cfg.d_model // H


def slstm_specs(cfg):
    d = cfg.d_model
    H, hd = slstm_dims(cfg)
    d_ff = int(cfg.slstm_proj_factor * d)
    gates = {}
    for g in GATES:
        gates[f"w_{g}"] = WSpec((d, d), ("embed", None), init="small")
        gates[f"r_{g}"] = WSpec((H, hd, hd), ("ssm_heads", None, "slstm_rec"),
                                init="small")
        gates[f"b_{g}"] = WSpec((d,), (None,), init="ones" if g == "f" else "zeros")
    return {
        **gates,
        "ln": norm_specs(d, cfg.norm),
        "ffn_up": WSpec((d, d_ff), ("embed", "mlp")),
        "ffn_down": WSpec((d_ff, d), ("mlp", "embed")),
        "ffn_norm": norm_specs(d),
    }


def slstm_apply(params, x, cfg, *, state=None, impl: str = "kernel",
                heads=sharding.WHOLE, mlp=sharding.WHOLE):
    """x: (B,S,d). state: (c,n,h,m) each (B,d)-shaped (heads folded).
    The recurrence, from ``state`` or the fresh state, is one launch of
    the sLSTM kernel (``impl="kernel"``) or the plain step-by-step
    recurrence (``impl="xla"``); then the post-FFN.  With ``heads`` and
    ``mlp`` (``common.sharding.Split``s, inside ``shard_map``) the
    weights are this rank's heads and FFN share (``slstm_layout``) and
    the recurrence runs on its heads' columns of ``state``; the output
    and the new state come back whole.  Returns (y, (c,n,h,m))."""
    if impl not in ("kernel", "xla"):
        raise ValueError(f"slstm_apply: unknown impl {impl!r}")
    dt = x.dtype
    x = apply_norm(params["ln"], x, cfg.norm, cfg.norm_eps)
    xf = x.float()
    pre = torch.stack([xf @ params[f"w_{g}"].float() + params[f"b_{g}"].float()
                       for g in GATES], dim=2)          # (B,S,4,d)
    if state is not None and heads:
        c0, n = heads.offset(pre.shape[-1]), pre.shape[-1]
        state = tuple(t[:, c0:c0 + n].contiguous() for t in state)
    # R as its four (H,hd,hd) gate tensors: no stacked copy per call
    R = tuple(params[f"r_{g}"] for g in GATES)
    if impl == "xla":
        y, new_state = kref.slstm_scan_ref(pre, torch.stack(R), state)
    else:
        y, new_state = kops.slstm_scan(pre, R, state=state)
    y = y.to(dt)
    # post-FFN (GeLU, tanh form as jax.nn.gelu's default; pf 4/3) on the
    # heads' columns of y, or tensor-parallel over its hidden dim where
    # "mlp" splits it (y gathered first)
    cols = sharding.WHOLE if mlp else heads
    if heads and not cols:
        y = heads.gather(y, -1)
    yn = apply_norm(params["ffn_norm"], y, cfg.norm, cfg.norm_eps,
                    split=cols)
    ff = activation("gelu")(cols.sum(yn @ params["ffn_up"].to(dt)))
    y = cols.gather(y + mlp.sum(ff @ params["ffn_down"].to(dt)), -1)
    if heads:
        new_state = tuple(heads.gather(torch.stack(new_state), -1).unbind(0))
    return y, new_state


def slstm_layout(params, lead):
    """({"heads": the heads split's axes, "mlp": the FFN's hidden
    split's}, the spec of a leaf by its path) of a sharded sLSTM block's
    weights (DTensors), the activations' batch spec ``lead`` taking its
    axes first.  R comes in whole over "slstm_rec" (the kernel needs a
    head whole).  The FFN keeps its weights where they lie:
    tensor-parallel over its hidden dim where "mlp" splits it (the output
    gathered over the heads first), else on the rank's columns of the
    output, with the weights' rows or columns for those columns (a free
    slice of a replicated weight)."""
    heads = sharding.unless_used(sharding.spec_of(params["r_i"])[0], lead)
    mlp = sharding.unless_used(sharding.spec_of(params["ffn_up"])[1], lead)
    cols = heads if mlp is None else None    # the FFN on the heads' columns
    by_leaf = {"ffn_norm": (cols,), "ffn_up": (cols, mlp),
               "ffn_down": (mlp, cols)}
    for g in GATES:
        by_leaf.update({f"w_{g}": (None, heads), f"b_{g}": (heads,),
                        f"r_{g}": (heads, None, None)})

    def spec(path, leaf):
        return by_leaf.get(path[0], (None,) * leaf.ndim)

    return {"heads": heads, "mlp": mlp}, spec
