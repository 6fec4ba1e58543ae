"""Mamba2 (State-Space Duality) block.

Chunkwise-parallel SSD for a multi-token call (linear in sequence
length): with ``impl="kernel"`` (prefill) the intra-chunk part runs in
the hand-written SSD kernel (``kernels.ops.ssd_chunked``), which has no
backward; with ``impl="xla"`` (the loss) the whole chunked form is
plain torch that differentiates, a transcription of the reference's
``_ssd_chunked``.  An O(1) recurrent step serves decode (``S == 1``),
in torch as in the reference.  ``ssd_recurrent_ref`` is the naive
per-step oracle the tests use.

Under a mesh the block runs on each rank's heads (``mamba2_apply`` with
``inner``, inside ``common.sharding.shard_map``): a head is a
contiguous block of ``mamba_head_dim`` columns of d_in, so the rank's
``wz``/``wx``/``conv_x`` columns ("ssm_inner") are its heads' and its
``wdt``, ``A_log``, ``dt_bias``, ``D_skip`` entries ("ssm_heads") the
same heads, while ``wB``/``wC`` and their convs ("ssm_state") are
whole.  The SSD kernel runs on (B, S, H / m, P).  ``out_norm``
normalises over the whole d_in (its sums are all-reduced over the
heads' axes) and ``w_out``'s partial products are summed by an
all_reduce.  ``rank_layout`` gives the per-rank specs and raises where
"ssm_inner" and "ssm_heads" resolve to different mesh axes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import sharding
from repro_torch.kernels import ops as kops
from repro_torch.layers.initializers import WSpec
from repro_torch.layers.norms import apply_norm, norm_specs


def mamba2_dims(cfg):
    d_in = cfg.mamba_expand * cfg.d_model
    n_heads = d_in // cfg.mamba_head_dim
    return d_in, n_heads, cfg.ssm_state


def mamba2_specs(cfg):
    d_in, H, N = mamba2_dims(cfg)
    W = cfg.mamba_conv_width
    return {
        "wz": WSpec((cfg.d_model, d_in), ("embed", "ssm_inner")),
        "wx": WSpec((cfg.d_model, d_in), ("embed", "ssm_inner")),
        "wB": WSpec((cfg.d_model, N), ("embed", "ssm_state")),
        "wC": WSpec((cfg.d_model, N), ("embed", "ssm_state")),
        "wdt": WSpec((cfg.d_model, H), ("embed", "ssm_heads")),
        "conv_x": WSpec((W, d_in), (None, "ssm_inner")),
        "conv_B": WSpec((W, N), (None, "ssm_state")),
        "conv_C": WSpec((W, N), (None, "ssm_state")),
        "A_log": WSpec((H,), ("ssm_heads",), init="zeros"),
        "dt_bias": WSpec((H,), ("ssm_heads",), init="zeros"),
        "D_skip": WSpec((H,), ("ssm_heads",), init="ones"),
        "out_norm": norm_specs(d_in),
        "w_out": WSpec((d_in, cfg.d_model), ("ssm_inner", "embed")),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: (B, S, C), w: (W, C).

    With ``state`` (B, W-1, C) the conv continues from cached history.
    Returns (out, new_state) — the last W-1 inputs, history included."""
    W = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], W - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S, :] * w[i][None, None, :] for i in range(W))
    return out, xp[:, -(W - 1):, :]


def _ssd_chunked(xh, Bm, Cm, dt, A_log, D_skip, chunk: int,
                 initial_state=None):
    """Chunkwise SSD with the D skip.  xh: (B,S,H,P); Bm/Cm: (B,S,N);
    dt: (B,S,H) post-softplus.  A ragged tail is padded to the chunk
    with dt = 0 (decay 1, update 0: state-neutral).  x, B and C are
    widened to float32 first, as the reference widens them before its
    SSD, so the kernel's float32 instance runs under bfloat16 compute.
    Returns (y (B,S,H,P) in xh's dtype, final state (B,H,N,P)
    float32)."""
    out_dtype = xh.dtype
    xh, Bm, Cm = xh.float(), Bm.float(), Cm.float()
    S = xh.shape[1]
    L = min(chunk, S)
    pad = (L - S % L) % L
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
    y, final = kops.ssd_chunked(xh.contiguous(), Bm.contiguous(),
                                Cm.contiguous(), dt.contiguous(), A_log,
                                chunk=L, initial_state=initial_state)
    y = y[:, :S] + xh[:, :S] * D_skip.float()[None, None, :, None]
    return y.to(out_dtype), final


def _ssd_chunked_plain(xh, Bm, Cm, dt, A_log, D_skip, chunk: int,
                       initial_state=None):
    """``_ssd_chunked`` in plain torch (no kernel), step for step the
    reference's ``_ssd_chunked``: the intra-chunk scores, each chunk's
    end state, the recurrence over chunks and the inter-chunk output,
    all in float32, then the D skip."""
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    if S % L:  # pad tail: dt = 0 -> decay 1, update 0 (state-neutral)
        pad = L - S % L
        out, final = _ssd_chunked_plain(
            F.pad(xh, (0, 0, 0, 0, 0, pad)), F.pad(Bm, (0, 0, 0, pad)),
            F.pad(Cm, (0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)), A_log,
            D_skip, chunk, initial_state)
        return out[:, :S], final
    nc = S // L
    a = -torch.exp(A_log.float())                        # (H,)
    xc = xh.float().reshape(Bsz, nc, L, H, Pd)
    Bc = Bm.float().reshape(Bsz, nc, L, N)
    Cc = Cm.float().reshape(Bsz, nc, L, N)
    dtc = dt.float().reshape(Bsz, nc, L, H)
    cum = torch.cumsum(dtc * a, dim=2)                   # (B,nc,L,H)
    # intra-chunk: scores[s->t] = C_t.B_s exp(cum_t - cum_s) dt_s, s <= t
    G = torch.einsum("bcln,bcmn->bclm", Cc, Bc)
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    causal = torch.ones(L, L, dtype=torch.bool, device=xh.device).tril()
    M = torch.where(causal[None, None, :, :, None], G[..., None] * decay,
                    torch.zeros((), device=xh.device))
    y_intra = torch.einsum("bclmh,bcmhp->bclhp", M, xc * dtc[..., None])
    # each chunk's end state, then S_c = S_{c-1} Lam_c + S_loc_c
    w_end = torch.exp(cum[:, :, -1:, :] - cum)
    S_loc = torch.einsum("bcln,bclh,bclhp->bchnp", Bc, w_end * dtc, xc)
    Lam = torch.exp(cum[:, :, -1, :])                    # (B,nc,H)
    run = (torch.zeros((Bsz, H, N, Pd), device=xh.device)
           if initial_state is None else initial_state.float())
    before = []
    for c in range(nc):
        before.append(run)
        run = run * Lam[:, c, :, None, None] + S_loc[:, c]
    y_inter = torch.einsum("bcln,bchnp,bclh->bclhp", Cc,
                           torch.stack(before, dim=1), torch.exp(cum))
    y = y_intra + y_inter + xc * D_skip.float()[None, None, None, :, None]
    return y.reshape(Bsz, S, H, Pd).to(xh.dtype), run


def ssd_recurrent_ref(xh, Bm, Cm, dt, A_log, D_skip, initial_state=None):
    """Naive per-step SSD: s = s exp(dt a) + dt B (x) x; y = C.s + D x."""
    Bsz, S, H, Pd = xh.shape
    N = Bm.shape[-1]
    a = -torch.exp(A_log.float())
    s = (torch.zeros((Bsz, H, N, Pd), dtype=torch.float32, device=xh.device)
         if initial_state is None else initial_state.float())
    xs, Bs, Cs, dts = (t.float() for t in (xh, Bm, Cm, dt))
    D = D_skip.float()[None, :, None]
    ys = []
    for t in range(S):
        decay = torch.exp(dts[:, t] * a)                   # (B,H)
        upd = torch.einsum("bn,bh,bhp->bhnp", Bs[:, t], dts[:, t], xs[:, t])
        s = s * decay[:, :, None, None] + upd
        ys.append(torch.einsum("bn,bhnp->bhp", Cs[:, t], s) + xs[:, t] * D)
    return torch.stack(ys, dim=1).to(xh.dtype), s


def mamba2_apply(params, x, cfg, *, state=None, impl: str = "kernel",
                 inner=sharding.WHOLE):
    """Full block body.  x: (B, S, d_model).

    state: None (fresh) or dict(ssm=(B,H,N,P), conv_x/conv_B/conv_C).
    A multi-token call runs the chunked SSD, through the kernel
    (``impl="kernel"``, prefill) or in plain torch (``impl="xla"``, the
    loss); a one-token call (decode) the recurrent step.  With ``inner``
    (a ``common.sharding.Split``, inside ``shard_map``) the weights and
    state hold this rank's heads (``rank_layout``) and the output is
    summed over them.  Returns (y, new_state)."""
    if impl not in ("kernel", "xla"):
        raise ValueError(f"mamba2_apply: unknown impl {impl!r}")
    d_in, H = params["wz"].shape[1], params["A_log"].shape[0]
    dt_ = x.dtype
    z = x @ params["wz"].to(dt_)
    xr = x @ params["wx"].to(dt_)
    Br = x @ params["wB"].to(dt_)
    Cr = x @ params["wC"].to(dt_)
    dtl = x @ params["wdt"].to(dt_)

    cs = state or {}
    xc, ns_x = _causal_conv(xr, params["conv_x"].to(dt_), cs.get("conv_x"))
    Bc, ns_B = _causal_conv(Br, params["conv_B"].to(dt_), cs.get("conv_B"))
    Cc, ns_C = _causal_conv(Cr, params["conv_C"].to(dt_), cs.get("conv_C"))
    xc, Bc, Cc = F.silu(xc), F.silu(Bc), F.silu(Cc)

    dt_soft = F.softplus(dtl.float() + params["dt_bias"].float())
    xh = xc.reshape(*xc.shape[:2], H, cfg.mamba_head_dim)

    init_ssm = cs.get("ssm")
    if x.shape[1] == 1:
        y, final = ssd_recurrent_ref(xh, Bc, Cc, dt_soft, params["A_log"],
                                     params["D_skip"], initial_state=init_ssm)
    else:
        chunked = _ssd_chunked if impl == "kernel" else _ssd_chunked_plain
        y, final = chunked(xh, Bc, Cc, dt_soft, params["A_log"],
                           params["D_skip"], cfg.mamba_chunk,
                           initial_state=init_ssm)

    y = y.reshape(*x.shape[:2], d_in)
    y = apply_norm(params["out_norm"], y * F.silu(z), cfg.norm, cfg.norm_eps,
                   split=inner)
    out = inner.sum(y @ params["w_out"].to(dt_))
    new_state = {"ssm": final, "conv_x": ns_x, "conv_B": ns_B, "conv_C": ns_C}
    return out, new_state


def rank_layout(params, lead):
    """The per-rank layout of a sharded block's weights (DTensors):
    ({"inner": the axes its heads are split over}, a function of a
    leaf's path within ``params`` giving the spec ``shard_map`` hands it
    in at).
    ``lead`` is the activations' batch spec, whose axes no weight dim
    may take.  The heads follow ``wz``'s "ssm_inner" columns and
    ``A_log``'s "ssm_heads"; raises ``ValueError`` when the two resolve
    to different axes (a rank's columns would not be whole heads)."""
    inner = sharding.unless_used(sharding.spec_of(params["wz"])[1], lead)
    heads = sharding.unless_used(sharding.spec_of(params["A_log"])[0], lead)
    if inner != heads:
        raise ValueError(
            f"mamba2: 'ssm_inner' resolves to {inner!r} and 'ssm_heads' to "
            f"{heads!r}; a head is a contiguous block of d_in, so both must "
            "be split over the same mesh axes")
    by_leaf = {"wz": (None, inner), "wx": (None, inner),
               "wdt": (None, inner), "conv_x": (None, inner),
               "A_log": (inner,), "dt_bias": (inner,), "D_skip": (inner,),
               "out_norm": (inner,), "w_out": (inner, None)}

    def spec(path, leaf):
        return by_leaf.get(path[0], (None,) * leaf.ndim)

    return {"inner": inner}, spec
