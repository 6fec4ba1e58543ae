"""Plain PyTorch versions of the hand-written kernels.

Each is the function its CUDA kernel computes, written with plain
tensor ops in float32: the CPU tests run them, the kernel wrappers in
``kernels.ops`` take them for CPU tensors, and ``chip_smoke.py`` holds
each kernel against them on the card.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        lengths=None, starts=None, dtype=torch.float32):
    """q: (B,S,H,D); k/v: (B,T,K,D). Plain softmax attention.  Optional
    per-row key bounds (B,): keys at or past ``lengths`` and below
    ``starts`` are masked.  Computed in ``dtype``, the output rounded to
    q's: float64 gives the exact attention of the inputs (``flips``)."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.to(dtype), k.to(dtype)) / math.sqrt(D)
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window and window > 0:
        mask &= kp > qp - window
    mask = mask[None, None].expand(B, H, S, T)
    if lengths is not None:
        mask = mask & (kp[None, None] < lengths.to(q.device)[:, None, None, None])
    if starts is not None:
        mask = mask & (kp[None, None] >= starts.to(q.device)[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # rows with every key masked produce 0 (matches the streaming kernel)
    p = torch.where(mask.any(-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhst,bthd->bshd", p, v.to(dtype)).to(q.dtype)


def flips(out, exact) -> float:
    """The share of a low-precision output's elements that differ from
    ``exact`` (the same function computed in float64, then rounded to
    out's dtype): how often an error crossed a rounding boundary."""
    return (out != exact).float().mean().item()


def decode_attention_ref(q, k, v, lengths, *, window=0, softcap=0.0):
    """q: (B,H,D) single query; k/v: (B,T,K,D); lengths: (B,) valid key
    count (keys at or past it are masked, and with ``window`` > 0 also
    keys below ``lengths - window``: a row of length n, its query at
    position n - 1, sees keys [max(0, n - w), n), the reference's mask
    ``kp > qp - w``)."""
    starts = (lengths.long() - window).clamp_min(0) if window > 0 else None
    out = flash_attention_ref(q[:, None], k, v, causal=False,
                              softcap=softcap, lengths=lengths,
                              starts=starts)
    return out[:, 0]


def paged_mla_decode_ref(q_lat, q_pe, ckv_pages, kr_pages, block_tables,
                         lengths, *, scale):
    """The absorbed latent decode step: q_lat (B,H,r) and q_pe (B,H,rope)
    of each row's query; the latent pools ckv_pages (P, page_size, r) and
    kr_pages (P, page_size, rope); block_tables (B, n_max) page ids
    (clamped into range); lengths (B,) live keys.  Scores
    ``scale * (q_lat . ckv + q_pe . kr)`` over the row's keys below its
    length, softmax in float32, and the weighted sum of ``ckv``: (B,H,r)
    in q_lat's dtype; a row with no live key gives 0."""
    B = q_lat.shape[0]
    P, ps = ckv_pages.shape[:2]
    n_max = block_tables.shape[1]
    tables = block_tables.long().clamp(0, P - 1)
    ckv = ckv_pages[tables].reshape(B, n_max * ps, -1).float()
    kr = kr_pages[tables].reshape(B, n_max * ps, -1).float()
    s = (torch.einsum("bhr,btr->bht", q_lat.float(), ckv)
         + torch.einsum("bhr,btr->bht", q_pe.float(), kr)) * scale
    live = torch.arange(n_max * ps, device=q_lat.device)[None] < \
        lengths.to(q_lat.device).long()[:, None]
    s = torch.where(live[:, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1) * live.any(-1)[:, None, None]
    return torch.einsum("bht,btr->bhr", p, ckv).to(q_lat.dtype)


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               *, window=0, softcap=0.0, tile=None):
    """q: (B,H,D); k_pages/v_pages: (n_pages, page_size, K, D);
    block_tables: (B, n_max) page ids; lengths: (B,) valid key counts.

    Gathers each row's pages (table entries clamped into range) into a
    contiguous (B, n_max*ps, K, D) view and defers to
    ``decode_attention_ref``; positions past ``lengths`` (and, with a
    ``window``, below ``lengths - window``) are masked.

    With a ``tile`` (p0, n_pages, s0, page_size) the pages are a rank's
    tile of a pool of ``n_pages`` pages of ``page_size`` slots: pages
    [p0, p0 + P) and slots [s0, s0 + ps) of each, the tables the pool's
    page ids; key t of a row lies on page ``tables[b, t // page_size]``
    (clamped into the pool) at slot ``t % page_size``, and the tile holds
    it only where both fall in its ranges.  The function is then the
    attention over the keys the tile holds, returned with their
    log-sum-exp (B, H) in float32: (o, lse), -inf and o = 0 where the
    tile holds no live key of a row.  Softmax partials of tiles that
    cover the pool combine to the untiled function.
    """
    if tile is None:
        B = q.shape[0]
        P, ps, K, D = k_pages.shape
        n_max = block_tables.shape[1]
        tables = block_tables.long().clamp(0, P - 1)
        k = k_pages[tables].reshape(B, n_max * ps, K, D)
        v = v_pages[tables].reshape(B, n_max * ps, K, D)
        return decode_attention_ref(q, k, v, lengths, window=window,
                                    softcap=softcap)
    P, ps_loc, K, D = k_pages.shape
    p0, n_pages, s0, ps = tile
    B, H, _ = q.shape
    n_max = block_tables.shape[1]
    dev = q.device
    page = block_tables.long().clamp(0, n_pages - 1) - p0      # (B, n_max)
    held = (page >= 0) & (page < P)
    local = page.clamp(0, P - 1)
    k = k_pages[local].reshape(B, n_max * ps_loc, K, D).float()
    v = v_pages[local].reshape(B, n_max * ps_loc, K, D).float()
    t = (torch.arange(n_max, device=dev)[:, None] * ps + s0
         + torch.arange(ps_loc, device=dev)[None]).reshape(-1)  # (n_max*ps,)
    n = lengths.long()[:, None]
    valid = (t[None] < n) & held.repeat_interleave(ps_loc, dim=1)
    if window and window > 0:
        valid &= t[None] >= n - window
    G = H // K
    s = torch.einsum("bhd,bthd->bht", q.float(),
                     k.repeat_interleave(G, dim=2)) / math.sqrt(D)
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    s = torch.where(valid[:, None], s, torch.full_like(s, -math.inf))
    lse = torch.logsumexp(s, dim=-1)                           # (B, H)
    live = torch.isfinite(lse)
    p = torch.exp(s - torch.where(live, lse, torch.zeros_like(lse))[..., None])
    o = torch.einsum("bht,bthd->bhd", p, v.repeat_interleave(G, dim=2))
    return o.to(q.dtype), lse


def ssd_intra_chunk_ref(x, Bm, Cm, dt, A_log, *, dtype=torch.float32):
    """Mamba2 SSD, the intra-chunk part.  x: (B,nc,L,H,P); Bm/Cm:
    (B,nc,L,N); dt: (B,nc,L,H) post-softplus; A_log: (H,).  The math is
    in ``dtype`` (float64 gives the yardstick the float32 results are
    weighed against).

    Returns, all in ``dtype``: y_intra (B,nc,L,H,P) with
    ``y[t] = sum_{s<=t} C_t.B_s exp(cum_t - cum_s) dt_s x_s``; S_loc
    (B,nc,H,N,P), the chunk's outgoing state
    ``sum_s exp(cum_L - cum_s) dt_s B_s (x) x_s``; Lam (B,nc,H), the
    chunk's decay ``exp(sum_s dt_s a)``, where ``a = -exp(A_log)`` and
    ``cum`` is the running sum of ``dt a`` within the chunk."""
    x, Bm, Cm, dt = (t.to(dtype) for t in (x, Bm, Cm, dt))
    L = x.shape[2]
    dA = dt * -torch.exp(A_log.to(dtype))                 # (B,nc,L,H)
    cum = torch.cumsum(dA, dim=2)
    G = torch.einsum("bcln,bcmn->bclm", Cm, Bm)           # t=l, s=m
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    causal = torch.ones(L, L, dtype=torch.bool, device=x.device).tril()
    M = torch.where(causal[None, None, :, :, None],
                    G[..., None] * decay * dt[:, :, None, :, :],
                    torch.zeros((), dtype=dtype, device=x.device))
    y = torch.einsum("bclmh,bcmhp->bclhp", M, x)
    w_end = torch.exp(cum[:, :, -1:, :] - cum) * dt       # (B,nc,L,H)
    S_loc = torch.einsum("bcln,bclh,bclhp->bchnp", Bm, w_end, x)
    Lam = torch.exp(dA.sum(dim=2))
    return y, S_loc, Lam


def ssd_scan_ref(x, Bm, Cm, dt, A_log, *, initial_state=None,
                 dtype=torch.float32):
    """Mamba2 SSD (no D skip) as the plain step-by-step recurrence, the
    function ``ops.ssd_chunked`` computes chunk by chunk: with a =
    -exp(A_log), ``h_t = exp(dt_t a) h_{t-1} + dt_t B_t (x) x_t`` and
    ``y_t = C_t . h_t``.  x: (B,S,H,P); Bm/Cm: (B,S,N); dt: (B,S,H)
    post-softplus; initial_state: None (zeros) or (B,H,N,P).  The math is
    in ``dtype``.  Returns (y (B,S,H,P) in x's dtype, or in ``dtype`` where
    that is not float32; final state (B,H,N,P) in ``dtype``)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    xs, Bs, Cs, dts = (t.to(dtype) for t in (x, Bm, Cm, dt))
    decay = torch.exp(dts * -torch.exp(A_log.to(dtype)))  # (B,S,H)
    h = (torch.zeros((B, H, N, P), dtype=dtype, device=x.device)
         if initial_state is None else initial_state.to(dtype))
    ys = []
    for t in range(S):
        h = (h * decay[:, t, :, None, None]
             + torch.einsum("bn,bh,bhp->bhnp", Bs[:, t], dts[:, t], xs[:, t]))
        ys.append(torch.einsum("bn,bhnp->bhp", Cs[:, t], h))
    y = torch.stack(ys, dim=1)
    return y.to(x.dtype if dtype == torch.float32 else dtype), h


def slstm_initial_state(B, d, device):
    """The sLSTM cell's fresh state (c, n, h, m): zeros, with n = 1e-6."""
    z = torch.zeros(B, d, device=device)
    return z, z + 1e-6, z.clone(), z.clone()


def slstm_scan_ref(pre, R, state=None):
    """The sLSTM recurrence.  pre: (B,S,4,d) gate pre-activations (gate
    order i, f, z, o); R: (4,H,hd,hd) block-diagonal recurrent weights,
    H*hd = d; state: None (fresh) or (c, n, h, m), each (B,d).

    Per step, with rec_g = h R_g (per head):
      gi = pre_i + rec_i;  gf = pre_f + rec_f
      gz = tanh(pre_z + rec_z);  go = sigmoid(pre_o + rec_o)
      m' = max(logsigmoid(gf) + m, gi)
      c = exp(logsigmoid(gf) + m - m') c + exp(gi - m') gz
      n = exp(logsigmoid(gf) + m - m') n + exp(gi - m')
      h = go c / max(n, 1e-6)
    Returns (h over time (B,S,d) in pre's dtype, final (c, n, h, m)
    float32)."""
    B, S, _, d = pre.shape
    _, H, hd, _ = R.shape
    Rf, p = R.float(), pre.float()
    if state is None:
        state = slstm_initial_state(B, d, pre.device)
    c, n, h, m = (t.float() for t in state)
    hs = []
    for t in range(S):
        rec = torch.einsum("bhd,ghde->gbhe", h.reshape(B, H, hd),
                           Rf).reshape(4, B, d)
        gi = p[:, t, 0] + rec[0]
        gf = p[:, t, 1] + rec[1]
        gz = torch.tanh(p[:, t, 2] + rec[2])
        go = torch.sigmoid(p[:, t, 3] + rec[3])
        logf = F.logsigmoid(gf)
        m_new = torch.maximum(logf + m, gi)
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(gi - m_new)
        c = fp * c + ip * gz
        n = fp * n + ip
        h = go * c / torch.clamp(n, min=1e-6)
        m = m_new
        hs.append(h)
    return torch.stack(hs, dim=1).to(pre.dtype), (c, n, h, m)
