"""MLA's paged decode kernel (``csrc/mla_decode.cu``) emulated lane by lane
in numpy, here on the CPU, and held to ``ref.paged_mla_decode_ref``.

The kernel has no CPU mode, so this emulation is what checks its index
arithmetic without a card: the layout constants are read from the
source's ``constexpr`` lines, every thread's registers are a numpy axis
of ``NT``, a shuffle is a gather over the lane index, and each pointer
expression of the source is computed as the source writes it over flat
arrays.  Shared memory starts as NaN and the tile's scores,
probabilities and rescale factors go back to NaN before each tile, and
the split workspace starts as NaN: a read of anything the kernel did not
write shows in the output.  The block's phases (tile staging through
the lanes' slots, the register outer-product scores and their
reduce-scatter, the softmax warps, P.V, the one-split write or the
workspace, the merge's skip of empty splits, the masked upper half of a
block at H % 32 == 16) follow the source; the summation order within a
dot product does not, so the check is at the kernel tests' tolerance.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

SRC = Path(ops.__file__).resolve().parents[1] / "csrc" / "mla_decode.cu"
TOL = dict(rtol=2e-4, atol=2e-4)


def kernel_constants() -> dict:
    """The source's ``constexpr`` ints and floats, in order."""
    env: dict = {}
    text = SRC.read_text()
    for kind, name, expr in re.findall(
            r"constexpr (int|float) (\w+)\s*=\s*([^;]+);", text):
        if kind == "float":
            env[name] = float(expr.strip().rstrip("f"))
        else:
            env[name] = eval(" ".join(expr.split()).replace("/", "//"),
                             {}, dict(env))
    return env


K = kernel_constants()
R, RP, QW, Q4 = K["R"], K["RP"], K["QW"], K["Q4"]
assert QW == 4 * Q4 and Q4 % 8 == 0    # (1)'s 8 lanes split a row
HB, BK, NT, SS, PS = K["HB"], K["BK"], K["NT"], K["SS"], K["PS"]
NEG = np.float32(K["NEG_INF"])
TID = np.arange(NT)
LANE, WARP = TID & 31, TID >> 5


def _f4(idx):
    """A float index the source reads or writes as a float4: 16-byte
    aligned in a 16-byte-aligned buffer."""
    assert (np.asarray(idx) % 4 == 0).all()
    return idx


def _gather4(flat, idx):
    """The float4 at each float index of ``idx`` (shape idx.shape + (4,))."""
    return flat[np.asarray(idx)[..., None] + np.arange(4)]


class _Mem:
    """The kernel's arguments as flat float32 / int32 arrays, and its
    outputs: o, and the workspace (NaN, so an unwritten read shows)."""

    def __init__(self, q_lat, q_pe, ckv, kr, tables, lengths, n_split):
        self.B, self.H, _ = q_lat.shape
        self.P, self.ps, _ = ckv.shape
        self.n_max = tables.shape[1]
        self.q_lat = q_lat.numpy().reshape(-1)
        self.q_pe = q_pe.numpy().reshape(-1)
        self.ckv = ckv.numpy().reshape(-1)
        self.kr = kr.numpy().reshape(-1)
        self.tables = tables.numpy().reshape(-1)
        self.lengths = lengths.numpy()
        self.n_split = n_split
        self.o = np.full(self.B * self.H * R, np.nan, np.float32)
        n = self.B * self.H * n_split
        self.ws_acc = np.full(n * R, np.nan, np.float32)
        self.ws_ml = np.full(2 * n, np.nan, np.float32)


def _key_slot(m, b, kt, hi):
    """key_slot over the lanes' keys kt (one per lane)."""
    tab = m.tables[b * m.n_max + np.minimum(kt, hi - 1) // m.ps]
    page = np.clip(tab, 0, m.P - 1)
    return np.where(kt >= hi, 0, page * m.ps + kt % m.ps)


def _stage_tile(m, kbuf, dst, slot, nt):
    """stage_tile: thread tid copies float4 c4 of key t, the slot read
    from lane t of its warp; keys at or past nt zero-filled."""
    for j in range(BK * Q4 // NT):
        i = TID + NT * j
        t = i // Q4
        c4 = i - t * Q4
        s = slot[t]                        # __shfl_sync(slot, t)
        lat = c4 < R // 4
        src = np.where(lat, s * R + 4 * c4, s * RP + 4 * (c4 - R // 4))
        val = np.where(lat[:, None], _gather4(m.ckv, np.where(lat, src, 0)),
                       _gather4(m.kr, np.where(lat, 0, src)))
        val = np.where((t < nt)[:, None], val, np.float32(0))
        kbuf[_f4(dst + t * QW + 4 * c4)[:, None] + np.arange(4)] = val


def _scatter_round(v, kq, half, mask):
    up = (kq & mask) != 0
    send = np.where(up[:, None], v[:, :half], v[:, half:2 * half])
    keep = np.where(up[:, None], v[:, half:2 * half], v[:, :half])
    v = v.copy()
    v[:, :half] = keep + send[TID ^ mask]   # __shfl_xor_sync(send, mask)
    return v


def _block(m, split, hg, b, scale):
    """One block of paged_mla_decode_kernel: grid (split, hg, b)."""
    H, n_split = m.H, m.n_split
    h0 = hg * HB
    n = max(0, min(int(m.lengths[b]), m.n_max * m.ps))
    lo, hi = n * split // n_split, n * (split + 1) // n_split
    hq = (WARP >> 2) * 16
    cq = (WARP & 3) * 128 + 4 * LANE
    mine = hq < H - h0                     # the warp's heads exist
    row0 = b * H + h0
    cols = np.arange(4)
    if lo >= hi:
        if n_split == 1:
            for h in range(16):
                idx = ((row0 + hq + h) * R + cq)[mine]
                m.o[idx[:, None] + cols] = 0.0
        return

    smem_q = np.full(HB * QW, np.nan, np.float32)
    for j in range(HB * Q4 // NT):
        i = TID + NT * j
        h = i // Q4
        c4 = i - h * Q4
        lat = c4 < R // 4
        hh = np.minimum(h, H - h0 - 1)
        val = np.where(lat[:, None],
                       _gather4(m.q_lat, (row0 + hh) * R + 4 * np.where(
                           lat, c4, 0)),
                       _gather4(m.q_pe, (row0 + hh) * RP + 4 * np.where(
                           lat, 0, c4 - R // 4)))
        val = np.where((h < H - h0)[:, None], val, np.float32(0))
        smem_q[_f4(h * QW + 4 * c4)[:, None] + cols] = val
    kbuf = np.full(2 * BK * QW, np.nan, np.float32)
    _stage_tile(m, kbuf, 0, _key_slot(m, b, lo + np.arange(32), hi),
                min(BK, hi - lo))
    next_slot = _key_slot(m, b, lo + BK + np.arange(32), hi)

    kq = LANE & 7
    sh = (WARP >> 2) * 16 + (LANE >> 3) * 4
    st = (WARP & 3) * 8
    run_m = np.full((8, 4), NEG, np.float32)
    run_l = np.zeros((8, 4), np.float32)
    acc = np.zeros((NT, 16, 4), np.float32)
    live_w = 4 * np.arange(8) < H - h0
    q4 = smem_q.reshape(-1, 4)
    start, it = lo, 0
    while start < hi:
        nt = min(BK, hi - start)
        ks = (it & 1) * BK * QW
        if start + BK < hi:
            _stage_tile(m, kbuf, ((it + 1) & 1) * BK * QW, next_slot,
                        min(BK, hi - start - BK))
            next_slot = _key_slot(m, b, start + 2 * BK + np.arange(32), hi)
        ss = np.full(HB * SS, np.nan, np.float32)
        pt = np.full(BK * PS, np.nan, np.float32)
        ah = np.full(HB, np.nan, np.float32)

        # (1) scores: heads sh + i, keys st + j, float4 columns kq + 8 c
        c = kq[:, None] + 8 * np.arange(Q4 // 8)
        k4 = kbuf[ks:ks + BK * QW].reshape(-1, 4)
        q = q4[(sh[:, None, None] + np.arange(4)[:, None]) * Q4
               + c[:, None, :]]
        k = k4[(st[:, None, None] + np.arange(8)[:, None]) * Q4
               + c[:, None, :]]
        s = np.einsum("nicx,njcx->nij", q, k, dtype=np.float32)
        v = s.reshape(NT, 32)
        v = _scatter_round(v, kq, 16, 4)
        v = _scatter_round(v, kq, 8, 2)
        v = _scatter_round(v, kq, 4, 1)
        t0 = st + 4 * (kq & 1)
        w = np.where(t0[:, None] + cols < nt, v[:, :4] * np.float32(scale),
                     NEG)
        idx = _f4((sh + (kq >> 1)) * SS + t0)[:, None] + cols
        assert len(np.unique(idx[mine])) == idx[mine].size
        ss[idx[mine]] = w[mine]

        # (2) the online softmax: warp w owns heads 4 w + i, lane = key
        for wp in np.flatnonzero(live_w):
            for i in range(4):
                sv = ss[(4 * wp + i) * SS + np.arange(32)]
                m_new = max(run_m[wp, i], sv.max())
                p = np.where(sv > 0.5 * NEG, np.exp(sv - m_new), 0)
                a = np.exp(run_m[wp, i] - m_new) \
                    if run_m[wp, i] > 0.5 * NEG else np.float32(0)
                run_l[wp, i] = run_l[wp, i] * a + p.sum(dtype=np.float32)
                run_m[wp, i] = m_new
                pt[_f4(np.arange(32) * PS + 4 * wp) + i] = p
                ah[_f4(4 * wp) + i] = a

        # (3) acc = acc * alpha + P.V over the tile's nt keys
        al = ah[_f4(hq)[:, None] + np.arange(16)]
        vals = kbuf[_f4(ks + np.arange(nt)[None, :, None] * QW
                        + cq[:, None, None]) + cols]
        probs = pt[_f4(np.arange(nt)[None, :, None] * PS
                       + hq[:, None, None]) + np.arange(16)]
        new = acc * al[:, :, None] + np.einsum("nth,ntc->nhc", probs, vals,
                                               dtype=np.float32)
        acc = np.where(mine[:, None, None], new, acc)
        start += BK
        it += 1

    if n_split == 1:
        lh = np.full(HB, np.nan, np.float32)
        lh[:4 * 8] = run_l.reshape(-1)
        for h in range(16):
            lt = lh[hq + h]
            with np.errstate(divide="ignore", invalid="ignore"):
                inv = np.where(lt > 0, np.float32(1) / lt, np.float32(0))
            idx = ((row0 + hq + h) * R + cq)[:, None] + cols
            m.o[idx[mine]] = (acc[:, h] * inv[:, None])[mine]
        return
    for h in range(16):
        e = (row0 + hq + h) * n_split + split
        m.ws_acc[((e * R + cq)[:, None] + cols)[mine]] = acc[mine, h]
    for wp in np.flatnonzero(live_w):
        for i in range(4):
            e = (row0 + 4 * wp + i) * n_split + split
            m.ws_ml[2 * e] = run_m[wp, i]
            m.ws_ml[2 * e + 1] = run_l[wp, i]


def _merge(m):
    """paged_mla_merge_kernel: one (head, row) a block, 128 threads of 4
    columns, only the splits that hold a key."""
    n_keys, n_split = m.n_max * m.ps, m.n_split
    c4 = np.arange(R // 4)
    for b in range(m.B):
        n = max(0, min(int(m.lengths[b]), n_keys))
        held = [s for s in range(n_split)
                if n * (s + 1) // n_split > n * s // n_split]
        for h in range(m.H):
            e0 = (b * m.H + h) * n_split
            mx = max([m.ws_ml[2 * (e0 + s)] for s in held], default=NEG)
            tot, acc = np.float32(0), np.zeros((R // 4, 4), np.float32)
            for s in held:
                w = np.exp(m.ws_ml[2 * (e0 + s)] - mx)
                tot += m.ws_ml[2 * (e0 + s) + 1] * w
                acc += _gather4(m.ws_acc, (e0 + s) * R + 4 * c4) * w
            inv = np.float32(1) / tot if tot > 0 else np.float32(0)
            m.o[(b * m.H + h) * R + 4 * c4[:, None] + np.arange(4)] = \
                acc * inv


def emulate(q_lat, q_pe, ckv, kr, tables, lengths, *, scale, n_split):
    """paged_mla_decode_fwd at n_split splits: grid (n_split,
    ceil(H / HB), B), then the merge where n_split > 1."""
    B, H, _ = q_lat.shape
    assert H % 16 == 0
    m = _Mem(q_lat, q_pe, ckv, kr, tables, lengths, n_split)
    for b in range(B):
        for hg in range(-(-H // HB)):
            for split in range(n_split):
                _block(m, split, hg, b, scale)
    if n_split > 1:
        _merge(m)
    return torch.from_numpy(m.o.reshape(B, H, R))


def _inputs(lens, n_max, H, ps=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    B = len(lens)
    P = B * n_max + 1
    q_lat = torch.randn(B, H, R, generator=g)
    q_pe = torch.randn(B, H, RP, generator=g)
    ckv = torch.randn(P, ps, R, generator=g)
    kr = torch.randn(P, ps, RP, generator=g)
    perm = torch.randperm(P - 1, generator=g) + 1
    tables = perm[:B * n_max].reshape(B, n_max).to(torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32)
    junk = torch.randint(-50, P + 50, (B, n_max), generator=g,
                         dtype=torch.int32)
    owned = torch.arange(n_max)[None] * ps < lengths[:, None]
    return q_lat, q_pe, ckv, kr, torch.where(owned, tables, junk), lengths


def test_mla_source_layout_is_the_plans():
    """The source's block (heads, keys a tile, threads, widths) and its
    shared memory are what ``kernels.ops`` plans with."""
    assert (HB, BK, NT) == (ops.MLA_HEADS_PER_BLOCK, ops.MLA_KEYS_PER_TILE,
                            ops.MLA_THREADS)
    assert (R, RP) == (ops.MLA_RANK, ops.MLA_ROPE)
    assert 4 * K["SMEM_FLOATS"] == ops.MLA_SMEM


@pytest.mark.parametrize("H,lens,n_max,n_split", [
    (32, [0, 1, 33, 80], 5, 1),            # one split: the block writes o
    (32, [0, 1, 33, 80, 85], 5, 3),        # past a full table, clamped
    (64, [2, 31, 32, 65, 97], 7, 7),       # short rows leave splits empty
    (16, [0, 40, 112], 7, 1),              # half a block: heads masked
    (16, [1, 64, 112], 7, 3),
    (48, [5, 96], 6, 2),                   # the second block half masked
])
def test_mla_emulated_kernel_matches_plain(H, lens, n_max, n_split):
    args = _inputs(lens, n_max, H, seed=H + n_split)
    scale = (128 + 64) ** -0.5
    got = emulate(*args, scale=scale, n_split=n_split)
    assert not torch.isnan(got).any()
    torch.testing.assert_close(
        got, ref.paged_mla_decode_ref(*args, scale=scale), **TOL)
