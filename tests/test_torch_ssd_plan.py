"""The SSD intra-chunk kernel's host-side rules, held on the CPU.

The kernel (``csrc/ssd_scan.cu``, ``ssd_tile_kernel``) splits each
(chunk, head) into y tiles of query rows and S_loc tiles of state rows,
one block each, laid out by ``ops.ssd_plan``.  The kernel runs only on a
card; here are checked:

* the planner at zamba2-7b's prefill shapes (L = 126 and 128, one to
  three chunks, H = 112, P = N = 64), at the smoke config's and at the
  128 limits: the y tiles cover every row once, the S_loc tiles every
  state row once, the grid order is the plan's, the shared
  memory fits a block (two blocks an SM at the path shapes, four in
  fact), and a shape above 128 raises;
* the partition itself: a torch emulation of the kernel's tiles (each y
  tile sums only over keys below its last row, in staged key blocks and
  column chunks of 64, 32 and 16 keys, none of them wholly above the
  diagonal; S_loc built by slices of N with w_end folded into B) against
  the plain version ``ref.ssd_intra_chunk_ref`` and the JAX package's
  Pallas ``ssd_intra_chunk`` in interpret mode.

Inputs come from numpy with a seed.  Tolerance: float32 rtol = atol =
2e-4 (the emulation sums in another order than both references).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_intra_chunk as jssd_intra
from repro_torch.common.config import get_config
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-4, atol=2e-4)
N_SM = 132                                   # an H100's SMs

# zamba2-7b: 112 heads of 64, state 64, chunk 128; its prefills of 126,
# 200 and 383 tokens run as 1 chunk of 126, 2 and 3 chunks of 128
ZAMBA = [(126, 1), (128, 1), (128, 2), (128, 3)]


def _tile(plan, rank):
    """The tile at grid rank ``rank`` (blocks ``rank * H * BC`` on), as
    the kernel decodes it: ("y", i), rows [i tr, i tr + tr), or ("s", j),
    state rows [j ns, j ns + ns)."""
    if plan.n_heavy <= rank < plan.n_heavy + plan.n_s:
        return "s", rank - plan.n_heavy
    if rank < plan.n_heavy:
        return "y", plan.n_y - 1 - rank
    return "y", plan.n_y - 1 - (rank - plan.n_s)


def _tiles(plan):
    """The plan's tiles of one (chunk, head) in grid order."""
    return [_tile(plan, r) for r in range(plan.n_y + plan.n_s)]


def _check_cover(plan, L, P, N, H, BC):
    """Every row and state row once; the grid order: n_heavy y tiles
    heaviest first, the S_loc tiles, the other y tiles heaviest first."""
    tiles = _tiles(plan)
    rows = [r for k, i in tiles if k == "y"
            for r in range(i * plan.tr, min((i + 1) * plan.tr, L))]
    assert sorted(rows) == list(range(L))            # every row once
    states = [n for k, j in tiles if k == "s"
              for n in range(j * plan.ns, min((j + 1) * plan.ns, N))]
    assert sorted(states) == list(range(N))          # every state row once
    assert plan.n_y == -(-L // plan.tr) and plan.n_s == -(-N // plan.ns)
    assert plan.blocks == (plan.n_y + plan.n_s) * H * BC
    assert plan.threads == 4 * plan.tr
    assert plan.smem <= ops.SMEM_LIMIT == 232_448
    ys = [i for k, i in tiles if k == "y"]
    assert ys == sorted(ys, reverse=True)            # heaviest y first
    assert [k for k, _ in tiles] == (["y"] * plan.n_heavy + ["s"] * plan.n_s
                                     + ["y"] * (plan.n_y - plan.n_heavy))


@pytest.mark.parametrize("L,nc", ZAMBA)
def test_plan_at_zamba2_7b(L, nc):
    cfg = get_config("zamba2-7b")
    P, N = cfg.mamba_head_dim, cfg.ssm_state
    H = cfg.d_model * cfg.mamba_expand // P
    assert (H, P, N, cfg.mamba_chunk) == (112, 64, 64, 128)
    plan = ops.ssd_plan(L, P, N, H, nc, N_SM)
    _check_cover(plan, L, P, N, H, nc)
    assert plan.tr == ops.SSD_PLAN_ROWS == 32 and plan.n_y == 4
    assert plan.blocks_per_sm >= 2                   # two blocks an SM
    assert plan.threads == 128
    if nc < 3:
        # up to three waves: one S_loc tile of all 64 state rows behind the
        # two heaviest y tiles; its two staged key blocks hold three
        # blocks an SM
        assert (plan.ns, plan.n_s, plan.n_heavy) == (64, 1, 2)
        assert plan.blocks_per_sm == 3
        assert plan.blocks <= ops.SSD_WIDE_WAVES * 3 * N_SM
    else:
        # past them: two S_loc tiles of 32 rows first, and 128 threads at
        # 128 registers: four blocks an SM
        assert (plan.ns, plan.n_s, plan.n_heavy) == (32, 2, 0)
        assert plan.blocks_per_sm == 4


@pytest.mark.parametrize("L,P,N,H,BC", [(8, 16, 16, 8, 4),      # smoke
                                        (128, 128, 128, 4, 1),  # the limits
                                        (40, 48, 24, 5, 3),     # ragged
                                        (1, 1, 1, 1, 1)])
def test_plan_covers_and_fits(L, P, N, H, BC):
    plan = ops.ssd_plan(L, P, N, H, BC, N_SM)
    _check_cover(plan, L, P, N, H, BC)
    assert plan.blocks_per_sm >= 1


def test_plan_at_smoke_config():
    cfg = get_config("zamba2-7b", smoke=True)
    P, N = cfg.mamba_head_dim, cfg.ssm_state
    H = cfg.d_model * cfg.mamba_expand // P
    plan = ops.ssd_plan(cfg.mamba_chunk, P, N, H, 4, N_SM)
    assert (plan.n_y, plan.n_s) == (1, 1)
    _check_cover(plan, cfg.mamba_chunk, P, N, H, 4)


@pytest.mark.parametrize("L,P,N", [(129, 64, 64), (128, 129, 64),
                                   (128, 64, 129), (0, 64, 64)])
def test_plan_raises_outside_the_limits(L, P, N):
    with pytest.raises(ValueError, match="ssd_intra_chunk"):
        ops.ssd_plan(L, P, N, 112, 1, N_SM)


@pytest.mark.parametrize("tr,ns", [(24, 32), (32, 24), (32, 128), (16, 4)])
def test_layout_raises_on_a_split_the_kernel_lacks(tr, ns):
    with pytest.raises(ValueError, match="no kernel"):
        ops.ssd_layout(128, 64, 64, tr, ns)


def test_layout_tiles_of_every_split_and_order_cover():
    for tr in ops.SSD_TILE_ROWS:
        for rms in ops.SSD_STATE_ROWS_A_THREAD:
            for nh in range(-(-126 // tr) + 1):
                plan = ops.ssd_layout(126, 64, 64, tr, tr // 4 * rms, 112, 1,
                                      n_heavy=nh)
                _check_cover(plan, 126, 64, 64, 112, 1)
    with pytest.raises(ValueError, match="n_heavy"):
        ops.ssd_layout(126, 64, 64, 32, 32, n_heavy=5)


def _key_chunks(S):
    """The kernel's column chunks of a y tile's scores over keys [0, S):
    staged key blocks of ``SSD_KEY_BLOCK``, each cut into chunks of 64,
    32 and 16 keys up to its length rounded up to 16."""
    KB = ops.SSD_KEY_BLOCK
    for k0 in range(0, S, KB):
        n16, c0 = -(-min(KB, S - k0) // 16) * 16, 0
        while c0 < n16:
            w = 64 if n16 - c0 >= 64 else 32 if n16 - c0 >= 32 else 16
            yield k0 + c0, w
            c0 += w


def emulate(x, Bm, Cm, dt, A_log, plan):
    """The kernel's tile partition in torch, float32: every tile of every
    (batch, chunk, head), as its block computes it."""
    B, nc, L, H, P = x.shape
    N = Bm.shape[-1]
    KB = ops.SSD_KEY_BLOCK
    x, Bm, Cm, dt = (t.float() for t in (x, Bm, Cm, dt))
    y = torch.full((B, nc, L, H, P), float("nan"))
    s_loc = torch.full((B, nc, H, N, P), float("nan"))
    lam = torch.full((B, nc, H), float("nan"))
    for b in range(B):
        for c in range(nc):
            for h in range(H):
                a = -torch.exp(A_log[h].float())
                cum = torch.cumsum(dt[b, c, :, h] * a, 0)
                for kind, i in _tiles(plan):
                    if kind == "s":
                        n0, n1 = i * plan.ns, min((i + 1) * plan.ns, N)
                        w_end = torch.exp(cum[-1] - cum) * dt[b, c, :, h]
                        acc = torch.zeros(n1 - n0, P)
                        for k0 in range(0, L, KB):
                            k1 = min(k0 + KB, L)
                            wb = Bm[b, c, k0:k1, n0:n1] * w_end[k0:k1, None]
                            acc += wb.T @ x[b, c, k0:k1, h]
                        s_loc[b, c, h, n0:n1] = acc
                        if i == 0:
                            lam[b, c, h] = torch.exp(cum[-1])
                        continue
                    t0, t1 = i * plan.tr, min((i + 1) * plan.tr, L)
                    S = t1                      # keys below the last row
                    t = torch.arange(t0, t1)
                    acc = torch.zeros(t1 - t0, P)
                    for s0, w in _key_chunks(S):
                        # no chunk lies wholly above the tile's rows
                        assert s0 <= t1 - 1
                        sk = torch.arange(s0, min(s0 + w, S))
                        g = Cm[b, c, t0:t1] @ Bm[b, c, sk].T
                        m = g * torch.exp(cum[t][:, None] - cum[sk][None])
                        m = m * dt[b, c, sk, h][None]
                        m = torch.where(sk[None] <= t[:, None], m,
                                        torch.zeros(()))
                        acc += m @ x[b, c, sk, h]
                    y[b, c, t0:t1, h] = acc
    return y, s_loc, lam


def _inputs(rng, B, nc, L, H, P, N):
    f = np.float32
    x = rng.standard_normal((B, nc, L, H, P)).astype(f)
    Bm = (0.5 * rng.standard_normal((B, nc, L, N))).astype(f)
    Cm = (0.5 * rng.standard_normal((B, nc, L, N))).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, nc, L, H)) - 1.0)).astype(f)
    A_log = (0.5 * rng.standard_normal(H)).astype(f)
    return x, Bm, Cm, dt, A_log


@pytest.mark.parametrize("B,nc,L,H,P,N", [(2, 2, 8, 8, 16, 16),     # smoke
                                          (1, 1, 40, 2, 12, 24),    # ragged
                                          (1, 1, 100, 1, 8, 8),     # 2 blocks
                                          (1, 1, 128, 1, 4, 72)])   # 3 S tiles
def test_tile_partition_matches_plain_and_pallas(B, nc, L, H, P, N):
    args = _inputs(np.random.default_rng(L + N), B, nc, L, H, P, N)
    targs = [torch.from_numpy(a) for a in args]
    plan = ops.ssd_plan(L, P, N, H, B * nc, N_SM)
    got = emulate(*targs, plan)
    want = ref.ssd_intra_chunk_ref(*targs)
    pallas = jssd_intra(*map(jnp.asarray, args), interpret=True)
    for g, w, p in zip(got, want, pallas):
        assert bool(torch.isfinite(g).all())         # every output written
        np.testing.assert_allclose(g.numpy(), w.numpy(), **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(p), **TOL)


def test_reset_launches_clears_the_ssd_shape_counts():
    for name, counts in ops.SHAPE_LAUNCHES.items():
        counts[(1, 3, 128)] = 81
        ops.LAUNCHES[name] = 81
    ops.reset_launches()
    assert all(counts == {} for counts in ops.SHAPE_LAUNCHES.values())
    assert all(v == 0 for v in ops.LAUNCHES.values())
