"""The sLSTM kernels' host-side rules, held on the CPU.

The prefill kernel (``csrc/slstm_scan.cu``, ``slstm_prefill_kernel``)
runs each head on one thread-block cluster: ``ops.slstm_plan`` picks the
cluster size C, the units a block owns, the rows of R kept in registers
and in shared memory, and the shared-memory bytes.  The kernel runs
only on a card; here are checked:

* the planner at xlstm-1.3b's and the smoke config's shapes, its limits
  over every head dim it takes, and that it raises on one it cannot;
* the partition of one step: a torch emulation of the kernel's blocks,
  warps and lanes (each lane's k-parts in the kernel's slot order, then
  the warp's shuffle tree), stepped over a sequence, against the plain
  version ``ref.slstm_scan_ref`` and the JAX package's Pallas
  ``slstm_scan`` in interpret mode;
* ``ops.slstm_scan`` with R as four gate tensors equals R stacked, and
  ``layers.xlstm.slstm_apply`` hands the kernel its gate weights as they
  are, without stacking them.

Inputs come from numpy with a seed.  Tolerance: float32 2e-4 (the
emulation sums in another order than both references).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.slstm_scan import slstm_scan as jslstm_scan
from repro_torch.common.config import get_config
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-4, atol=2e-4)


def test_plan_at_xlstm_1_3b():
    """d = 2048, H = 4, hd = 512: a cluster of 16 blocks a head, 32 units
    (128 columns) a block at 512 threads; k rows [0, 384) of the block's
    R slice in 192 KiB of shared memory, [384, 512) in registers."""
    cfg = get_config("xlstm-1.3b")
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    p = ops.slstm_plan(1, H, hd)
    assert (p.cluster, p.units, p.threads) == (16, 32, 512)
    assert (p.smem_slots * 32, p.reg_rows) == (384, 128)
    # two mbarriers, R's shared slots, h, pre and the cell state
    assert p.smem == 16 + 192 * 1024 + 4 * (2 * 512 + 2 * 4 * 32 + 3 * 32)
    assert p.smem <= ops.SMEM_LIMIT == 232_448
    assert p.rows == 1
    # registers: 32 floats a thread hold the rest of the 256 KiB slice
    slice_floats = 4 * hd * p.units
    assert p.threads * 32 + p.smem_slots * 32 * 4 * p.units == slice_floats
    four = ops.slstm_plan(4, H, hd)
    assert four.rows == 4 and four.smem <= ops.SMEM_LIMIT
    assert ops.slstm_plan(9, H, hd).rows == 4      # three clusters a head


def test_plan_at_smoke():
    """The smoke config (d = 64, H = 4, hd = 16): one block a head, the
    whole R slice in registers."""
    cfg = get_config("xlstm-1.3b", smoke=True)
    H, hd = cfg.n_heads, cfg.d_model // cfg.n_heads
    p = ops.slstm_plan(2, H, hd)
    assert (hd, p.cluster, p.units, p.threads) == (16, 1, 16, 256)
    assert (p.smem_slots, p.reg_slots, p.rows) == (0, 1, 2)
    assert p.smem <= ops.SMEM_LIMIT


# every head dim a plan exists for: a multiple of 8 that is C x U, C a
# power of two up to 16 and U an even count of at most 32 units
PLANNED = sorted({c * u for c in (1, 2, 4, 8, 16) for u in range(2, 33, 2)
                  if c * u % 8 == 0})


@pytest.mark.parametrize("hd", PLANNED)
@pytest.mark.parametrize("B", [1, 3, 4, 17])
def test_plan_limits(hd, B):
    p = ops.slstm_plan(B, 4, hd)
    assert p.cluster * p.units == hd
    assert p.units % 2 == 0 and p.units <= 32
    assert p.cluster <= ops.SLSTM_MAX_CLUSTER
    assert p.cluster == 1 or hd // (p.cluster // 2) > 32   # the fewest
    assert p.threads == 16 * p.units <= 512
    assert (p.smem_slots + p.reg_slots) * 32 >= hd > (
        p.smem_slots + p.reg_slots - 1) * 32
    assert p.reg_slots <= ops.SLSTM_REG_SLOTS
    assert p.smem <= ops.SMEM_LIMIT
    assert p.rows == min(B, ops.SLSTM_MAX_ROWS)


@pytest.mark.parametrize("hd", [4, 12, 100, 136, 376, 520, 1024, 2048])
def test_plan_raises_on_a_head_dim_that_fits_no_plan(hd):
    assert hd not in PLANNED
    with pytest.raises(ValueError, match="head dim"):
        ops.slstm_plan(1, 4, hd)


def _tree_sum(parts):
    """The warp's shuffle tree over 32 lanes (dim 0): the lanes that differ
    in bit 4 first, then bits 3, 2, 1, 0."""
    for step in (16, 8, 4, 2, 1):
        parts = parts[:step] + parts[step:2 * step]
    return parts[0]


def cluster_step_emulation(pre, R, state, plan):
    """The prefill kernel's arithmetic in torch, one step at a time: block
    ``rank`` of head j owns units [rank * U, (rank + 1) * U); warp w of it
    the units 2w, 2w + 1 (four gate columns each); lane l sums h[k] R[k]
    over k = l + 32 j, slot by slot (shared slots, then register slots),
    and the warp adds its lanes' parts in the shuffle tree's order.  Every
    unit gets its recurrent sum from exactly one (block, warp)."""
    B, S, _, d = pre.shape
    H, hd = R.shape[1], R.shape[2]
    U, slots = plan.units, plan.smem_slots + plan.reg_slots
    HP = 32 * slots
    Rp = F.pad(R.float(), (0, 0, 0, HP - hd))            # (4,H,HP,hd)
    c, n, h, m = (t.float().clone() for t in state)
    ys = []
    for t in range(S):
        hp = F.pad(h.reshape(B, H, hd), (0, HP - hd))    # (B,H,HP)
        rec = torch.full((4, B, H, hd), float("nan"))
        for head in range(H):
            for rank in range(plan.cluster):
                for w in range(U // 2):
                    u = rank * U + 2 * w + torch.arange(2)   # the warp's units
                    parts = torch.zeros(32, B, 4, 2)
                    for j in range(slots):              # the kernel's order
                        k = torch.arange(32) + 32 * j
                        x = hp[:, head, k].T              # (32, B)
                        r = Rp[:, head, k][:, :, u]       # (4, 32, 2)
                        parts = parts + x[:, :, None, None] * r.permute(
                            1, 0, 2)[:, None]
                    rec[:, :, head, u] = _tree_sum(parts).permute(1, 0, 2)
        assert not bool(rec.isnan().any())               # every unit once
        rec = rec.reshape(4, B, d)
        p = pre[:, t].float()
        gi, gf = p[:, 0] + rec[0], p[:, 1] + rec[1]
        gz, go = torch.tanh(p[:, 2] + rec[2]), torch.sigmoid(p[:, 3] + rec[3])
        lf = F.logsigmoid(gf)
        m_new = torch.maximum(lf + m, gi)
        fp, ip = torch.exp(lf + m - m_new), torch.exp(gi - m_new)
        c, n = fp * c + ip * gz, fp * n + ip
        h, m = go * c / torch.clamp(n, min=1e-6), m_new
        ys.append(h)
    return torch.stack(ys, 1), (c, n, h, m)


def _inputs(rng, B, S, H, hd):
    pre = rng.standard_normal((B, S, 4, H * hd)).astype(np.float32)
    R = (0.3 * rng.standard_normal((4, H, hd, hd)) / np.sqrt(hd)
         ).astype(np.float32)
    d = H * hd
    state = (rng.standard_normal((B, d)), 1.0 + np.abs(
        rng.standard_normal((B, d))), np.tanh(rng.standard_normal((B, d))),
        rng.standard_normal((B, d)))
    return pre, R, tuple(torch.from_numpy(a.astype(np.float32))
                         for a in state)


@pytest.mark.parametrize("B,S,H,hd", [(2, 8, 4, 16),      # smoke: C = 1
                                      (1, 8, 2, 48),      # C = 2, ragged k
                                      (1, 4, 1, 128)])    # C = 4, 4 slots
def test_cluster_step_emulation_matches_plain_and_pallas(B, S, H, hd):
    pre, R, state = _inputs(np.random.default_rng(hd + S), B, S, H, hd)
    plan = ops.slstm_plan(B, H, hd)
    tp, tR = torch.from_numpy(pre), torch.from_numpy(R)
    fresh = ref.slstm_initial_state(B, H * hd, "cpu")
    y, fin = cluster_step_emulation(tp, tR, fresh, plan)
    want = jslstm_scan(jnp.asarray(pre), jnp.asarray(R), block_s=S,
                       interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(want), **TOL)
    y_ref, fin_ref = ref.slstm_scan_ref(tp, tR)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), **TOL)
    for a, b in zip(fin, fin_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)
    # from a given state (the decode step's case), against the plain one
    y2, fin2 = cluster_step_emulation(tp, tR, state, plan)
    y2_ref, fin2_ref = ref.slstm_scan_ref(tp, tR, state)
    np.testing.assert_allclose(y2.numpy(), y2_ref.numpy(), **TOL)
    for a, b in zip(fin2, fin2_ref):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("S", [1, 5])
def test_four_gate_R_equals_stacked_on_cpu(S):
    pre, R, state = _inputs(np.random.default_rng(S), 2, S, 4, 16)
    tp, tR = torch.from_numpy(pre), torch.from_numpy(R)
    for st in (None, state):
        y, fin = ops.slstm_scan(tp, tR, state=st)
        for four in (tuple(tR.unbind(0)), [g.clone() for g in tR]):
            y4, fin4 = ops.slstm_scan(tp, four, state=st)
            torch.testing.assert_close(y4, y, rtol=0, atol=0)
            for a, b in zip(fin4, fin):
                torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("R", [
    (torch.zeros(4, 16, 16),) * 3,                      # three gates
    (torch.zeros(4, 16, 16),) * 3 + (torch.zeros(4, 16, 8),),
    torch.zeros(3, 4, 16, 16)])
def test_bad_R_raises(R):
    with pytest.raises(ValueError, match="R"):
        ops.slstm_scan(torch.zeros(1, 2, 4, 64), R)


def test_slstm_apply_hands_over_the_gate_weights_unstacked(monkeypatch):
    """The layer passes (r_i, r_f, r_z, r_o) as they are: no stacked copy
    of R per call."""
    from repro_torch.common.pytree import tree_map
    from repro_torch.layers import xlstm as xl
    from repro_torch.models.api import build_model

    cfg = get_config("xlstm-1.3b", smoke=True)
    params = build_model(cfg, compute_dtype=torch.float32).init(
        torch.Generator().manual_seed(0), device="cpu")
    # the first group's sLSTM block (the stage stacks its groups' weights)
    p = tree_map(lambda v: v[0],
                 params["stages"]["xgroup"]["blocks"]["slstm"])
    seen = []
    real = ops.slstm_scan

    def spy(pre, R, *, state=None):
        seen.append(R)
        return real(pre, R, state=state)

    monkeypatch.setattr(xl.kops, "slstm_scan", spy)
    x = torch.randn(1, 3, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    xl.slstm_apply(p, x, cfg)
    (R,) = seen
    assert isinstance(R, tuple) and len(R) == 4
    assert all(a is p[f"r_{g}"] for a, g in zip(R, xl.GATES))
