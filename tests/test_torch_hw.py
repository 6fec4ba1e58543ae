"""``repro_torch.common.hw`` is the one home of the H100 figures: the
kernel planners read their limits from it with the values they had, and
their plans are unchanged at every shape the planner tests use
(``tests/test_torch_ssd_plan.py``, ``tests/test_torch_slstm_plan.py``)."""

import dataclasses
import hashlib

import pytest

from repro_torch.common import hw
from repro_torch.common.config import get_config
from repro_torch.kernels import ops

N_SM = 132


def test_planner_limits_come_from_hw_unchanged():
    h = hw.H100_SXM
    assert (ops.SMEM_LIMIT, ops.SM_SMEM, ops.SMEM_RESERVED,
            ops.SM_REGISTERS, ops.SLSTM_MAX_CLUSTER) == (
        232448, 233472, 1024, 65536, 16)
    assert (ops.SMEM_LIMIT, ops.SM_SMEM, ops.SMEM_RESERVED,
            ops.SM_REGISTERS, ops.SLSTM_MAX_CLUSTER) == (
        h.smem_block, h.smem_sm, h.smem_reserved, h.registers_sm,
        h.max_cluster)
    assert ops.MAX_GRID == h.max_grid == (2**31 - 1, 65535, 65535)
    assert (h.peak_flops_f32, h.peak_flops_bf16, h.hbm_bandwidth,
            h.sms) == (67e12, 989e12, 3.35e12, 132)
    assert hw.PEAK_FLOPS == {"float32": 67e12, "bfloat16": 989e12}


def test_bound_is_the_larger_of_bytes_and_operations():
    assert hw.bound_s(3.35e12, 1.0) == (1.0, "bytes")
    assert hw.bound_s(1.0, 67e12) == (1.0, "operations")
    assert hw.bound_s(1.0, 989e12, "bfloat16") == (1.0, "operations")
    t = hw.roofline_terms(989e12, 3.35e12 / 2, 0.0)
    assert t["dominant"] == "compute" and t["roofline_s"] == 1.0


# the shapes of the planner tests
_ZAMBA = [(L, 64, 64, 112, nc, N_SM)
          for L, nc in [(126, 1), (128, 1), (128, 2), (128, 3)]]
_SSD = _ZAMBA + [(L, P, N, H, BC, N_SM) for L, P, N, H, BC in [
    (8, 16, 16, 8, 4), (128, 128, 128, 4, 1), (40, 48, 24, 5, 3),
    (1, 1, 1, 1, 1)]]
_EMULATED = [(L, P, N, H, B * nc, N_SM) for B, nc, L, H, P, N in [
    (2, 2, 8, 8, 16, 16), (1, 1, 40, 2, 12, 24), (1, 1, 100, 1, 8, 8),
    (1, 1, 128, 1, 4, 72)]]
_LAYOUTS = [(126, 64, 64, tr, tr // 4 * rms, 112, 1, nh)
            for tr in ops.SSD_TILE_ROWS
            for rms in ops.SSD_STATE_ROWS_A_THREAD
            for nh in range(-(-126 // tr) + 1)]
_PLANNED = sorted({c * u for c in (1, 2, 4, 8, 16) for u in range(2, 33, 2)
                   if c * u % 8 == 0})
_SLSTM = ([(1, 4, 512), (4, 4, 512), (9, 4, 512), (2, 4, 16)]
          + [(B, 4, hd) for hd in _PLANNED for B in (1, 3, 4, 17)]
          + [(2, 4, 16), (1, 2, 48), (1, 1, 128)])

#: every plan at those shapes, hashed before the limits moved to hw
_DIGEST = "1efd7487ef312ec6fa7377c94f4a269f1cd824ebadd22c039f16a6f79b89a727"


def _smoke_ssd():
    c = get_config("zamba2-7b", smoke=True)
    P, N = c.mamba_head_dim, c.ssm_state
    return (c.mamba_chunk, P, N, c.d_model * c.mamba_expand // P, 4, N_SM)


def test_planners_unchanged_at_every_tested_shape():
    rows = [("ssd_plan", s, dataclasses.astuple(ops.ssd_plan(*s)))
            for s in _SSD + [_smoke_ssd()] + _EMULATED]
    rows += [("ssd_layout", s,
              dataclasses.astuple(ops.ssd_layout(*s[:7], n_heavy=s[7])))
             for s in _LAYOUTS]
    rows += [("slstm_plan", s, dataclasses.astuple(ops.slstm_plan(*s)))
             for s in _SLSTM]
    assert len(rows) == 182
    text = "\n".join(repr(r) for r in rows)
    assert hashlib.sha256(text.encode()).hexdigest() == _DIGEST
    # the served shapes, spelled out
    plans = {r[1]: r[2] for r in rows}
    assert plans[(126, 64, 64, 112, 1, N_SM)] == (
        32, 4, 64, 1, 2, 128, 70656, 560, 3)
    assert plans[(128, 64, 64, 112, 3, N_SM)] == (
        32, 4, 32, 2, 0, 128, 54784, 2016, 4)
    assert plans[(1, 4, 512)] == (16, 32, 512, 12, 4, 1, 202128)
    assert plans[(4, 4, 512)] == (16, 32, 512, 12, 4, 4, 218640)


@pytest.mark.parametrize("error,call", [
    (ops.NoPlanError, lambda: ops.ssd_plan(129, 64, 64, 112, 1, N_SM)),
    (ops.NoPlanError, lambda: ops.slstm_plan(1, 1, 1024)),
    (ops.ClusterError, lambda: ops.slstm_plan(1, 1, 136)),
    (ops.GridError, lambda: ops.check_grid("x", (1, 65536, 1))),
    (ops.NoPlanError, lambda: ops.flash_plan(96)),
])
def test_planner_errors_are_typed_value_errors(error, call):
    with pytest.raises(error) as info:
        call()
    assert isinstance(info.value, ValueError)
