"""The launch plan of MLA's paged decode kernel (``kernels.ops``), here on
the CPU: one block an SM within the H100's shared memory, a grid within
CUDA's extents, splits that each keep the fewest keys, the split
workspace the wrapper allocates, and a plan that comes from static
shapes alone (a CUDA graph replays it whatever the lengths)."""

import inspect

import pytest
import torch

from repro_torch.common.hw import H100_SXM
from repro_torch.kernels import ops

R, ROPE = ops.MLA_RANK, ops.MLA_ROPE

#: (B, H, n_max, page_size): chip_smoke's phase-9 tick, dots-vlm1.ocr's,
#: one row, a wide batch, fewer heads, larger pages, and head counts
#: whose last block holds 16 (dots-vlm1-mt's smoke widths have 16)
SHAPES = [(4, 128, 16, 16), (64, 128, 200, 16), (1, 32, 1, 16),
          (256, 128, 256, 16), (64, 64, 200, 16), (8, 128, 40, 64),
          (4, 16, 16, 16), (16, 48, 64, 16)]


def _meta(B, H, n_max, ps):
    def t(*shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")
    P = B * n_max + 1
    return (t(B, H, R), t(B, H, ROPE), t(P, ps, R), t(P, ps, ROPE),
            t(B, n_max, dtype=torch.int32), t(B, dtype=torch.int32))


def _plan(B, H, n_max, ps, n_sm=H100_SXM.sms):
    n_split = ops.mla_splits(n_max * ps, B, H, n_sm)
    return n_split, ops.mla_grid(B, H, n_split), \
        ops._mla_ws_bytes(B, H, R, n_split)


def test_mla_block_fits_one_an_sm():
    assert ops.MLA_THREADS <= 1024
    assert ops.MLA_SMEM <= H100_SXM.smem_block == 232_448
    per_block = ops.MLA_SMEM + H100_SXM.smem_reserved
    assert per_block * ops.MLA_BLOCKS_PER_SM <= H100_SXM.smem_sm
    assert per_block * (ops.MLA_BLOCKS_PER_SM + 1) > H100_SXM.smem_sm


@pytest.mark.parametrize("B,H,n_max,ps", SHAPES)
def test_mla_grid_within_the_card(B, H, n_max, ps):
    n_split, grid, _ = _plan(B, H, n_max, ps)
    assert grid == (n_split, -(-H // ops.MLA_HEADS_PER_BLOCK), B)
    assert all(1 <= n <= most for n, most in zip(grid, ops.MAX_GRID))
    ops.check_grid("paged_mla_decode", grid)


@pytest.mark.parametrize("n_sm", [132, 114, 78])
@pytest.mark.parametrize("B,H,n_max,ps", SHAPES)
def test_mla_splits_each_keep_the_fewest_keys(B, H, n_max, ps, n_sm):
    T = n_max * ps
    n_split = ops.mla_splits(T, B, H, n_sm)
    assert 1 <= n_split <= ops.MLA_MAX_SPLITS
    if n_split > 1:
        # a full row's shortest split, by the kernel's rule
        assert min(b - a for a, b in (ops.split_range(T, n_split, i)
                                      for i in range(n_split))) \
            >= ops.MLA_MIN_KEYS


@pytest.mark.parametrize("B,H,n_max,ps", SHAPES)
def test_mla_workspace_is_the_splits_partials(B, H, n_max, ps):
    n_split, _, ws = _plan(B, H, n_max, ps)
    assert ws == (0 if n_split == 1 else 4 * B * H * n_split * (R + 2))
    seen = []
    ops.WORK_HOOKS.append(lambda *a: seen.append(a))
    try:
        out = ops.paged_mla_decode(*_meta(B, H, n_max, ps), scale=0.1)
    finally:
        ops.WORK_HOOKS.pop()
    assert out.shape == (B, H, R)
    # the peak beyond the call's start: its output and the workspace
    assert seen == [("paged_mla_decode", 2.0 * B * H * n_max * ps
                     * (2 * R + ROPE), seen[0][2], 4 * B * H * R + ws)]


def test_mla_ocr_workspace_within_a_tenth_of_a_gigabyte_of_before():
    """dots-vlm1.ocr's tick (64 rows, tables of 200 pages of 16): the
    workspace grows by less than 0.1 GB over the first design's five
    splits (84 MB)."""
    _, _, ws = _plan(64, 128, 200, 16)
    before = 4 * 64 * 128 * 5 * (R + 2)
    assert ws - before < 0.1e9


def test_mla_plan_reads_static_shapes_alone():
    """The planners take no lengths, and the wrapper plans on meta
    tensors, which hold no values: two calls at one shape report one
    plan."""
    for fn in (ops.mla_splits, ops.mla_grid, ops._mla_ws_bytes):
        assert "lengths" not in inspect.signature(fn).parameters
    seen = []
    ops.WORK_HOOKS.append(lambda *a: seen.append(a))
    try:
        for _ in range(2):
            ops.paged_mla_decode(*_meta(64, 128, 200, 16), scale=0.1)
    finally:
        ops.WORK_HOOKS.pop()
    assert len(seen) == 2 and seen[0] == seen[1]
    assert _plan(64, 128, 200, 16) == _plan(64, 128, 200, 16)


@pytest.mark.parametrize("H", [8, 24])
def test_mla_plan_refuses_heads_off_the_block(H):
    with pytest.raises(ops.NoPlanError, match="multiple of 16"):
        ops.paged_mla_decode(*_meta(4, H, 16, 16), scale=0.1)
