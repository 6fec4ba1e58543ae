"""MLA's absorbed paged decode kernel (``csrc/mla_decode.cu``) against its
plain version ``ref.paged_mla_decode_ref`` on the card, float32 at
DeepSeek-V3's widths (H = 128, r = 512, rope = 64, pages of 16):
dots-vlm1.ocr's tick, lengths at the edges of a page, a 32-key tile and
a split, a full table, junk table entries past a row's pages, the
one-split path, a CUDA graph replayed after the lengths and tables
changed in place, and 16 or 48 heads (a block's upper half absent); and
the kernel's own launch figures against the plan's.

Tolerance: float32 rtol = atol = 2e-4, as the other kernels' tests (the
kernel and the plain version sum in other orders).

Marked ``cuda``: they skip where no CUDA device is visible.  This file
imports no jax, so it runs on a machine with the card alone:

    python -m pytest -q -m cuda tests/test_torch_mla_cuda.py
"""

import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import ops, ref

H, R, ROPE, PS = 128, 512, 64, 16
SCALE = (128 + 64) ** -0.5
TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _inputs(dev, lens, n_max, seed=0, H=H):
    """Queries and a pool of len(lens) rows' pages (ids shuffled), each
    row's table entries past its pages junk (negative or past the
    pool)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    B = len(lens)
    P = B * n_max + 1
    q_lat = torch.randn(B, H, R, generator=g, device=dev)
    q_pe = torch.randn(B, H, ROPE, generator=g, device=dev)
    ckv = torch.randn(P, PS, R, generator=g, device=dev)
    kr = torch.randn(P, PS, ROPE, generator=g, device=dev)
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    tables = perm[:B * n_max].reshape(B, n_max).to(torch.int32)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    junk = torch.randint(-50, P + 50, (B, n_max), generator=g, device=dev,
                         dtype=torch.int32)
    owned = torch.arange(n_max, device=dev)[None] * PS < lengths[:, None]
    tables = torch.where(owned, tables, junk).contiguous()
    return q_lat, q_pe, ckv, kr, tables, lengths


def _close(args):
    got = ops.paged_mla_decode(*args, scale=SCALE)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.paged_mla_decode_ref(
        *args, scale=SCALE), **TOL)
    return got


def _ocr_tick():
    """dots-vlm1.ocr's tick as ``chip_smoke.py`` times it: its lengths
    and pages a row."""
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    return chip_smoke.mla_ocr_lengths(), chip_smoke.MLA_OCR_PAGES


def _n_split(n_max, B):
    return ops.mla_splits(n_max * PS, B, H, ops.sm_count(torch.device(
        "cuda")))


@pytest.mark.cuda
def test_cuda_mla_ocr_tick(cuda_device):
    _close(_inputs(cuda_device, *_ocr_tick()))


@pytest.mark.cuda
@pytest.mark.parametrize("edge", ["short", "page", "tile", "split"])
def test_cuda_mla_length_edges(cuda_device, edge):
    n_max = 40
    n_split = _n_split(n_max, 8)
    assert n_split > 1
    base = {"short": [0, 1, 2, n_split - 1, n_split, n_split + 1],
            "page": [PS - 1, PS, PS + 1, 7 * PS - 1, 7 * PS, 7 * PS + 1],
            "tile": [31, 32, 33, 95, 96, 97],
            # each split's share one or one and a half tiles, and a key off
            "split": [n_split * k + d for k in (32, 48) for d in (-1, 0, 1)]
            }[edge]
    lens = (base + [0, 1])[:8]
    _close(_inputs(cuda_device, lens, n_max, seed=len(edge)))


@pytest.mark.cuda
def test_cuda_mla_full_table_and_past_it(cuda_device):
    n_max = 24
    # a full table, one past it (clamped to the table), and junk around
    _close(_inputs(cuda_device, [n_max * PS, n_max * PS + 5, 3, 0], n_max,
                   seed=3))


@pytest.mark.cuda
def test_cuda_mla_one_split(cuda_device):
    n_max = 4
    assert _n_split(n_max, 4) == 1   # the block writes o itself
    _close(_inputs(cuda_device, [0, 1, 33, n_max * PS], n_max, seed=4))


@pytest.mark.cuda
def test_cuda_mla_graph_replay_follows_lengths_and_tables(cuda_device):
    """A graph captured over the call replays the same splits whatever
    the lengths: after new lengths and tables are copied in place, the
    replay equals the eager call bit for bit and the plain version within
    tolerance."""
    n_max = 64
    args = _inputs(cuda_device, [700, 0, 1, 33, 1023, 64, 5, 512], n_max)
    q_lat, q_pe, ckv, kr, tables, lengths = args
    _close(args)                          # eager first: sets the kernel up
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.paged_mla_decode(*args, scale=SCALE)
    new = _inputs(cuda_device, [0, 1024, 17, 300, 2, 999, 64, 65], n_max,
                  seed=7)
    tables.copy_(new[4])
    lengths.copy_(new[5])
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, ops.paged_mla_decode(*args, scale=SCALE))
    torch.testing.assert_close(out, ref.paged_mla_decode_ref(
        *args, scale=SCALE), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("heads", [16, 48])
def test_cuda_mla_half_block_of_heads(cuda_device, heads):
    """H % 32 == 16: the last block's upper 16 heads are absent, its
    warps idle; one split and several."""
    for n_max, lens in ((4, [0, 1, 33, 64]), (40, [639, 0, 97, 5, 640])):
        _close(_inputs(cuda_device, lens, n_max, seed=heads, H=heads))


@pytest.mark.cuda
def test_cuda_mla_info_is_the_plan(cuda_device):
    """The kernel's own threads, shared memory and blocks an SM are what
    ``kernels.ops`` plans with."""
    import ctypes

    from repro_torch.kernels import build

    info = (ctypes.c_int * 3)()
    assert build.load("mla_decode").paged_mla_decode_info(info) == 0
    assert tuple(info) == (ops.MLA_THREADS, ops.MLA_SMEM,
                           ops.MLA_BLOCKS_PER_SM)
