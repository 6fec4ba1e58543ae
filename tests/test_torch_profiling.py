"""``repro_torch.common.profiling.measure``: what it counts per rank.

* FLOPs on a rank's local tensors: a matmul whose weight's columns are
  sharded over a model axis of 2 counts half the global FLOPs on each
  rank, where ``FlopCounterMode`` counts the DTensor op at its global
  shape;
* the live-bytes tracker on a known sequence of allocations and frees,
  on the CPU and on meta tensors, arguments updated in place as aliases;
* a kernel wrapper's hook on meta tensors (the reference's einsum FLOPs,
  its output in the peak) and collectives by kind, in bytes and count.
"""

import pytest
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.common import sharding
from repro_torch.common.profiling import measure
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import fake_group


@pytest.fixture(scope="module")
def mesh12():
    with fake_group(2):
        yield sharding.local_mesh((1, 2), device="cpu")


def _dt(local, mesh, placements):
    return DTensor.from_local(local, mesh, placements, run_check=False)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_column_sharded_matmul_counts_local_flops(mesh12, device):
    x = _dt(torch.ones(8, 16, device=device), mesh12, [Replicate()] * 2)
    w = _dt(torch.ones(16, 16, device=device), mesh12,
            [Replicate(), Shard(1)])          # global (16, 32)
    assert tuple(w.shape) == (16, 32)
    y, rep = measure(lambda a, b: a @ b, x, w)
    assert tuple(y.to_local().shape) == (8, 16)
    assert rep.flops == 2 * 8 * 16 * 16       # half the global 2 * 8 * 16 * 32
    with FlopCounterMode(display=False) as fc:
        x @ w
    assert fc.get_total_flops() == 2 * 8 * 16 * 32
    assert rep.collective_bytes == 0 and rep.count_by_op == {}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_live_bytes_on_a_known_sequence(device):
    arg = torch.zeros(256, device=device)            # 1,024 B, updated
    other = torch.zeros(64, device=device)           # 256 B, read

    def step(a, b):
        t1 = torch.empty(1000, device=device)        # 4,000 B
        t2 = torch.empty(2000, device=device)        # 8,000 B: 12,000 live
        del t1                                       # 8,000 live
        t3 = torch.empty(500, device=device)         # 10,000 live
        del t2                                       # 2,000 live
        a.add_(1.0)                                  # in place: no new bytes
        return a, t3 + b.sum()                       # t3 + 2,000 out: 4,000

    _, rep = measure(step, arg, other)
    m = rep.memory
    assert m["argument_size_in_bytes"] == 1024 + 256
    assert m["temp_size_in_bytes"] == 12000
    assert m["output_size_in_bytes"] == 1024 + 2000
    assert m["alias_size_in_bytes"] == 1024
    assert m["total_bytes"] == 1024 + 256 + 12000


def test_meta_kernel_reports_flops_and_peak():
    B, S, H, K, D = 2, 64, 8, 2, 64
    q = torch.empty(B, S, H, D, device="meta")
    k = torch.empty(B, S, K, D, device="meta")
    with torch.no_grad():
        o, rep = measure(lambda a, b, c: ops.flash_attention(a, b, c), q, k,
                         k)
    assert o.device.type == "meta" and o.shape == q.shape
    assert rep.kernel_flops == {"flash_attention": 4 * B * H * S * S * D}
    assert rep.flops == 4 * B * H * S * S * D
    out = B * S * H * D * 4
    assert rep.memory["temp_size_in_bytes"] == out
    assert rep.bytes == (B * S * H * D + 2 * B * S * K * D) * 4 + out
    assert ops.WORK_HOOKS == []


def test_collectives_by_kind(mesh12):
    x = _dt(torch.zeros(4, 6, device="meta"), mesh12, [Replicate(), Shard(0)])

    def step(t):
        full = t.redistribute(mesh12, [Replicate(), Replicate()])   # gather
        loc = sharding.all_reduce(full.to_local(), mesh12, "model")
        return sharding.all_reduce(loc, mesh12, "data")             # 1 rank

    _, rep = measure(step, x)
    assert rep.count_by_op == {"all-gather": 1, "all-reduce": 1}
    assert rep.bytes_by_op == {"all-gather": 8 * 6 * 4,
                               "all-reduce": 8 * 6 * 4}
    assert rep.collective_bytes == 2 * 8 * 6 * 4
