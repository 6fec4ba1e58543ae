#!/usr/bin/env python3
"""Kernel experiments on one NVIDIA GPU, beside ``chip_smoke.py``.

    git show <commit>:src/repro_torch/csrc/slstm_scan.cu \\
        > build/ab/slstm_scan_old.cu
    python3 tools/kernel_sweep.py --old-slstm build/ab/slstm_scan_old.cu \\
        [--alt-slstm NAME=PATH ...] [--parts ab,prefill,barrier,paged]
    git show <commit>:src/repro_torch/csrc/ssd_scan.cu \\
        > build/ab/ssd_scan_old.cu
    python3 tools/kernel_sweep.py --parts ssd \\
        --old-ssd build/ab/ssd_scan_old.cu
    git show <commit>:src/repro_torch/csrc/flash_attention.cu \\
        > build/ab/flash_attention_old.cu
    python3 tools/kernel_sweep.py --parts flash_ab,flash \\
        --old-flash build/ab/flash_attention_old.cu
    git show <commit>:src/repro_torch/csrc/mla_decode.cu \\
        > build/ab/mla_decode_old.cu
    python3 tools/kernel_sweep.py --parts mla \\
        --old-mla build/ab/mla_decode_old.cu --old-mla-splits 5,4

From the root of a checkout, on a machine with the card and ``nvcc``:

1. sLSTM A/B: the earlier cooperative sLSTM source (its C interface
   ``slstm_scan_fwd(pre, R, y, c, n, m, hbuf, h_out, B, S, d, H, hd,
   dtype, stream)``, built with the package's nvcc flags into
   ``build/ab/``, called through a copy of its wrapper) against the
   package's ``ops.slstm_scan``, at xlstm-1.3b's decode step (S = 1
   from a state) and longest prompt (S = 383), float32, in turns (old,
   new, new, old): CUDA-event time over back-to-back wrapper calls, the
   kernel's device time under ``torch.profiler`` and the wrapper's host
   enqueue time; and the per-call R stack the layer no longer makes.
2. sLSTM prefill: device time over S (the slope is one step's time),
   over the register slots of the plan, and of each ``--alt-slstm``
   source (a variant with the package's C interface, built beside it)
   in turns with the package's, at S = 383.
3. The cluster barrier: one ``barrier.cluster`` arrive/wait a step over
   many steps, with and without a distributed-shared-memory store per
   thread before it, at cluster sizes 2-16: the latency floor of a
   sequential recurrence on one cluster.
4. Paged decode: device time over the split count at internvl2-1b's
   serve tick (4 rows, H = 14, K = 2, D = 64, pages of 16, 32 a row).
5. SSD (``--parts ssd``): an earlier SSD source (its C interface
   ``ssd_intra_chunk_fwd(x, Bm, Cm, dt, A_log, y, s_loc, lam, BC, L, H,
   P, N, dtype, stream)``, built into ``build/ab/``, called through a
   copy of its wrapper) against the package's ``ops.ssd_intra_chunk`` at
   zamba2-7b's three prefill calls ((B, nc, L) = (1, 1, 126), (1, 2,
   128), (1, 3, 128); H = 112, P = N = 64, float32), in turns (old, new,
   new, old): CUDA-event time, device time under ``torch.profiler`` and
   host enqueue time; then the package kernel's device time over its
   query rows a y tile (16, 32, 64), state rows an S_loc tile and (at the
   planner's rows) grid order at the three calls, each checked against
   the plain version; and each
   ``--alt-ssd`` source (a variant with the package's C interface) in
   turns with the package's kernel at the three calls.

6. Flash A/B (``--parts flash_ab``, ``--old-flash``): an earlier
   ``flash_attention.cu`` (the package's C interface) and each
   ``--alt-flash`` variant against the package's, all launched directly,
   in turns (old, new, variants, then back): the
   bfloat16 instance at internvl2-1b's prefill (D = 64, S = 267, H = 14,
   K = 2), zamba2-7b's shared attention (D = 112, S = 200, H = K = 32)
   and gemma2-9b's local layer (D = 256, S = 4,100, window 4,096,
   softcap 50), and the float32 instance at the first two as a control:
   device time, CUDA-event time, the distance from the plain version,
   in bfloat16 the share of outputs that differ from exact (float64)
   attention rounded to bfloat16, SDPA's device time in the same dtype
   where it computes the same function, and the bound.
7. Flash tiles (``--parts flash``): the bfloat16 instance built with
   each candidate (BQ, BK) tile, BQ in {32, 64} and BK in {16, 32, 64},
   and KW in {1, 2, 4} warps on a row group's keys (8 warps a block at
   most), each held to the plain version and timed at each head dim's
   call (``FLASH_CALLS``), with each instance's registers and spills.

8. MLA (``--parts mla``, ``--old-mla``, ``--old-mla-splits``): an
   earlier ``mla_decode.cu`` (the package's C interface) at the split
   counts its own commit's ``ops.mla_splits`` gave against the
   package's, launched directly in turns (old, new, new, old) at
   dots-vlm1.ocr's tick (64 rows of which 36 hold 1,100-3,200 keys, 200
   pages of 16) and chip_smoke's phase-9 tick (4 rows, 16 pages): device
   time of both kernels, the distance from the plain version, the share
   of the operations' bound; then the package's kernel over its split
   count at the ocr tick.

Each ``--old-*`` source is needed only by the part that uses it.

Prints one line per measurement, the card's ``nvidia-smi`` name and
power limit first.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
AB_DIR = ROOT / "build" / "ab"
SEED = 0

BARRIER_PROBE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void __launch_bounds__(512, 1)
barrier_probe_kernel(float* out, int n_iter, int remote) {
  extern __shared__ float sm[];  // [2][512]
  cg::cluster_group cl = cg::this_cluster();
  const int tid = threadIdx.x, peer = tid & 15, C = (int)cl.num_blocks();
  sm[tid] = 0.f;
  sm[512 + tid] = 0.f;
  cl.sync();
  float x = 0.f;
  for (int i = 0; i < n_iter; ++i) {
    float* buf = sm + (i & 1) * 512 + tid;
    if (remote && peer < C) *cl.map_shared_rank(buf, peer) = (float)i;
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
    x += *buf;
  }
  out[blockIdx.x * blockDim.x + tid] = x;
}

extern "C" int barrier_probe(int C, int n_clusters, int n_iter, int remote,
                             void* out, void* stream) {
  const int smem = 202112;  // the sLSTM prefill block's, one block an SM
  cudaFuncSetAttribute(barrier_probe_kernel,
                       cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cudaFuncSetAttribute(barrier_probe_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C * n_clusters);
  cfg.blockDim = dim3(512);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute a[1];
  a[0].id = cudaLaunchAttributeClusterDimension;
  a[0].val.clusterDim.x = C;
  a[0].val.clusterDim.y = 1;
  a[0].val.clusterDim.z = 1;
  cfg.attrs = a;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, barrier_probe_kernel,
                                     static_cast<float*>(out), n_iter, remote);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}
"""

def record(kind: str, **kw) -> None:
    print(f"[sweep] {kind}: " + ", ".join(
        f"{k} {v:.5f}" if isinstance(v, float) else f"{k} {v}"
        for k, v in kw.items()), flush=True)


def build_libs(srcs: dict[str, Path],
               logs=None) -> dict[str, ctypes.CDLL]:
    """Build each source into ``build/ab/<name>.so`` with the package's
    nvcc flags, one nvcc per source, all started together; each compiler
    report into ``logs[name]`` where a dict is given."""
    from repro_torch.kernels.build import NVCC_FLAGS, nvcc_path

    AB_DIR.mkdir(parents=True, exist_ok=True)
    procs = {name: subprocess.Popen(
        [nvcc_path(), *NVCC_FLAGS, "-o", str(AB_DIR / f"{name}.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for name, src in srcs.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"kernel_sweep: nvcc failed for "
                             f"{srcs[name]}:\n{log}")
        if logs is not None:
            logs[name] = log
    return {name: ctypes.CDLL(str(AB_DIR / f"{name}.so")) for name in srcs}


def build_lib(src: Path, name: str) -> ctypes.CDLL:
    return build_libs({name: src})[name]


def old_slstm_wrapper(lib):
    """The earlier ``ops.slstm_scan`` body (argument checks, four state
    clones, the h double buffer, one cooperative launch) over ``lib``."""
    import torch

    from repro_torch.kernels import ops, ref

    fn = lib.slstm_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(pre, R, state=None):
        B, S, _, d = pre.shape
        _, H, hd, _ = R.shape
        dev = ops._check("slstm_scan", {"pre": pre})
        ops._contiguous("slstm_scan", {"pre": pre, "R": R})
        if state is None:
            state = ref.slstm_initial_state(B, d, dev)
        c, n, h0, m = (t.float().clone() for t in state)
        hbuf = torch.empty((2, B, d), dtype=torch.float32, device=dev)
        hbuf[0] = h0
        h_out = torch.empty((B, d), dtype=torch.float32, device=dev)
        r32 = R.float().contiguous()
        y = torch.empty((B, S, d), dtype=pre.dtype, device=dev)
        err = fn(pre.data_ptr(), r32.data_ptr(), y.data_ptr(), c.data_ptr(),
                 n.data_ptr(), m.data_ptr(), hbuf.data_ptr(),
                 h_out.data_ptr(), B, S, d, H, hd, ops._DTYPES[pre.dtype],
                 torch.cuda.current_stream(pre.device).cuda_stream)
        if err:
            raise RuntimeError(f"old slstm_scan: CUDA error {err}")
        return y, (c, n, h_out, m)

    return call


def slstm_ab(old_src: Path, dev) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops

    old = old_slstm_wrapper(build_lib(old_src, "slstm_scan_old"))
    g = torch.Generator(device=dev).manual_seed(SEED)
    d, H = cs.SL_D, cs.SL_H
    hd = d // H
    R = 0.02 * torch.randn(4, H, hd, hd, generator=g, device=dev)
    gates = tuple(R[i].clone() for i in range(4))
    state = tuple(torch.randn(1, d, generator=g, device=dev)
                  for _ in range(4))
    state = (state[0], 1.0 + state[1].abs(), state[2].tanh(), state[3])
    for S in (1, cs.S_REC):
        pre = torch.randn(1, S, 4, d, generator=g, device=dev)
        st = state if S == 1 else None
        y_old, _ = old(pre, R, st)
        y_new, _ = ops.slstm_scan(pre, gates, state=st)
        torch.cuda.synchronize()
        diff = (y_old - y_new).abs().max().item()
        iters = 200 if S == 1 else 20
        calls = {"old": lambda: old(pre, R, st),
                 "new, R stacked": lambda: ops.slstm_scan(pre, R, state=st),
                 "new, four gate tensors": lambda: ops.slstm_scan(
                     pre, gates, state=st)}
        names = {"old": "slstm_kernel", "new, R stacked":
                 "slstm_step_kernel" if S == 1 else "slstm_prefill_kernel"}
        names["new, four gate tensors"] = names["new, R stacked"]
        order = ["old", "new, R stacked", "new, four gate tensors",
                 "new, four gate tensors", "new, R stacked", "old"]
        ms: dict[str, list[float]] = {k: [] for k in calls}
        for k in order:
            ms[k].append(cs.time_ms(calls[k], iters))
        for k, fn in calls.items():
            record("slstm_ab", S=S, version=k, events_ms=min(ms[k]),
                   turns=[round(t, 5) for t in ms[k]],
                   device_ms=cs.device_ms(fn, names[k], min(iters, 50)),
                   host_us=cs.host_us(fn, iters), max_abs_diff_vs_old=diff)
    # what slstm_apply no longer does on every call: stack R (16 MiB)
    stack = lambda: torch.stack([r.float() for r in gates])  # noqa: E731
    record("slstm_r_stack", events_ms=cs.time_ms(stack, 50),
           host_us=cs.host_us(stack, 50))


def prefill_call(lib, pre, gates, out, y, jr=None):
    """One direct launch of ``lib``'s sLSTM prefill kernel (fresh state)
    with the package's plan for these shapes, or ``jr`` register slots."""
    import torch

    from repro_torch.kernels import ops

    B, S, _, d = pre.shape
    H, hd = gates[0].shape[:2]
    plan = ops.slstm_plan(B, H, hd)
    fn = lib.slstm_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call():
        err = fn(pre.data_ptr(), *(g.data_ptr() for g in gates),
                 y.data_ptr(), None, None, None, None, out.data_ptr(), B, S,
                 d, H, hd, plan.cluster, plan.reg_slots if jr is None else jr,
                 plan.rows, 0, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return call


def slstm_prefill_sweep(dev, alts: dict[str, Path]) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    d, H = cs.SL_D, cs.SL_H
    hd = d // H
    R = 0.02 * torch.randn(4, H, hd, hd, generator=g, device=dev)
    gates = R.unbind(0)
    for S in (2, 100, cs.S_REC, 1000):
        pre = torch.randn(1, S, 4, d, generator=g, device=dev)
        fn = lambda: ops.slstm_scan(pre, R)  # noqa: E731
        t = cs.device_ms(fn, "slstm_prefill_kernel", 20)
        record("slstm_prefill_over_S", S=S, device_ms=t,
               us_per_step=1e3 * t / S if t else None)
    pre = torch.randn(1, cs.S_REC, 4, d, generator=g, device=dev)
    out = torch.empty((4, 1, d), device=dev)
    y = torch.empty((1, cs.S_REC, d), device=dev)
    lib = build.load("slstm_scan")
    plan = ops.slstm_plan(1, H, hd)
    for jr in range(plan.reg_slots, -1, -1):
        call = prefill_call(lib, pre, gates, out, y, jr)
        try:
            call()
        except RuntimeError as e:     # no room in shared memory for it
            record("slstm_prefill_reg_slots", reg_slots=jr, error=str(e))
            break
        record("slstm_prefill_reg_slots", reg_slots=jr, S=cs.S_REC,
               device_ms=cs.device_ms(call, "slstm_prefill_kernel", 20))
    if not alts:
        return
    calls = {"package": prefill_call(lib, pre, gates, out, y)}
    for name, src in alts.items():
        calls[name] = prefill_call(build_lib(src, f"slstm_alt_{name}"), pre,
                                   gates, out, y)
    want = None
    for name, call in calls.items():
        call()
        torch.cuda.synchronize()
        if want is None:
            want = y.clone()
        record("slstm_prefill_variant_check", variant=name,
               max_abs_diff=(y - want).abs().max().item())
    order = list(calls) + list(reversed(calls))
    times: dict[str, list] = {k: [] for k in calls}
    for name in order:
        times[name].append(cs.device_ms(calls[name], "slstm_prefill_kernel",
                                        20))
    for name, ts in times.items():
        record("slstm_prefill_variant", variant=name, S=cs.S_REC,
               device_ms=min(ts), turns=[round(t, 5) for t in ts])


def barrier_latency(dev) -> None:
    import torch

    AB_DIR.mkdir(parents=True, exist_ok=True)
    src = AB_DIR / "barrier_probe.cu"
    src.write_text(BARRIER_PROBE)
    fn = build_lib(src, "barrier_probe").barrier_probe
    fn.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    out = torch.empty(16 * 4 * 512, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def launch_ms(C, n_iter, remote):
        ts = []
        for _ in range(5):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            if fn(C, 4, n_iter, remote, out.data_ptr(), stream):
                raise RuntimeError("barrier probe launch failed")
            b.record()
            b.synchronize()
            ts.append(a.elapsed_time(b))
        return min(ts)

    lo, hi = 64, 4096
    for C in (2, 4, 8, 16):
        for remote in (0, 1):
            t = (launch_ms(C, hi, remote) - launch_ms(C, lo, remote)) / (hi - lo)
            record("cluster_barrier", cluster=C, clusters=4,
                   dsmem_store=bool(remote), us_per_barrier=1e3 * t)


def paged_split_sweep(dev) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops

    g = torch.Generator(device=dev).manual_seed(SEED)
    H, K, D = cs.H, cs.K, cs.D
    B, ps, n_max, P = cs.ROWS, cs.PAGE, cs.N_MAX, cs.N_PAGES
    q = torch.randn(B, H, D, generator=g, device=dev)
    kp = torch.randn(P, ps, K, D, generator=g, device=dev)
    vp = torch.randn(P, ps, K, D, generator=g, device=dev)
    lens = torch.randint(1, 300, (B,), generator=g, device=dev,
                         dtype=torch.int32)
    tables = (torch.randperm(P - 1, generator=g, device=dev) + 1)[
        :B * n_max].reshape(B, n_max).to(torch.int32).contiguous()
    lib = build.load("decode_attention")
    want = ops.paged_decode_attention(q, kp, vp, tables, lens)
    tickets = ops._ticket_counters(dev, B * K)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    chosen = ops.decode_splits(n_max * ps, B, K, H // K, n_sm)
    for n_split in (1, 2, 4, 8, 16, 32, 64, 128):
        ws = torch.empty(B * H * n_split * (D + 2), device=dev)
        o = torch.empty_like(q)

        def call(n_split=n_split, ws=ws, o=o):
            err = lib.paged_decode_attention_fwd(
                q.data_ptr(), kp.data_ptr(), vp.data_ptr(), tables.data_ptr(),
                lens.data_ptr(), o.data_ptr(), ws.data_ptr(),
                tickets.data_ptr(), B, H, K, D, P, ps, n_max, n_split, 0, 0,
                0.0,
                torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"CUDA error {err}")
        call()
        torch.cuda.synchronize()
        record("paged_splits", n_split=n_split, chosen=n_split == chosen,
               blocks=n_split * K * B, max_abs_diff=(o - want).abs().max().item(),
               device_ms=cs.device_ms(call, "paged_decode_fwd", 50))


SSD_AB_SHAPES = ((1, 1, 126), (1, 2, 128), (1, 3, 128))   # B, nc, L
SSD_H, SSD_P, SSD_N = 112, 64, 64


def old_ssd_wrapper(lib):
    """The earlier ``ops.ssd_intra_chunk`` CUDA path (no plan; one block
    per (chunk, head)) over ``lib``."""
    import torch

    from repro_torch.kernels import ops

    fn = lib.ssd_intra_chunk_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(x, Bm, Cm, dt, A_log):
        B, nc, L, H, P = x.shape
        N = Bm.shape[-1]
        dev = x.device
        y = torch.empty((B, nc, L, H, P), dtype=torch.float32, device=dev)
        s_loc = torch.empty((B, nc, H, N, P), dtype=torch.float32,
                            device=dev)
        lam = torch.empty((B, nc, H), dtype=torch.float32, device=dev)
        a_log = A_log.float().contiguous()
        err = fn(x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
                 a_log.data_ptr(), y.data_ptr(), s_loc.data_ptr(),
                 lam.data_ptr(), B * nc, L, H, P, N, ops._DTYPES[x.dtype],
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"old ssd_intra_chunk: CUDA error {err}")
        return y, s_loc, lam

    return call


def ssd_plan_call(lib, args, plan, outs, smem=None, n_heavy=None):
    """One direct launch of an SSD kernel with ``plan`` (any tile rows and
    S_loc split the kernel takes) into ``outs``; ``smem`` and ``n_heavy``
    replace the plan's (a variant source's own layout, another grid
    order)."""
    import torch

    from repro_torch.kernels import ops

    x, Bm, Cm, dt, A_log = args
    B, nc, L, H, P = x.shape
    N = Bm.shape[-1]

    def call():
        err = lib.ssd_intra_chunk_fwd(
            *(t.data_ptr() for t in (x, Bm, Cm, dt, A_log, *outs)), B * nc,
            L, H, P, N, plan.tr, plan.ns,
            plan.n_heavy if n_heavy is None else n_heavy, plan.threads,
            plan.smem if smem is None else smem, ops._DTYPES[x.dtype],
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"ssd_intra_chunk tr={plan.tr} ns={plan.ns}: "
                               f"CUDA error {err}")
    return call


def _ssd_err(got, want) -> float:
    return max((a - b).abs().max().item() for a, b in zip(got, want))


def ssd_ab(old_src: Path, dev) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import ops, ref

    old = old_ssd_wrapper(build_lib(old_src, "ssd_scan_old"))
    g = torch.Generator(device=dev).manual_seed(SEED)
    names = {"old": "ssd_intra_kernel", "new": "ssd_tile_kernel"}
    for B, nc, L in SSD_AB_SHAPES:
        args = cs._ssd_inputs(g, torch.float32,
                              (B, nc, L, SSD_H, SSD_P, SSD_N))
        want = ref.ssd_intra_chunk_ref(*args)
        calls = {"old": lambda: old(*args),
                 "new": lambda: ops.ssd_intra_chunk(*args)}
        errs = {k: _ssd_err(fn(), want) for k, fn in calls.items()}
        ev: dict[str, list] = {k: [] for k in calls}
        dv: dict[str, list] = {k: [] for k in calls}
        for k in ("old", "new", "new", "old"):
            ev[k].append(cs.time_ms(calls[k], 200))
            dv[k].append(cs.device_ms(calls[k], names[k], 50))
        for k, fn in calls.items():
            record("ssd_ab", B=B, nc=nc, L=L, version=k,
                   device_ms=min(dv[k]), events_ms=min(ev[k]),
                   device_turns=[round(t, 5) for t in dv[k]],
                   host_us=cs.host_us(fn, 200), max_abs_err=errs[k])


def ssd_variants(dev, alts: dict[str, Path]) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    libs = {"package": build.load("ssd_scan")}
    for name, lib in build_libs(alts).items():
        lib.ssd_intra_chunk_fwd.argtypes = (
            libs["package"].ssd_intra_chunk_fwd.argtypes)
        libs[name] = lib
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    for B, nc, L in SSD_AB_SHAPES:
        args = cs._ssd_inputs(g, torch.float32,
                              (B, nc, L, SSD_H, SSD_P, SSD_N))
        want = ref.ssd_intra_chunk_ref(*args)
        plan = ops.ssd_plan(L, SSD_P, SSD_N, SSD_H, B * nc,
                            ops._sm_count(dev.index))
        outs = tuple(torch.empty(w.shape, device=dev) for w in want)
        info = (ctypes.c_int * 3)()
        calls = {}
        for k, lib in libs.items():       # each source's own layout
            if lib.ssd_intra_chunk_info(L, SSD_P, SSD_N, plan.tr, plan.ns,
                                        info):
                raise RuntimeError(f"{k}: no SSD plan tr={plan.tr}")
            calls[k] = ssd_plan_call(lib, args, plan, outs, smem=info[0])
            record("ssd_variant_layout", variant=k, nc=nc, smem=info[0],
                   blocks_per_sm=info[2])
        errs = {}
        for k, call in calls.items():
            call()
            torch.cuda.synchronize()
            errs[k] = _ssd_err(outs, want)
        times: dict[str, list] = {k: [] for k in calls}
        for k in list(calls) + list(reversed(calls)):
            times[k].append(cs.device_ms(calls[k], "ssd_tile_kernel", 50))
        for k, ts in times.items():
            record("ssd_variant", nc=nc, L=L, variant=k, device_ms=min(ts),
                   turns=[round(t, 5) for t in ts], max_abs_err=errs[k])


def ssd_tile_sweep(dev) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    lib = build.load("ssd_scan")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    info = (ctypes.c_int * 3)()
    for B, nc, L in SSD_AB_SHAPES:
        shape = (B, nc, L, SSD_H, SSD_P, SSD_N)
        args = cs._ssd_inputs(g, torch.float32, shape)
        want = ref.ssd_intra_chunk_ref(*args)
        outs = tuple(torch.empty(w.shape, device=dev) for w in want)
        chosen = ops.ssd_plan(L, SSD_P, SSD_N, SSD_H, B * nc,
                              ops._sm_count(dev.index))
        for tr in ops.SSD_TILE_ROWS:
            for rms in ops.SSD_STATE_ROWS_A_THREAD:
                plan = ops.ssd_layout(L, SSD_P, SSD_N, tr, tr // 4 * rms,
                                      SSD_H, B * nc)
                if lib.ssd_intra_chunk_info(L, SSD_P, SSD_N, tr, plan.ns,
                                            info):
                    raise RuntimeError(f"no SSD plan tr={tr} ns={plan.ns}")
                call = ssd_plan_call(lib, args, plan, outs)
                call()
                torch.cuda.synchronize()
                record("ssd_tiles", nc=nc, L=L, tr=tr, ns=plan.ns,
                       chosen=(tr, plan.ns) == (chosen.tr, chosen.ns),
                       blocks=plan.blocks, smem=plan.smem,
                       blocks_per_sm=info[2],
                       max_abs_err=_ssd_err(outs, want),
                       device_ms=cs.device_ms(call, "ssd_tile_kernel", 50))
                if tr != chosen.tr:
                    continue
                # the grid order: n_heavy y tiles before the S_loc tiles
                for nh in range(plan.n_y + 1):
                    call = ssd_plan_call(lib, args, plan, outs, n_heavy=nh)
                    call()
                    torch.cuda.synchronize()
                    record("ssd_order", nc=nc, L=L, tr=tr, ns=plan.ns,
                           n_heavy=nh, chosen=(plan.ns, nh) == (
                               chosen.ns, chosen.n_heavy),
                           max_abs_err=_ssd_err(outs, want),
                           device_ms=cs.device_ms(call, "ssd_tile_kernel",
                                                  50))


# the bfloat16 flash instance's tile candidates (BQ, BK, KW: q rows a
# block, keys a warp tile, warps on a row group's keys; at most 8 warps a
# block), and the call each head dim is timed at, (B, S, H, K, causal,
# window, softcap): the mini-clip vision tower (D = 16), internvl2-1b's
# prefill (64), zamba2-7b's shared attention at its 200-token prompt
# (112), llama3-8b at gemma2-9b's long prompt (128), gemma2-9b's local
# layer (256)
FLASH_TILES = tuple((bq, bk, kw) for bq in (32, 64)
                    for bk in (16, 32, 64) for kw in (1, 2, 4)
                    if bq // 16 * kw <= 8)
FLASH_CALLS = {16: (4, 16, 4, 4, False, 0, 0.0),
               64: (1, 267, 14, 2, True, 0, 0.0),
               112: (1, 200, 32, 32, True, 0, 0.0),
               128: (1, 4100, 32, 8, True, 0, 0.0),
               256: (1, 4100, 16, 8, True, 4096, 50.0)}
# the old-vs-new bfloat16 rows (--old-flash): the two served shapes and
# gemma2-9b's local layer; the float32 instance at the served shapes as
# the control that did not change
FLASH_AB = ((64, "bfloat16"), (112, "bfloat16"), (256, "bfloat16"),
            (64, "float32"), (112, "float32"))


def flash_call(lib, q, k, v, o, causal, window, softcap):
    """One direct launch of ``lib``'s ``flash_attention_fwd`` into o."""
    import torch

    from repro_torch.kernels import ops

    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, T,
            H, K, D, ops._DTYPES[q.dtype], int(causal), window, softcap,
            stream)
        if err:
            raise RuntimeError(f"flash_attention_fwd: CUDA error {err}")
    return call


def _flash_inputs(g, dev, D, dtype):
    import torch

    B, S, H, K, causal, window, softcap = FLASH_CALLS[D]
    q, k, v = (torch.randn(B, S, n, D, generator=g, device=dev).to(dtype)
               for n in (H, K, K))
    return q, k, v, dict(causal=causal, window=window, softcap=softcap)


def _set_argtypes(lib):
    from repro_torch.kernels import build

    fn = lib.flash_attention_fwd
    fn.argtypes = build.LIBRARIES["flash_attention"][1]["flash_attention_fwd"]
    fn.restype = ctypes.c_int


def flash_tile_sweep(dev) -> None:
    """The bfloat16 flash instance built with each candidate tile (a copy
    of the package's source under ``build/ab/`` with every
    ``MmaTiles<D>`` line rewritten to it; a tile above a block's shared
    memory at a head dim is skipped there), each held to the plain version
    at ``TOL["bfloat16"]`` and timed (device time under the profiler) at
    ``FLASH_CALLS``, with its registers and spills; the package's own
    tile is marked ``chosen``."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    text = (build.CSRC / "flash_attention.cu").read_text()
    line = re.compile(r"(struct MmaTiles<(\d+)> \{ static constexpr int "
                      r"BQ = )\d+, BK = \d+, KW = \d+")
    AB_DIR.mkdir(parents=True, exist_ok=True)
    names = {}
    for bq, bk, kw in FLASH_TILES:
        variant, n = line.subn(rf"\g<1>{bq}, BK = {bk}, KW = {kw}", text)
        if n != len(ops.HEAD_DIMS):
            raise SystemExit("kernel_sweep: flash_attention.cu has "
                             f"{n} MmaTiles lines, not {len(ops.HEAD_DIMS)}")
        name = f"flash_bf16_{bq}x{bk}x{kw}"
        names[name] = AB_DIR / f"{name}.cu"
        names[name].write_text(variant)
    logs: dict[str, str] = {}
    libs = build_libs(names, logs)
    for name, log in logs.items():
        entries = cs.ptxas_entries(log)
        for e, short in zip(entries, cs._short_names([e["name"]
                                                      for e in entries])):
            if "flash_fwd_mma" in short:
                record("flash_ptxas", build=name, kernel=short,
                       registers=e["registers"], spill=e["spill"])
    for lib in libs.values():
        _set_argtypes(lib)
    plan = (ctypes.c_int * 4)()
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    for D in FLASH_CALLS:
        q, k, v, opts = _flash_inputs(g, dev, D, torch.bfloat16)
        want = ref.flash_attention_ref(q, k, v, **opts)
        for bq, bk, kw in FLASH_TILES:
            lib = libs[f"flash_bf16_{bq}x{bk}x{kw}"]
            lib.flash_attention_plan(D, 1, plan)
            if plan[3] > ops.SMEM_LIMIT:
                record("flash_tiles", D=D, BQ=bq, BK=bk, KW=kw,
                       smem=plan[3], skipped="above a block's shared memory")
                continue
            o = torch.empty_like(q)
            call = flash_call(lib, q, k, v, o, **opts)
            call()
            torch.cuda.synchronize()
            err, ratio = cs._within(o, want, "bfloat16")
            record("flash_tiles", D=D, shape=FLASH_CALLS[D], BQ=bq, BK=bk,
                   KW=kw, chosen=(bq, bk, kw) == ops.FLASH_TILES_BF16[D],
                   threads=plan[2], smem=plan[3],
                   blocks=q.shape[2] * q.shape[0] * -(-q.shape[1] // bq),
                   max_abs_err=err, of_tolerance=ratio,
                   device_ms=cs.device_ms(
                       call, "flash_fwd_mma", 20 if q.shape[1] > 1000
                       else 50))


def flash_ab(old_src: Path, dev, alts: dict[str, Path]) -> None:
    """An earlier ``flash_attention.cu`` (the C interface of the
    package's ``flash_attention_fwd``) and each ``--alt-flash`` variant
    against the package's, all launched directly, in turns (old, new,
    variants, then back) at ``FLASH_AB``: the kernel's device time under
    the profiler (events named "flash_fwd", which every instance's name
    holds) and CUDA-event time over back-to-back calls, each held to the
    plain version and, in bfloat16, the share of its outputs that differ
    from exact (float64) attention rounded to bfloat16 (``flips``; the
    plain version's beside it); then SDPA in the same dtype where it
    computes the same function (no window, no softcap; device time of all
    its kernels) and the bound."""
    import torch
    import torch.nn.functional as F

    import chip_smoke as cs
    from repro_torch.kernels import build, ref

    libs = {"old": build_lib(old_src, "flash_attention_old"),
            "new": build.load("flash_attention"), **build_libs(alts)}
    for name, lib in libs.items():
        if name != "new":
            _set_argtypes(lib)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    for D, dname in FLASH_AB:
        dt = getattr(torch, dname)
        q, k, v, opts = _flash_inputs(g, dev, D, dt)
        B, S, H, _ = q.shape
        K = k.shape[2]
        want = ref.flash_attention_ref(q, k, v, **opts)
        exact = None
        if dt is torch.bfloat16:
            exact = ref.flash_attention_ref(q, k, v, dtype=torch.float64,
                                            **opts)
            record("flash_ab_plain", D=D, dtype=dname, shape=FLASH_CALLS[D],
                   flips=ref.flips(want, exact))
        outs = {name: torch.empty_like(q) for name in libs}
        calls = {name: flash_call(lib, q, k, v, outs[name], **opts)
                 for name, lib in libs.items()}
        errs, flips = {}, {}
        for name, call in calls.items():
            call()
            torch.cuda.synchronize()
            errs[name] = cs._within(outs[name], want, dname)
            flips[name] = (None if exact is None else
                           ref.flips(outs[name], exact))
        n = 20 if S > 1000 else 50
        dv: dict[str, list] = {name: [] for name in calls}
        ev: dict[str, list] = {name: [] for name in calls}
        for name in list(calls) + list(calls)[::-1]:
            dv[name].append(cs.device_ms(calls[name], "flash_fwd", n))
            ev[name].append(cs.time_ms(calls[name], n))
        for name in calls:
            record("flash_ab", D=D, dtype=dname, shape=FLASH_CALLS[D],
                   version=name, device_ms=min(dv[name]),
                   device_turns=[round(x, 5) for x in dv[name]],
                   events_ms=min(ev[name]), max_abs_err=errs[name][0],
                   of_tolerance=errs[name][1], flips=flips[name])
        b_ms, b_by = cs.bound(*cs._flash_work(
            B, S, S, H, K, D, opts["causal"], q.element_size(),
            opts["window"]), dname)
        lib_ms = None
        if not opts["window"] and not opts["softcap"]:
            qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
            sdpa = (lambda: F.scaled_dot_product_attention(
                qh, kh, vh, is_causal=opts["causal"], enable_gqa=H != K))
            lib_ms = cs.device_ms(sdpa, "", n)
        record("flash_ab_yardsticks", D=D, dtype=dname, shape=FLASH_CALLS[D],
               sdpa_device_ms=lib_ms, bound_ms=b_ms, bound_by=b_by)


#: MLA's paged decode: H, r, rope, the score scale (DeepSeek-V3's), and
#: the ticks it is timed at: (name, lengths, pages a row)
MLA_H, MLA_R, MLA_ROPE, MLA_SCALE = 128, 512, 64, (128 + 64) ** -0.5


def mla_ticks():
    """chip_smoke's two timed MLA ticks: dots-vlm1.ocr's
    (``paged_mla_decode_ocr``) and phase 9's (``paged_mla_decode``)."""
    import chip_smoke as cs

    phase9 = [n + cs.FAM_NEW // 2
              for n in cs.prompt_lens(cs.FAM_PROMPTS, cs.FAM_REQS)]
    return (("ocr", cs.mla_ocr_lengths(), cs.MLA_OCR_PAGES),
            ("phase9", phase9, cs.FAM_CACHE[cs.L405_ARCH] // cs.PAGE))


def mla_inputs(g, dev, lens, n_max):
    """A pool of len(lens) rows' pages of 16 (page ids shuffled, garbage
    table entries past a row's pages), the queries, and the pages the
    live keys lie in."""
    import torch

    B, ps = len(lens), 16
    P = B * n_max + 1
    q_lat = torch.randn(B, MLA_H, MLA_R, generator=g, device=dev)
    q_pe = torch.randn(B, MLA_H, MLA_ROPE, generator=g, device=dev)
    ckv = torch.randn(P, ps, MLA_R, generator=g, device=dev)
    kr = torch.randn(P, ps, MLA_ROPE, generator=g, device=dev)
    perm = torch.randperm(P - 1, generator=g, device=dev) + 1
    tables = perm[:B * n_max].reshape(B, n_max).to(torch.int32)
    lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
    junk = torch.randint(-50, P + 50, (B, n_max), generator=g, device=dev,
                         dtype=torch.int32)
    owned = torch.arange(n_max, device=dev)[None] * ps < lens_t[:, None]
    tables = torch.where(owned, tables, junk).contiguous()
    return (q_lat, q_pe, ckv, kr, tables, lens_t), int(owned.sum())


def mla_call(lib, args, n_split):
    """A direct launch of ``lib``'s ``paged_mla_decode_fwd`` at n_split
    splits into a fresh output; returns (call, output)."""
    import torch

    q_lat, q_pe, ckv, kr, tables, lens = args
    B, H, r = q_lat.shape
    P, ps, rope = kr.shape
    o = torch.empty_like(q_lat)
    ws = torch.empty(max(B * H * n_split * (r + 2), 1), device=q_lat.device)

    def call():
        err = lib.paged_mla_decode_fwd(
            q_lat.data_ptr(), q_pe.data_ptr(), ckv.data_ptr(), kr.data_ptr(),
            tables.data_ptr(), lens.data_ptr(), o.data_ptr(), ws.data_ptr(),
            B, H, r, rope, P, ps, tables.shape[1], n_split, MLA_SCALE,
            torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"CUDA error {err}")
    return call, o


def mla_ab(old_src: Path, old_splits: list[int], dev) -> None:
    """The earlier source at the split counts its own commit's
    ``ops.mla_splits`` gave at each tick (``old_splits``, in
    ``mla_ticks``' order) against the package's at its own."""
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    old = build_lib(old_src, "mla_decode_old")
    for fn, argtypes in build.LIBRARIES["mla_decode"][1].items():
        getattr(old, fn).argtypes = argtypes
        getattr(old, fn).restype = ctypes.c_int
    new = build.load("mla_decode")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(SEED + 34)
    for (name, lens, n_max), n_old in zip(mla_ticks(), old_splits):
        libs = {"old": (old, n_old),
                "new": (new, ops.mla_splits(n_max * 16, len(lens), MLA_H,
                                            n_sm))}
        args, pages = mla_inputs(g, dev, lens, n_max)
        want = ref.paged_mla_decode_ref(*args, scale=MLA_SCALE)
        b_ms, b_by = cs.bound(*cs._mla_work(args[0], args[5], len(lens),
                                            pages), "float32")
        calls, errs, splits = {}, {}, {}
        for version, (lib, n_split) in libs.items():
            splits[version] = n_split
            calls[version], o = mla_call(lib, args, n_split)
            calls[version]()
            torch.cuda.synchronize()
            errs[version] = cs._within(o, want, "float32")
        dv: dict[str, list] = {v: [] for v in calls}
        for version in list(calls) + list(calls)[::-1]:
            dv[version].append(cs.device_ms(calls[version], "", 50))
        for version in calls:
            record("mla_ab", tick=name, version=version,
                   n_split=splits[version], device_ms=min(dv[version]),
                   device_turns=[round(x, 5) for x in dv[version]],
                   roofline_pct=100 * b_ms / min(dv[version]),
                   max_abs_err=errs[version][0],
                   of_tolerance=errs[version][1])
        record("mla_ab_bound", tick=name, bound_ms=b_ms, bound_by=b_by,
               live_keys=int(args[5].sum()))


def mla_split_sweep(dev) -> None:
    import torch

    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    lib = build.load("mla_decode")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(SEED + 35)
    name, lens, n_max = mla_ticks()[0]
    args, pages = mla_inputs(g, dev, lens, n_max)
    want = ref.paged_mla_decode_ref(*args, scale=MLA_SCALE)
    b_ms, _ = cs.bound(*cs._mla_work(args[0], args[5], len(lens), pages),
                       "float32")
    chosen = ops.mla_splits(n_max * 16, len(lens), MLA_H, n_sm)
    for n_split in (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 24):
        call, o = mla_call(lib, args, n_split)
        call()
        torch.cuda.synchronize()
        ms = cs.device_ms(call, "", 50)
        record("mla_splits", tick=name, n_split=n_split,
               chosen=n_split == chosen, device_ms=ms,
               roofline_pct=100 * b_ms / ms,
               max_abs_err=cs._within(o, want, "float32")[0])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--old-slstm", type=Path,
                    help="an earlier slstm_scan.cu (cooperative interface; "
                         "part ab)")
    ap.add_argument("--old-ssd", type=Path,
                    help="an earlier ssd_scan.cu (one block per (chunk, "
                         "head); part ssd)")
    ap.add_argument("--old-flash", type=Path,
                    help="an earlier flash_attention.cu, timed against the "
                         "package's in turns (part flash_ab)")
    ap.add_argument("--alt-flash", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a variant flash_attention.cu with the package's "
                         "interface, timed beside it (part flash_ab)")
    ap.add_argument("--old-mla", type=Path,
                    help="an earlier mla_decode.cu, timed against the "
                         "package's in turns (part mla)")
    ap.add_argument("--old-mla-splits",
                    help="OCR,PHASE9: the splits the earlier source's own "
                         "ops.mla_splits gave at the two ticks (part mla)")
    ap.add_argument("--alt-slstm", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a variant slstm_scan.cu with the package's "
                         "interface, timed beside it")
    ap.add_argument("--alt-ssd", action="append", default=[],
                    metavar="NAME=PATH",
                    help="a variant ssd_scan.cu with the package's "
                         "interface, timed beside it (part ssd)")
    ap.add_argument("--parts",
                    default="ab,prefill,barrier,paged,ssd,flash_ab,flash,mla",
                    help="comma-separated sections to run (default: all)")
    args = ap.parse_args()
    parts = set(args.parts.split(","))
    for part, src in (("ab", "old_slstm"), ("ssd", "old_ssd"),
                      ("flash_ab", "old_flash"), ("mla", "old_mla"),
                      ("mla", "old_mla_splits")):
        if part in parts and getattr(args, src) is None:
            ap.error(f"part {part} needs --{src.replace('_', '-')}")
    alts = {k: Path(v) for k, v in (a.split("=", 1) for a in args.alt_slstm)}
    ssd_alts = {k: Path(v)
                for k, v in (a.split("=", 1) for a in args.alt_ssd)}
    flash_alts = {k: Path(v)
                  for k, v in (a.split("=", 1) for a in args.alt_flash)}
    import torch

    import chip_smoke as cs
    import repro_torch  # noqa: F401  (sets the float32 matmul precision)

    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device is visible", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"[card] {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)
    if "ab" in parts:
        slstm_ab(args.old_slstm, dev)
    if "prefill" in parts:
        slstm_prefill_sweep(dev, alts)
    if "barrier" in parts:
        barrier_latency(dev)
    if "paged" in parts:
        paged_split_sweep(dev)
    if "flash_ab" in parts:
        flash_ab(args.old_flash, dev, flash_alts)
    if "flash" in parts:
        flash_tile_sweep(dev)
    if "ssd" in parts:
        ssd_ab(args.old_ssd, dev)
        ssd_tile_sweep(dev)
        if ssd_alts:
            ssd_variants(dev, ssd_alts)
    if "mla" in parts:
        mla_ab(args.old_mla,
               [int(n) for n in args.old_mla_splits.split(",")], dev)
        mla_split_sweep(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
