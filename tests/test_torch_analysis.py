"""The port's analysis passes, held on the CPU: the Hopper launch-plan
checker (``repro_torch.analysis.kernel_check``), the concurrency lint
with its CUDA-dispatch rule, the ``python -m repro_torch.analysis`` CLI
and ``Deployment.verify(kernels=True)``.

The kernel checker never launches: it runs the wrappers' own planners
and calls the wrappers and ``kernels/ref.py`` on ``meta`` tensors.  The
lint is held to the JAX package's on the same sources (codes, messages,
entities)."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis import Severity, errors, format_report
from repro_torch.analysis import kernel_check as kc
from repro_torch.analysis.concurrency_lint import (
    lint_paths, lint_serving, lint_source,
)
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _codes(diags):
    return {d.code for d in diags}


# ---- kernel checker -----------------------------------------------------

@pytest.fixture(scope="module")
def sweep():
    return kc.check_kernels()


def test_zoo_kernel_sweep_is_error_free(sweep):
    cases = kc.zoo_cases()
    assert {c.entry for c in cases} == set(kc.ENTRY_POINTS)
    assert errors(sweep) == [], format_report(sweep)
    assert not [d for d in sweep if d.severity == Severity.WARNING]
    summarised = {d.entity for d in sweep if d.code == "kernel/summary"}
    assert summarised == {c.name for c in cases}
    # MLA's paged decode launches its own kernel: summarised, at phase
    # 9's tick and the dots-vlm1 cell's 64 rows
    for name in ("deepseek-v3-671b/paged-mla-decode",
                 "deepseek-v3-671b/paged-mla-decode-64rows"):
        assert any(d.code == "kernel/summary" and d.entity == name
                   and "paged_mla_decode_kernel" in d.message for d in sweep)


def test_every_reference_case_name_is_covered():
    from repro.analysis.kernel_check import zoo_cases as ref_zoo_cases

    names = {c.name for c in kc.zoo_cases()}
    for c in ref_zoo_cases():
        assert kc.RENAMED.get(c.name, c.name) in names, c.name
    audio = next(c for c in kc.zoo_cases()
                 if c.name == "whisper-tiny/audio-prefill")
    assert audio.shape("q")[1] == audio.shape("k")[1] == 1500   # unpadded


def test_summary_reports_grid_threads_smem_and_bound(sweep):
    msg = next(d.message for d in sweep
               if d.entity == "gemma2-9b/global-prefill")
    # H = 16, B = 1, 2048 / 32 q tiles; 128 threads; 102 KiB at D = 256
    assert "grid=(16, 1, 64)" in msg and "128 threads" in msg
    assert "102.0 KiB" in msg and "by operations" in msg
    msg = next(d.message for d in sweep if d.entity == "xlstm-1.3b/scan")
    assert "clusters of 16" in msg and "slstm_prefill_kernel" in msg
    msg = next(d.message for d in sweep
               if d.entity == "zamba2-7b/prefill-1-chunk")
    assert "3 blocks an SM" in msg


@pytest.mark.parametrize("case", kc.error_cases(), ids=lambda c: c.name)
def test_bad_geometry_gets_its_error_code(case):
    diags = kc.check_case(case)
    code = kc.ERROR_CODES[case.name]
    assert _codes(errors(diags)) == {code}
    # the wrapper refuses it on meta tensors, before any launch, with the
    # error type the code stands for
    with pytest.raises(ops.KernelPlanError) as info:
        getattr(ops, case.entry)(*case.meta_args(), **case.kwargs)
    assert type(info.value) is {c: cls for cls, c in kc.PLAN_CODES}[code]


def test_no_accepted_shape_reaches_the_shared_memory_limit():
    """``kernel/smem-limit`` guards a later change: no SSD shape within
    ``SSD_MAX_DIM`` and no sLSTM head dim with a plan needs more than a
    block's shared memory, and flash's fixed tiles fit."""
    worst = ops.ssd_smem(128, 128, 128, ops.SSD_PLAN_ROWS, 64)
    assert worst == 103424 < ops.SMEM_LIMIT
    for L, P, N in [(128, 128, 128), (1, 1, 1), (126, 64, 64), (128, 8, 128)]:
        for BC in (1, 8, 64):
            assert ops.ssd_plan(L, P, N, 112, BC, 132).smem <= worst
    for hd in range(8, ops.SLSTM_MAX_HEAD_DIM + 1, 8):
        for B in (1, 4, 17, 64):
            try:
                assert ops.slstm_plan(B, 4, hd).smem <= ops.SMEM_LIMIT
            except ops.ClusterError:
                pass
    assert all(ops.flash_plan(D).smem <= ops.SMEM_LIMIT
               for D in ops.HEAD_DIMS)


def test_occupancy_under_two_blocks_warns(monkeypatch):
    import dataclasses

    real = ops.ssd_plan

    def one_block(*a):
        return dataclasses.replace(real(*a), blocks_per_sm=1)

    monkeypatch.setattr(ops, "ssd_plan", one_block)
    case = next(c for c in kc.zoo_cases()
                if c.name == "zamba2-7b/prefill-3-chunk")
    diags = kc.check_case(case)
    assert [d.code for d in diags if d.severity == Severity.WARNING] == [
        "kernel/occupancy"]
    assert errors(diags) == []


def test_shape_and_dtype_drift_flagged(monkeypatch):
    case = kc._flash_case("drift/flash", B=1, S=32, T=32, H=4, K=4, D=64,
                          dtype=torch.bfloat16)
    monkeypatch.setattr(ref, "flash_attention_ref",
                        lambda q, k, v, **kw: q.float())
    assert "kernel/dtype-drift" in _codes(errors(kc.check_case(case)))
    monkeypatch.setattr(ref, "flash_attention_ref",
                        lambda q, k, v, **kw: q[..., :32])
    assert "kernel/shape-drift" in _codes(errors(kc.check_case(case)))


def test_sm_count_reads_the_card_only_for_cuda(monkeypatch):
    class Props:
        multi_processor_count = 114

    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda i: Props())
    ops._sm_count.cache_clear()
    try:
        assert ops.sm_count(torch.device("meta")) == 132
        assert ops.sm_count(torch.device("cpu")) == 132
        assert ops.sm_count(torch.device("cuda")) == 114
    finally:
        ops._sm_count.cache_clear()
    # the decode planner splits by the SM count: fewer SMs, fewer splits
    case = next(c for c in kc.zoo_cases() if c.name == "llama3-8b/decode")
    assert kc.launch_plan(case, 114).grid[0] <= kc.launch_plan(
        case, 132).grid[0]


def test_meta_path_launches_and_builds_nothing(monkeypatch):
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "load", lambda name: pytest.fail("built"))
    ops.reset_launches()
    for case in kc.zoo_cases():
        getattr(ops, case.entry)(*case.meta_args(), **case.kwargs)
    assert not any(ops.LAUNCHES.values())


def test_small_cases_match_the_plain_version_on_cpu():
    """A case's seeded inputs through the wrapper (the plain version on
    the CPU) give the shapes and dtypes the checker read on meta, and the
    values of the checker's plain version: the same code, so exactly,
    but for ``ssd_chunked``, whose plain version is the step-by-step
    recurrence (float32 sums in another order: atol 2e-4)."""
    g = torch.Generator().manual_seed(0)
    for case in (kc._flash_case("s/flash", B=2, S=9, T=9, H=4, K=2, D=16),
                 kc._paged_decode_case("s/paged", B=3, T=40, H=4, K=2, D=16),
                 kc._paged_tile_case("s/paged-tile", B=3, H=4, K=2, D=16,
                                     n_max=3, n_pages=8, pages=4, p0=4,
                                     s0=8, window=20),
                 kc._ssd_cases("s/ssd", B=1, S=16, H=2, P=4, N=8, chunk=8)[0],
                 kc._slstm_case("s/slstm", B=2, S=3, H=2, hd=16)):
        args = case.inputs(g)
        got = kc.leaves(getattr(ops, case.entry)(*args, **case.kwargs))
        want = kc.leaves(kc.plain(case, args))
        meta = kc.leaves(getattr(ops, case.entry)(*case.meta_args(),
                                                    **case.kwargs))
        atol = 2e-4 if case.entry == "ssd_chunked" else 0.0
        for a, b, m in zip(got, want, meta):
            torch.testing.assert_close(a, b, rtol=0, atol=atol)
            assert a.shape == m.shape and a.dtype == m.dtype


def test_flash_plan_mirrors_the_cuda_source():
    """``ops.FLASH_TILES`` / ``FLASH_THREADS`` are the float32 instance's
    ``Tiles<D>`` and ``NT`` lines of ``csrc/flash_attention.cu``, and
    ``ops.FLASH_TILES_BF16`` the bfloat16 instance's ``MmaTiles<D>``
    lines; every head dim of
    the wrappers has a plan in each dtype, within a block's shared memory
    and its threads, with warps of 16 query rows x BK keys in the
    bfloat16 one."""
    src = (PORT / "csrc" / "flash_attention.cu").read_text()
    tiles = {int(d): (int(bq), int(bk)) for d, bq, bk in re.findall(
        r"struct Tiles<(\d+)> \{ static constexpr int BQ = (\d+), BK = "
        r"(\d+); \}", src)}
    mma = {int(d): tuple(map(int, rest)) for d, *rest in re.findall(
        r"struct MmaTiles<(\d+)> \{ static constexpr int BQ = (\d+), "
        r"BK = (\d+), KW = (\d+); \}", src)}
    assert tiles == ops.FLASH_TILES
    assert mma == ops.FLASH_TILES_BF16
    assert int(re.search(r"constexpr int NT = (\d+);", src).group(1)) == \
        ops.FLASH_THREADS
    assert tuple(sorted(ops.FLASH_TILES)) == ops.HEAD_DIMS
    assert tuple(sorted(ops.FLASH_TILES_BF16)) == ops.HEAD_DIMS
    for D in ops.HEAD_DIMS:
        p = ops.flash_plan(D, torch.float32)
        assert (p.bq, p.bk, p.threads) == (*ops.FLASH_TILES[D],
                                           ops.FLASH_THREADS)
        b = ops.flash_plan(D, torch.bfloat16)
        bq, bk, kw = ops.FLASH_TILES_BF16[D]
        assert (b.bq, b.bk) == (bq, bk) and bq % 16 == 0 and bk % 16 == 0
        assert b.threads == 32 * (bq // 16) * kw <= 256
        assert b.smem == 2 * (D + 8) * (bq + 4 * kw * bk)
        assert p.smem <= ops.SMEM_LIMIT and b.smem <= ops.SMEM_LIMIT
    with pytest.raises(ops.NoPlanError, match="head_dim 96"):
        ops.flash_plan(96)


# ---- concurrency lint ---------------------------------------------------

_LOCKED_CLASS = '''
import threading, jax, torch
from repro_torch.kernels import ops
class Sched:
    def __init__(self):
        self._lock = threading.Lock()
        self.queue = []
    def good(self):
        with self._lock:
            self.queue.append(1)
    def {body}
'''


def test_lint_unlocked_mutation():
    src = _LOCKED_CLASS.format(body="bad(self):\n        self.queue.append(2)")
    hits = [d for d in lint_source(src, "sched.py")
            if d.code == "concurrency/unlocked-mutation"]
    assert len(hits) == 1 and hits[0].severity == Severity.ERROR
    assert "sched.py:" in hits[0].entity


def test_lint_jax_dispatch_under_lock():
    src = _LOCKED_CLASS.format(
        body="bad(self, x):\n        with self._lock:\n"
             "            return jax.block_until_ready(x)")
    assert any(d.code == "concurrency/dispatch-under-lock"
               and d.severity == Severity.WARNING
               for d in lint_source(src, "sched.py"))


@pytest.mark.parametrize("call,desc", [
    ("torch.cuda.synchronize()", "torch.cuda.synchronize"),
    ("torch.stack([x, x])", "torch.stack"),
    ("ops.flash_attention(x, x, x)", "ops.flash_attention"),
    ("paged_decode_attention(x, x, x, x, x)", "paged_decode_attention"),
    ("ssd_chunked(x, x, x, x, x)", "ssd_chunked"),
    ("x.to('cuda')", ".to"),
    ("int(x.max().item())", ".item"),
    ("self.buf.copy_(x)", ".copy_"),
    ("x.tolist()", ".tolist"),
])
def test_lint_cuda_dispatch_under_lock(call, desc):
    """The CUDA twin: torch calls, kernel entries and device-moving or
    syncing methods under the lock."""
    src = _LOCKED_CLASS.format(
        body=f"bad(self, x):\n        with self._lock:\n"
             f"            return {call}")
    hits = [d for d in lint_source(src, "sched.py")
            if d.code == "concurrency/cuda-dispatch-under-lock"]
    assert len(hits) == 1 and hits[0].severity == Severity.WARNING
    assert f"Sched.bad calls {desc}(...)" in hits[0].message
    # the same call outside the lock is fine
    src = _LOCKED_CLASS.format(
        body=f"ok(self, x):\n        with self._lock:\n"
             f"            n = len(self.queue)\n        return {call}")
    assert not [d for d in lint_source(src, "sched.py")
                if d.code == "concurrency/cuda-dispatch-under-lock"]


def test_cuda_rule_fires_on_the_port_serving_with_a_launch_under_its_lock():
    """A device sync put under ``DecodeStream``'s first lock, in a copy of
    the source: the rule must name it."""
    src = (PORT / "serving" / "decode.py").read_text()
    assert "with self._lock:" in src
    bad = src.replace("with self._lock:",
                      "with self._lock:\n            torch.cuda.synchronize()",
                      1)
    hits = [d for d in lint_source(bad, "serving/decode.py")
            if d.code == "concurrency/cuda-dispatch-under-lock"]
    assert len(hits) == 1 and "torch.cuda.synchronize" in hits[0].message


def test_lint_registry_mutation_in_batch_path():
    src = '''
class Sched:
    def step(self):
        self._service("m")
    def _service(self, m):
        self._grow(m)
    def _grow(self, m):
        self.engine.registry.add_model(m)
'''
    hits = [d for d in lint_source(src, "sched.py")
            if d.code == "concurrency/registry-mutation-in-batch-path"]
    assert len(hits) == 1 and "add_model" in hits[0].message


def test_lint_ignores_unguarded_only_attrs():
    src = _LOCKED_CLASS.format(body="ok(self):\n        self.other = 1")
    assert not [d for d in lint_source(src, "s.py")
                if d.code == "concurrency/unlocked-mutation"]


@pytest.mark.parametrize("body,code", [
    ("bad(self, rid):\n        self.pool.free(rid)",
     "concurrency/unlocked-allocator-call"),
    ("ok(self, rid):\n        with self._lock:\n"
     "            self.pool.extend(rid, 4)", None),
])
def test_lint_allocator_calls(body, code):
    hits = [d.code for d in lint_source(_LOCKED_CLASS.format(body=body),
                                        "s.py")
            if d.code == "concurrency/unlocked-allocator-call"]
    assert hits == ([code] if code else [])


_CLOCKY = """
import time

def stamp():
    return time.time()

def tick():
    return time.monotonic()

def ok():
    return time.perf_counter()
"""


def test_raw_clock_flagged_in_serving_and_obs_only():
    for scoped in ("src/repro_torch/serving/x.py", "src/repro_torch/obs/x.py"):
        codes = [d.code for d in lint_source(_CLOCKY, filename=scoped)]
        assert codes == ["obs/raw-clock-call"] * 2, (scoped, codes)
    assert lint_source(_CLOCKY, filename="src/repro_torch/launch/x.py") == []


def test_port_serving_and_obs_lint_clean():
    """No finding at all, the CUDA rule and raw clocks included, and no
    suppression in either tree."""
    import repro_torch.obs as obs

    diags = lint_serving() + lint_paths([Path(obs.__file__).parent])
    assert diags == [], format_report(diags)
    for f in [*(PORT / "serving").rglob("*.py"), *(PORT / "obs").rglob("*.py")]:
        assert "lockset: ignore" not in f.read_text(), f


@pytest.mark.parametrize("src", [
    _LOCKED_CLASS.format(body="bad(self):\n        self.queue.append(2)"),
    _LOCKED_CLASS.format(body="bad(self, x):\n        with self._lock:\n"
                              "            return jax.device_put(x)"),
    _LOCKED_CLASS.format(body="bad(self, rid):\n        self.pool.free(rid)"),
    _CLOCKY,
], ids=["unlocked", "jax-dispatch", "allocator", "clock"])
def test_lint_agrees_with_the_reference(src):
    """On sources without torch calls the two lints give the same
    findings, to the message."""
    from repro.analysis.concurrency_lint import lint_source as ref_lint

    name = "src/serving/sched.py"
    mine = [(d.severity, d.code, d.message, d.entity)
            for d in lint_source(src, name)]
    theirs = [(int(d.severity), d.code, d.message, d.entity)
              for d in ref_lint(src, name)]
    assert [(int(s), c, m, e) for s, c, m, e in mine] == theirs
    assert mine


# ---- CLI ----------------------------------------------------------------

def test_cli_self_mode_exits_clean(capsys):
    from repro_torch.analysis.__main__ import main

    assert main(["--self", "--mc-budget", "10"]) == 0
    out = capsys.readouterr().out
    assert "0 error(s)" in out and "kernel/summary" in out
    assert "modelcheck/mutation-caught" in out
    assert "locksets/mutation-caught" in out and "obs/self-test" in out


def test_cli_exits_1_on_an_error_fixture(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text(_LOCKED_CLASS.format(
        body="bad(self):\n        self.queue.append(2)"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", str(bad), "--kernels"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 1, out.stderr
    assert "concurrency/unlocked-mutation" in out.stdout
    assert "no bench gate" in subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--help"], cwd=ROOT,
        capture_output=True, text=True, timeout=60,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    ).stdout.replace("\n", " ").replace("  ", " ")


# ---- verify_deployment --------------------------------------------------

def _dep():
    from repro_torch.core.cluster import ClusterSpec, DeviceSpec
    from repro_torch.core.module import ModelSpec, ModuleSpec
    from repro_torch.s2m3 import Deployment

    vis = ModuleSpec("vis-enc", "encoder", "vision", 60_000,
                     flops_per_query=2e6)
    txt = ModuleSpec("txt-enc", "encoder", "text", 50_000,
                     flops_per_query=1e6)
    cos = ModuleSpec("cos-head", "head", "task", 1_000)
    cls = ModuleSpec("cls-head", "head", "task", 1_000)
    return (Deployment(ClusterSpec(devices=[
        DeviceSpec(f"d{i}", 1 << 30, 1e9) for i in range(3)]))
        .add_model(ModelSpec("retrieval", "retrieval", (vis, txt), cos))
        .add_model(ModelSpec("classify", "classification", (vis,), cls))
        .plan("greedy", routing="paper"))


def test_verify_deployment_with_kernels():
    diags = _dep().verify(kernels=True)
    assert errors(diags) == [], format_report(diags)
    assert sum(d.code == "kernel/summary" for d in diags) == len(
        kc.zoo_cases())
