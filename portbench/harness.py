"""One run of one cell: set-up, the measured window, the check.

``run()`` finds everything by name: the cell in ``BENCHMARK.json``, its
configuration's sizes (the manifest's ``file``) and builder (the same
path ending in ``.py``), its traffic mix (``traffic/<name>.json``) and a
reader for each of its metrics (``metrics/<name>.py``, or, where there
is none, ``metrics/<base>.py`` for a name ``<base>.<suffix>``).  The entry it
drives is the ``ServeScheduler`` of a materialized ``s2m3.Deployment``
of the port: ``submit()`` as requests fall due (open loop) or as clients
get their answers (closed loop), ``step()`` in between.

Set-up (``setup_s``, from the process's start to the window's open):
the imports, the weights drawn on the device from the seed, the input
pool, one pass over each shape the cell's traffic uses (the builder's
``warm_groups``), and, for a closed loop, the fill: every client's
first request submitted, then ``lead_in`` completions (the clients'
number by default) with each client sending its next.  The window then
runs for ``--seconds`` of the host's clock.  An open loop stops sending
at the close and waits, up to ``GRACE_S``, for every request that fell
due in it.  ``memory_peak_bytes`` is read, the program's state freed,
and the builder's ``check`` holds what the window served to the plain
reference.  With ``--trace 1`` the profiler records the window's last
``trace_slice_s`` seconds, which the device metrics read; the span
metrics read the rest.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import random
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from portbench import devtrace, traffic
from portbench.weights import sub_seed

#: seconds an open loop waits past the close for the requests due in
#: the window; a request not done by then failed
GRACE_S = 60.0
#: the profiler's slice of a ``--trace 1`` window, unless the mix says
TRACE_SLICE_S = 2.0


class Fault(RuntimeError):
    """The run cannot give a result (a refused plan, a bad manifest)."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise Fault(f"no module at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A manifest entry with everything it names loaded."""

    name: str
    root: Path
    workload: dict
    sizes: dict            # the configuration's file
    mix: dict              # traffic/<name>.json
    builder: object        # configs/<name>.py
    end_to_end: list       # the metric entries this cell reports
    per_layer: list

    def reader(self, metric: str):
        return load_module(reader_path(self.root / "portbench" / "metrics",
                                       metric), f"portbench_metric_{metric}")


def reader_path(metrics: Path, name: str) -> Path:
    """``<name>.py``, else ``<base>.py`` for ``<base>.<suffix>``: one
    reader serves a quantity whose suffix names the metric it moves."""
    path = metrics / f"{name}.py"
    if not path.is_file() and "." in name:
        path = metrics / f"{name.rsplit('.', 1)[0]}.py"
    return path


def _reports(metric: dict, cell: str, e2e_names: set | None) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return e2e_names is None or metric["moves"] in e2e_names


def load_cell(root: Path, name: str) -> Cell:
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise Fault(f"no workload {name!r} in BENCHMARK.json "
                    f"(has {sorted(cells)})")
    w = cells[name]
    config = next(c for c in manifest["configs"] if c["name"] == w["config"])
    file = root / config["file"]
    sizes = json.loads(file.read_text())
    builder = load_module(file.with_suffix(".py"),
                          "portbench_config_" + config["name"].replace(
                              "-", "_").replace(".", "_"))
    mix = traffic.load_mix(root / "portbench" / "traffic"
                           / f"{w['traffic']}.json")
    e2e = [m for m in manifest["end_to_end"] if _reports(m, name, None)]
    names = {m["name"] for m in e2e}
    per = [m for m in manifest["per_layer"] if _reports(m, name, names)]
    return Cell(name, root, w, sizes, mix, builder, e2e, per)


@dataclass(slots=True)
class Rec:
    """What the harness saw of one request (slots: the harness adds as
    few objects as it can to the heap the program's collector walks)."""

    spec: traffic.Spec
    due: float = math.nan          # host clock (open loop)
    t_submit: float = math.nan
    t_finish: float = math.nan
    n_tokens: int = 0
    tokens: object = None          # served tokens (generative)


@dataclass
class Window:
    """Everything a metric reader reads: the harness's own clock and
    counts, the program's spans and counters, the profiler's slice."""

    bench: object                  # the builder's Bench
    setup_s: float
    t_open: float
    t_close: float                 # the end of the last step begun in it
    recs: dict                     # rid -> Rec
    due: list                      # open loop: rids due in the window
    finished_in: int               # requests finished in the window
    stats_open: dict               # scheduler stats_dict() at the open
    stats_close: dict
    spans: list                    # the program's spans, all of the run
    win: tuple                     # sids [open, close)
    slice: tuple | None            # sids [start, stop) of the profiled slice
    clock_offset: float            # host clock = span time + offset
    peak_bytes: int
    trace: object = None           # devtrace.Slice
    calls: list = field(default_factory=list)       # unique calls in win
    slice_calls: list = field(default_factory=list)  # unique calls in slice

    @property
    def window_s(self) -> float:
        return self.t_close - self.t_open

    def span_metric_calls(self) -> list:
        """The window's calls outside the profiled slice (the profiler
        slows the host while it records)."""
        if self.slice is None:
            return self.calls
        a, b = self.slice
        return [c for c in self.calls if not a <= c["sid"] < b]

    def stat_delta(self, key: str) -> float:
        tot = 0.0
        for mod, row in self.stats_close.items():
            tot += row.get(key, 0) - self.stats_open.get(mod, {}).get(key, 0)
        return tot


def unique_calls(spans, lo: int, hi: int, recs: dict) -> list:
    """The device calls the spans with sids in [lo, hi) record: spans of
    one batched call share (module, phase, t0, t1) and become one call
    with the list of its rids.  A decode tick's rows also get each rid's
    tick count (the keys its row holds follow from it)."""
    ticks: dict = {}
    calls: dict = {}
    for s in spans:
        if s.phase == "decode_tick":
            ticks[s.rid] = ticks.get(s.rid, 0) + 1
        if not lo <= s.sid < hi or s.phase not in (
                "encode", "head", "prefill", "decode_tick"):
            continue
        key = (s.name, s.phase, s.t0, s.t1)
        c = calls.get(key)
        if c is None:
            c = calls[key] = {"module": s.name, "phase": s.phase,
                              "t0": s.t0, "t1": s.t1, "sid": s.sid,
                              "rids": [], "ticks": [],
                              "attrs": dict(s.attrs)}
        c["rids"].append(s.rid)
        c["ticks"].append(ticks.get(s.rid, 0) - 1)
    out = list(calls.values())
    for c in out:
        c["specs"] = [recs[r].spec if r in recs else None for r in c["rids"]]
    return out


class Driver:
    """Drives a ``ServeScheduler`` with a traffic plan."""

    def __init__(self, bench, plan: traffic.Plan, sched, keep_sample: int,
                 seed: int):
        self.bench = bench
        self.plan = plan
        self.sched = sched
        self.recs: dict[int, Rec] = {}
        self.ready: list[int] = []        # closed loop: clients to resubmit
        # the sample the check holds to the reference: per task, a
        # reservoir over the answers that come once the window is open
        self.reservoir: dict[str, list] = {}
        self.seen_by_task: dict[str, int] = {}
        self.quota = -(-keep_sample // len(plan.mix["tasks"]))
        self.rng = random.Random(sub_seed(seed, "sample"))
        self.next_k = plan.clients
        self.window = None                # (t_open, t_close) while counting
        self.finished_in = 0
        self.client_of: dict[int, int] = {}

    # -- the scheduler's on_finish hook --------------------------------
    def on_finish(self, result) -> None:
        t = time.perf_counter()
        rec = self.recs.get(result.rid)
        # the harness is the client: it takes the answer, the scheduler
        # keeps nothing of a finished request
        self.sched.results.pop(result.rid, None)
        if rec is None:                   # a warm-up request
            return
        rec.t_finish = t
        out = result.output
        if isinstance(out, np.ndarray) and out.dtype.kind == "i":
            rec.n_tokens = int(out.shape[0])
            rec.tokens = out
        if self.window is not None and self.window[0] <= t:
            if self.window[1] is None or t < self.window[1]:
                self.finished_in += 1
        if self.window is not None:
            self._sample(rec.spec.task, result)
        if result.rid in self.client_of:
            self.ready.append(self.client_of.pop(result.rid))

    def _sample(self, task: str, result) -> None:
        """Seeded reservoir sampling: each of a task's n answers so far
        is in its reservoir with the same chance, quota / n."""
        n = self.seen_by_task.get(task, 0) + 1
        self.seen_by_task[task] = n
        res = self.reservoir.setdefault(task, [])
        if len(res) < self.quota:
            res.append((result.rid, self.bench.keep(result)))
        else:
            j = self.rng.randrange(n)
            if j < self.quota:
                res[j] = (result.rid, self.bench.keep(result))

    @property
    def kept(self) -> dict:
        return {rid: out for res in self.reservoir.values()
                for rid, out in res}

    def submit(self, spec, due: float = math.nan, client: int | None = None):
        rec = Rec(spec, due=due, t_submit=time.perf_counter())
        self.recs[spec.rid] = rec
        if client is not None:
            self.client_of[spec.rid] = client
        self.sched.submit(self.bench.request(spec))

    def resubmit_ready(self) -> None:
        """Closed loop: each client with its answer sends its next
        request (none once the window has closed)."""
        if self.plan is None:
            return
        while self.ready:
            client = self.ready.pop(0)
            spec = self.plan.closed_spec(self.next_k)
            self.next_k += 1
            self.submit(spec, client=client)


def _warm(bench, sched) -> None:
    """One pass over every shape the cell uses: each group is submitted
    at once (so the encoders see its batch) and served to the end."""
    for group in bench.warm_groups():
        for req in group:
            sched.submit(req)
        while sched.step():
            pass


def _mark(sched) -> int:
    """The next span id of the program's tracer (a marker span)."""
    sid = sched.tracer.begin("portbench", "mark")
    sched.tracer.end(sid)
    return sid


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device, t_start: float | None = None, control: bool = False,
        mix: dict | None = None) -> dict:
    """One run; returns the result line's object (``correct`` and all).
    With ``control`` the result also holds ``control``: the same numbers
    with the reference at TF32 in the program's place (never in a run of
    the benchmark's own command).  ``mix`` overrides keys of the cell's
    mix (the knee sweep's rates)."""
    t_start = time.perf_counter() if t_start is None else t_start
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = load_cell(root, workload)
    cell.mix.update(mix or {})
    device = torch.device(device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    mix = cell.mix
    bench = cell.builder.Bench(cell.sizes, mix, seed, device)
    plan = traffic.make_plan(mix, seed, seconds)
    sched = bench.scheduler()
    driver = Driver(bench, plan, sched, int(mix.get("sample", 16)), seed)
    sched.on_finish = driver.on_finish
    _warm(bench, sched)
    if trace:
        devtrace.stop(devtrace.start(device))    # the profiler's own set-up
    bench.synchronize()
    t_warm = time.perf_counter()
    log(f"[portbench] {workload}: built and warmed in "
        f"{t_warm - t_start:.2f} s")

    # -- closed loop: the fill ----------------------------------------
    if plan.loop == "closed":
        for c in range(plan.clients):
            driver.submit(plan.specs[c], client=c)
        done = 0
        while done < int(mix.get("lead_in", plan.clients)):
            if not sched.step():
                break
            driver.resubmit_ready()
            done = sum(1 for r in driver.recs.values()
                       if not math.isnan(r.t_finish))
        log(f"[portbench] fill: {len(driver.recs)} requests submitted, "
            f"{done} done in {time.perf_counter() - t_warm:.2f} s")
    bench.synchronize()

    # -- the window ---------------------------------------------------
    # a full collection, then the set-up's heap frozen: every run opens
    # its window with the collector in the same state, and its passes
    # in the window walk what the window made, not the harness's plan
    # and input pool or the program's loaded modules
    gc.collect()
    gc.freeze()
    slice_len = float(mix.get("trace_slice_s", TRACE_SLICE_S))
    slice_at = max(0.0, seconds - slice_len)
    prof = None
    slice_sids = None
    slice_wall = None
    stats_open = sched.stats_dict()
    sid_open = _mark(sched)
    clock_offset = time.perf_counter() - sched.tracer.clock()
    t_open = time.perf_counter()
    t_end = t_open + seconds
    driver.window = (t_open, None)
    due = []
    i_next = 0
    specs = plan.specs if plan.loop == "open" else []
    while True:
        now = time.perf_counter()
        if now >= t_end:
            break
        if trace and prof is None and now >= t_open + slice_at:
            bench.synchronize()
            prof = devtrace.start(device)
            slice_wall = [time.perf_counter(), None]
            slice_sids = [_mark(sched), None]
        while i_next < len(specs) and t_open + specs[i_next].due <= now:
            s = specs[i_next]
            driver.submit(s, due=t_open + s.due)
            due.append(s.rid)
            i_next += 1
        if not sched.step():
            if plan.loop == "open" and i_next < len(specs):
                wait = t_open + specs[i_next].due - time.perf_counter()
                if wait > 0:
                    time.sleep(min(wait, 0.001))
            elif plan.loop == "closed" and not driver.ready:
                raise Fault("closed loop went idle: no request in flight")
        driver.resubmit_ready()
    bench.synchronize()
    t_close = time.perf_counter()
    driver.window = (t_open, t_close)
    sid_close = _mark(sched)
    stats_close = sched.stats_dict()
    if prof is not None:
        slice_wall[1] = t_close
        slice_sids[1] = sid_close
        devtrace.stop(prof)
    # requests in flight stop here for a closed loop; an open loop waits
    # for every request due in the window
    driver.plan = None
    failed = 0
    if plan.loop == "open":
        deadline = time.perf_counter() + GRACE_S
        pending = [r for r in due if math.isnan(driver.recs[r].t_finish)]
        while pending and time.perf_counter() < deadline:
            if not sched.step():
                break
            pending = [r for r in pending
                       if math.isnan(driver.recs[r].t_finish)]
        failed = len(pending)
        attempted = len(due)
    else:
        attempted = sum(1 for r in driver.recs.values()
                        if r.t_submit >= t_open
                        or not r.t_finish < t_open)
    bench.synchronize()
    gc.unfreeze()
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    spans = sched.tracer.trace.spans
    win = Window(bench=bench, setup_s=t_open - t_start, t_open=t_open,
                 t_close=t_close, recs=driver.recs, due=due,
                 finished_in=driver.finished_in,
                 stats_open=stats_open, stats_close=stats_close, spans=spans,
                 win=(sid_open, sid_close),
                 slice=tuple(slice_sids) if slice_sids else None,
                 clock_offset=clock_offset, peak_bytes=int(peak))
    win.calls = unique_calls(spans, sid_open, sid_close, driver.recs)
    if slice_sids:
        win.slice_calls = unique_calls(spans, *slice_sids, driver.recs)
        win.trace = devtrace.read(prof, slice_wall[1] - slice_wall[0])
    log(f"[portbench] window {win.window_s:.3f} s: {len(driver.recs)} "
        f"requests seen, {driver.finished_in} finished in it, peak "
        f"{peak / 1e9:.3f} GB")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = cell.reader(m["name"]).read(win)
        if value is None:
            continue
        metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = bench.device_info(peak)
    if trace:
        tr = win.trace
        device_info["busy_s"] = tr.busy_s if tr else 0.0
        device_info["window_s"] = tr.window_s if tr else 0.0
    breakdown = win.trace.breakdown() if (trace and win.trace) else None

    # -- the check, on the program's outputs, once its state is freed --
    finished = {rid: r for rid, r in driver.recs.items()
                if not math.isnan(r.t_finish)}
    served_in = driver.finished_in
    kept = driver.kept
    del win, sched, driver, spans
    t_check = time.perf_counter()
    checks = bench.check(kept, finished, seed)
    log(f"[portbench] check in {time.perf_counter() - t_check:.2f} s")
    controls = bench.check(kept, finished, seed, control=True) \
        if control else None
    limits = cell.sizes["limits"]
    numbers = {k: {"value": float(v), "limit": float(limits[k])}
               for k, v in checks.items()}
    correct = failed == 0 and bool(numbers) and all(
        math.isfinite(n["value"]) and n["value"] <= n["limit"]
        for n in numbers.values())
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device_info,
           "served": {"in_window": served_in}}
    if breakdown is not None:
        out["breakdown"] = breakdown
    if controls is not None:
        out["control"] = {k: float(v) for k, v in controls.items()}
    out["checks"] = numbers
    return out

