"""The whole run of each cell at smoke size on the CPU: the port against
the plain reference, the result line's shape, a cell added by new files
alone, and the entry point's refusals."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, SEED, smoke_copy
from portbench import harness

CELLS = [w["name"] for w in
         json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_smoke_port_matches_the_reference(smoke_root, cell):
    out = harness.run(smoke_root, cell, SEED, 1.5, False, "cpu")
    assert out["correct"], out["checks"]
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert "setup_s" in out["metrics"]
    for name, n in out["checks"].items():
        assert 0.0 <= n["value"] <= n["limit"], name
        # the plain versions on the CPU compute the reference's function
        assert n["value"] < 1e-5, name


def test_trace_run_reports_per_layer_metrics(smoke_root):
    out = harness.run(smoke_root, "internvl2-1b.chat", SEED + 1, 1.5, True,
                      "cpu")
    assert out["correct"]
    assert "mfu.tok" in out["metrics"] and "setup_s" not in out["metrics"]
    assert {"busy_s", "window_s"} <= set(out["device"])


def test_a_cell_added_by_new_files_alone(tmp_path):
    """A configuration, a mix and a metric, each a new file, and new
    manifest entries: the harness runs the cell unchanged."""
    root = smoke_copy(tmp_path)
    pb = root / "portbench"
    shutil.copy(pb / "configs" / "clip-vit-b16-mt.json",
                pb / "configs" / "clip-tiny.json")
    shutil.copy(pb / "configs" / "clip-vit-b16-mt.py",
                pb / "configs" / "clip-tiny.py")
    (pb / "traffic" / "tiny-burst.json").write_text(json.dumps({
        "loop": "open", "rate": 40.0,
        "burst": {"period_s": 0.5, "on_share": 0.5},
        "tasks": [{"task": "retrieval", "share": 2},
                  {"task": "vqa", "share": 1}],
        "scheduler": {"max_batch": 4, "max_queue_depth": 64},
        "pool": 8, "sample": 8, "trace_slice_s": 0.3}))
    (pb / "metrics" / "head_calls_per_s.py").write_text(
        '"""Head calls a second of the window."""\n\n\n'
        'def read(w):\n'
        '    n = sum(1 for c in w.calls if c["phase"] == "head")\n'
        '    return n / w.window_s\n')
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "clip-tiny", "source": "test",
                         "file": "portbench/configs/clip-tiny.json",
                         "reduced": [], "why": "test"})
    m["workloads"].append({"name": "clip-tiny.burst", "config": "clip-tiny",
                           "traffic": "tiny-burst", "chips": 1,
                           "why": "test"})
    m["end_to_end"][0]["workloads"].append("clip-tiny.burst")
    m["per_layer"].append({"name": "head_calls_per_s", "unit": "calls/s",
                           "better": "higher", "source": "program_span",
                           "layer": "serving.scheduler",
                           "moves": "ttft_p95_ms",
                           "workloads": ["clip-tiny.burst"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    e2e = harness.run(root, "clip-tiny.burst", SEED, 1.5, False, "cpu")
    assert e2e["correct"] and "ttft_p95_ms" in e2e["metrics"]
    per = harness.run(root, "clip-tiny.burst", SEED, 1.5, True, "cpu")
    assert per["metrics"]["head_calls_per_s"]["value"] > 0


def _entry(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "clip-b16.poisson",
         "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_entry_point_refuses_without_a_card():
    res = _entry(ROOT)
    assert res.returncode == 2 and res.stdout.strip() == ""


def test_entry_point_refuses_without_the_program(tmp_path):
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench")
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    res = _entry(tmp_path)
    assert res.returncode != 0 and res.stdout.strip() == ""


def test_jax_is_found_by_whole_top_level_names(monkeypatch):
    sys.path.insert(0, str(ROOT / "portbench"))
    try:
        import run
    finally:
        sys.path.pop(0)
    assert "repro" not in run.forbidden_loaded()
    monkeypatch.setitem(sys.modules, "repro.fake", object())
    assert run.forbidden_loaded() == ["repro"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_card_runs_each_cell_at_smoke_size(card, smoke_root, cell):
    """On the card: the kernels' path at smoke size, against the plain
    reference, with a profiled slice."""
    out = harness.run(smoke_root, cell, SEED + 11, 2.0, True, card)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert 0.0 < out["device"]["busy_s"] <= out["device"]["window_s"]
