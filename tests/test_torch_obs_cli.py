"""``python -m repro_torch.obs``: the self-test (span nesting, metrics
thread safety, the instrument-lock lint over ``repro_torch.obs``), and
the demo ``trace`` and ``drift`` commands on the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.diagnostics import errors
from repro_torch.obs import __main__ as cli
from repro_torch.obs.selftest import self_test

ROOT = Path(__file__).resolve().parent.parent


def test_obs_self_test_passes():
    diags = self_test()
    assert not errors(diags)
    assert [d.code for d in diags] == ["obs/self-test"]


def test_cli_self_test_exit_code():
    out = subprocess.run([sys.executable, "-m", "repro_torch.obs",
                          "--self-test"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    assert out.returncode == 0, out.stderr
    assert "0 error(s)" in out.stdout


def test_trace_on_cpu_writes_a_valid_span_tree(tmp_path, capsys):
    path = tmp_path / "t.json"
    assert cli.main(["trace", str(path), "-n", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "MALFORMED" not in out and "on cpu" in out
    events = json.loads(path.read_text())["traceEvents"]
    assert events
    # the SLO table: both tasks at 100 % attainment
    rows = [ln.split() for ln in out.splitlines()
            if ln.startswith(("classify", "score"))]
    assert [(r[0], r[1], r[-1]) for r in rows] == [
        ("classify", "2", "100%"), ("score", "2", "100%")]


def test_demo_trees_validate_and_batch_across_tasks():
    dep = cli._demo_deployment(torch.device("cpu"))
    dep.serve(cli._demo_workload(4))
    trace = dep.trace()
    assert trace.validate() == []
    assert dep.scheduler.stats_dict()["demo-enc"]["cross_task_batches"] >= 1


def test_drift_on_cpu_has_no_route_divergence(capsys):
    assert cli.main(["drift", "-n", "4", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "0 divergence(s)" in out


def test_demo_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["drift"])
