"""The port's train launcher (``repro_torch.launch.train``) and the
examples of the training slice, on the CPU: the launcher trains
tinyllama-1.1b's smoke config, and run again resumes from its last
committed checkpoint; it refuses a multi-process launch; the quickstart
trains and serves; ``train_lm`` trains, checkpoints and resumes; the
port's ``edge_placement_sim`` prints what the reference's prints."""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.common.pytree import tree_leaves
from repro_torch.launch import train as launch_train
from repro_torch.training import checkpoint as ckpt

ROOT = Path(__file__).resolve().parent.parent


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


def test_launcher_trains_and_resumes_from_its_checkpoint(tmp_path):
    argv = ["--device", "cpu", "--smoke", "--steps", "3", "--seq", "16",
            "--batch", "4", "--ckpt", str(tmp_path)]
    first, log1 = _run(launch_train.main, argv)
    assert int(first["step"]) == 3 and "resumed" not in log1
    assert ckpt.latest_step(tmp_path) == 3
    again, log2 = _run(launch_train.main, argv)
    assert "resumed from step 3" in log2
    assert int(again["step"]) == 3
    for a, b in zip(tree_leaves(first), tree_leaves(again)):
        assert torch.equal(a, b)
    more, log3 = _run(launch_train.main, argv[:4] + ["5"] + argv[5:])
    assert "resumed from step 3" in log3 and "step 5 loss=" in log3
    assert int(more["step"]) == 5 and ckpt.latest_step(tmp_path) == 5


def test_launcher_runs_one_process(monkeypatch, tmp_path):
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="one process"):
        launch_train.main(["--device", "cpu", "--smoke", "--ckpt",
                           str(tmp_path)])
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--help"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "one process" in out.stdout


def test_quickstart_trains_and_serves_on_cpu():
    from repro_torch.examples import quickstart

    (losses, results), log = _run(quickstart.main,
                                  ["--device", "cpu", "--steps", "8"])
    assert losses[-1] < losses[0]
    assert len(results) == 6 and all(len(r.output) == 12 for r in results)
    assert "batched decode steps" in log


def test_train_lm_checkpoints_and_resumes_on_cpu(tmp_path):
    from repro_torch.examples import train_lm

    argv = ["--device", "cpu", "--steps", "10", "--seq", "32", "--batch", "4",
            "--ckpt", str(tmp_path), "--ckpt-every", "5"]
    (state, losses), log = _run(train_lm.main, argv)
    assert int(state["step"]) == 10 and len(losses) == 10
    assert "checkpointed step 5" in log
    (state2, losses2), log2 = _run(train_lm.main, argv[:3] + ["12"]
                                   + argv[4:] + ["--resume"])
    assert "resumed from step 10" in log2
    assert int(state2["step"]) == 12 and len(losses2) == 2


def test_edge_placement_sim_prints_the_reference_output():
    import importlib.util

    from repro_torch.examples import edge_placement_sim

    spec = importlib.util.spec_from_file_location(
        "ref_edge_placement_sim", ROOT / "examples" / "edge_placement_sim.py")
    ref_sim = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref_sim)
    _, ours = _run(lambda argv: edge_placement_sim.main(), None)
    _, theirs = _run(lambda argv: ref_sim.main(), None)
    assert ours == theirs
    assert "sharing saving: 61.5%" in ours
