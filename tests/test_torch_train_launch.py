"""The port's train launcher (``repro_torch.launch.train``) and the
examples of the training slice, on the CPU: the launcher trains
tinyllama-1.1b's smoke config, and run again resumes from its last
committed checkpoint; under ``torch.distributed.run`` each rank trains
its replica on its shard of the reference's data stream; the quickstart
trains and serves; ``train_lm`` trains, checkpoints and resumes; the
port's ``edge_placement_sim`` prints what the reference's prints."""

import contextlib
import io
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
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
    """Without WORLD_SIZE it is one process with no process group."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    _, log = _run(launch_train.main, ["--device", "cpu", "--smoke",
                                      "--steps", "1", "--seq", "16",
                                      "--batch", "2", "--ckpt",
                                      str(tmp_path)])
    assert "procs=1 rank=0" in log
    assert not torch.distributed.is_initialized()
    assert (tmp_path / "step_00000001" / "proc0").is_dir()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--help"],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "torch.distributed.run" in out.stdout


def test_launcher_trains_a_replica_a_rank_under_torch_distributed_run(
        tmp_path):
    """``torch.distributed.run --nproc_per_node 2``: gloo on the CPU, each
    rank trains its own replica on its data shard and checkpoints under
    proc<rank>.  Each rank's batches are the reference TokenStream's for
    that process, and its checkpoint is what one process training on
    those batches reaches."""
    from repro.training.data import DataConfig as RefDataConfig
    from repro.training.data import TokenStream as RefTokenStream
    from repro_torch.common.config import TrainConfig, get_config
    from repro_torch.models.api import build_model
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_step import (
        batch_to_tensors, make_train_step,
    )

    steps, seq, batch = 2, 16, 4
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "repro_torch.launch.train",
         "--smoke", "--steps", str(steps), "--seq", str(seq), "--batch",
         str(batch), "--device", "cpu", "--ckpt", str(tmp_path)],
        cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "procs=2 rank=0" in out.stdout and "procs=2 rank=1" in out.stdout
    final = tmp_path / f"step_{steps:08d}"
    assert (final / "proc0").is_dir() and (final / "proc1").is_dir()
    assert ckpt.latest_step(tmp_path) == steps

    cfg = get_config("tinyllama-1.1b", smoke=True)
    bundle = build_model(cfg, remat="none", compute_dtype=torch.float32)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10,
                       total_steps=steps, remat="none", microbatches=1)
    replicas = []
    for rank in range(2):
        kw = dict(seq_len=seq, global_batch=batch,
                  vocab_size=cfg.vocab_size, process_index=rank,
                  process_count=2)
        stream = TokenStream(DataConfig(**kw))
        mine = [next(stream) for _ in range(steps)]
        ref = RefTokenStream(RefDataConfig(**kw))
        for b in mine:
            want = next(ref)
            assert set(b) == set(want)
            for k in b:
                np.testing.assert_array_equal(b[k], want[k])
        state = init_state(bundle.init(torch.Generator().manual_seed(0),
                                       device="cpu"), tcfg)
        step = make_train_step(bundle, tcfg)
        for b in mine:
            state, _ = step(state, batch_to_tensors(b, "cpu"))
        saved = ckpt.restore(state, tmp_path, process_index=rank)
        assert int(saved["step"]) == steps
        for a, w in zip(tree_leaves(saved), tree_leaves(state)):
            torch.testing.assert_close(a, w, rtol=1e-5, atol=1e-6)
        replicas.append(saved)
    # the replicas saw other data: no gradient was averaged
    assert not all(torch.equal(a, b) for a, b in
                   zip(tree_leaves(replicas[0]["params"]),
                       tree_leaves(replicas[1]["params"])))


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
