"""Quickstart: build an assigned architecture, train a few steps on the
synthetic corpus, then generate with the continuous-batching server.

    PYTHONPATH=src python -m repro_torch.examples.quickstart \\
        [--arch tinyllama-1.1b] [--steps 20] [--device cpu]

The config is the arch's reduced smoke config.  It runs on the card
unless ``--device`` names another: training differentiates through the
plain-torch path (the kernels have no backward) and serving decodes
through the paged kernel.

This file covers the single-model train/serve loop.  For the paper's
actual contribution — multi-task, multi-device split-and-share serving —
the stable entry point is the ``repro_torch.s2m3.Deployment`` facade:

    from repro_torch.s2m3 import Deployment, Request
    dep = (Deployment(cluster)
           .add_model(spec, builders)
           .plan(placement="greedy", routing="queue_aware")
           .materialize())
    dep.simulate(workload)   # predicted latency + memory ledger
    dep.submit(workload[0])  # real compute, same Request object

See ``repro_torch.examples.multi_task_serving`` (live engine) and
``repro_torch.examples.edge_placement_sim`` (testbed simulator) for full
tours, and the "Public API" section of ROADMAP.md.
"""

import argparse

import torch

from repro_torch.common.config import TrainConfig, get_config
from repro_torch.common.device import resolve_device
from repro_torch.core.routing import Request
from repro_torch.models.api import build_model
from repro_torch.serving.scheduler import lm_scheduler
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import init_state
from repro_torch.training.train_step import batch_to_tensors, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_config(args.arch, smoke=True)   # reduced config: CPU-friendly
    print(f"arch={cfg.name} family={cfg.family} (reduced smoke config)")
    bundle = build_model(cfg, compute_dtype=torch.float32)
    print(f"params: {bundle.param_count():,}")

    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5,
                       total_steps=args.steps)
    state = init_state(bundle.init(torch.Generator(device=device)
                                   .manual_seed(0), device=device), tcfg)
    step = make_train_step(bundle, tcfg)
    data = TokenStream(DataConfig(seq_len=64, global_batch=8,
                                  vocab_size=cfg.vocab_size))
    losses = []
    for i, batch in zip(range(args.steps), data):
        state, metrics = step(state, batch_to_tensors(batch, device))
        losses.append(float(metrics["loss"]))
        if i % 5 == 0 or i == args.steps - 1:
            print(f"step {i:3d}  loss {losses[-1]:.4f}  "
                  f"lr {float(metrics['lr']):.2e}")

    print("\nserving with continuous batching (paged KV decode):")
    sched = lm_scheduler(bundle, state["params"], device=device)
    reqs = [Request(rid=i, model="lm", source="dev0",
                    prompt=(1 + i, 2, 3), max_new_tokens=12)
            for i in range(6)]
    results = sched.serve(reqs)
    for r in results:
        print(f"  req {r.rid}: -> {[int(t) for t in r.output]}")
    st = sched.stats_dict()[cfg.name]
    print(f"  {st['decode_tokens']} tokens in {st['decode_steps']} batched "
          f"decode steps, peak pages {st['pages_peak']}")
    return losses, results


if __name__ == "__main__":
    main()
