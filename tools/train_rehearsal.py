#!/usr/bin/env python3
"""The loss curve of ``chip_smoke.py`` phase 11(a) at a depth the CPU can
hold: tinyllama-1.1b at full width (d_model 2048, 32 q / 4 kv heads,
vocabulary 32,000) with ``--layers`` layers, ``--steps`` steps of
``make_train_step`` on the synthetic ``TokenStream`` corpus at the train
launcher's defaults (seq 128, batch 8, lr 1e-3, warmup 10), float32,
weights from ``--seed``.  Prints each step's loss and grad norm, and the
drop from the first loss to the mean of the last 5: the margin phase 11
holds the full-depth run on the card to is set from it.

    PYTHONPATH=src python3 tools/train_rehearsal.py --layers 2 --seed 0
    PYTHONPATH=src python3 tools/train_rehearsal.py --layers 6

At 2 layers the state takes ~3.5 GB and a step ~5 s on 6 CPU threads;
at 6 layers ~6.3 GB and ~9 s.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.common.config import TrainConfig, get_config  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.training.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.training.optimizer import init_state  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    batch_to_tensors, make_train_step,
)


def main(argv=None) -> float:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--threads", type=int, default=6)
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)
    cfg = get_config("tinyllama-1.1b").with_overrides(n_layers=args.layers)
    bundle = build_model(cfg, remat="none", compute_dtype=torch.float32)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=10,
                       total_steps=args.steps)
    state = init_state(bundle.init(torch.Generator().manual_seed(args.seed),
                                   device=args.device), tcfg)
    step = make_train_step(bundle, tcfg)
    data = TokenStream(DataConfig(seq_len=128, global_batch=8,
                                  vocab_size=cfg.vocab_size))
    losses = []
    for i, batch in zip(range(args.steps), data):
        t = time.perf_counter()
        state, m = step(state, batch_to_tensors(batch, args.device))
        losses.append(float(m["loss"]))
        print(f"step {i + 1}: loss {losses[-1]:.4f}, grad norm "
              f"{float(m['grad_norm']):.3f}, {time.perf_counter() - t:.1f} s",
              flush=True)
    drop = losses[0] - sum(losses[-5:]) / 5
    print(f"layers {args.layers}, seed {args.seed}: first {losses[0]:.4f}, "
          f"mean of the last 5 {sum(losses[-5:]) / 5:.4f}, drop {drop:.4f}")
    return drop


if __name__ == "__main__":
    main()
