"""End-to-end training driver: train a small LM on the synthetic corpus
with checkpointing and crash-resume.

    PYTHONPATH=src python -m repro_torch.examples.train_lm --steps 100 \\
        [--params 10m|100m] [--ckpt ckpt/] [--resume] [--device cpu]

The 100m preset is the "~100M model for a few hundred steps"
configuration; the 10m preset finishes quickly on a CPU.  It runs on the
card unless ``--device`` names another (the paper's kind is serving, so
the end-to-end driver of the paper is
``repro_torch.examples.multi_task_serving``; this one exercises the
training substrate end to end).
"""

import argparse
import pathlib
import tempfile
import time

import torch

from repro_torch.common.config import ArchConfig, TrainConfig
from repro_torch.common.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import init_state
from repro_torch.training.train_step import batch_to_tensors, make_train_step

PRESETS = {
    "10m": ArchConfig(name="lm-10m", family="dense", n_layers=4, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=1024, vocab_size=8192),
    "100m": ArchConfig(name="lm-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv_heads=4, d_ff=2048,
                       vocab_size=32000),
}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="10m", choices=sorted(PRESETS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt", default=str(pathlib.Path(tempfile.gettempdir())
                                          / "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = PRESETS[args.params]
    bundle = build_model(cfg, compute_dtype=torch.float32, remat="none")
    print(f"{cfg.name}: {bundle.param_count():,} params on {device}")
    tcfg = TrainConfig(learning_rate=6e-4, warmup_steps=20,
                       total_steps=args.steps, remat="none")
    state = init_state(bundle.init(torch.Generator(device=device)
                                   .manual_seed(0), device=device), tcfg)

    ckdir = pathlib.Path(args.ckpt) / cfg.name
    if args.resume and ckpt.latest_step(ckdir) is not None:
        state = ckpt.restore(state, ckdir)
        print(f"resumed from step {int(state['step'])}")

    step_fn = make_train_step(bundle, tcfg)
    data = TokenStream(DataConfig(seq_len=args.seq, global_batch=args.batch,
                                  vocab_size=cfg.vocab_size))
    start = int(state["step"])
    t0 = time.time()
    losses = []
    for i, batch in zip(range(start, args.steps), data):
        state, metrics = step_fn(state, batch_to_tensors(batch, device))
        losses.append(float(metrics["loss"]))
        if (i + 1) % 10 == 0:
            tok_s = args.batch * args.seq * (i + 1 - start) / (time.time() - t0)
            print(f"step {i+1:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.2f}  {tok_s:,.0f} tok/s")
        if (i + 1) % args.ckpt_every == 0:
            ckpt.save(state, ckdir, step=i + 1)
            print(f"  checkpointed step {i+1}")
    ckpt.save(state, ckdir, step=int(state["step"]))
    print("done; final checkpoint at", ckdir)
    return state, losses


if __name__ == "__main__":
    main()
