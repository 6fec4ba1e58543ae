"""Training launcher: train any ``--arch`` the port has, on the card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
        --steps 20                         # published widths, on the card
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --steps 3 \\
        --device cpu --ckpt ckpt/          # CPU-sized smoke config

It resumes from the last committed checkpoint under ``--ckpt``, saves
one asynchronously every ``--ckpt-every`` steps and one at the end.
Weights are random, drawn on the device from seed 0; data is the
synthetic ``TokenStream`` corpus unless ``--data`` names a token file.
The loss differentiates through plain torch (``attn_impl="xla"``): the
hand-written kernels have no backward.

It runs one process: multi-process training (``torch.distributed``,
sharded state) arrives with the port's distributed slice, and a
``WORLD_SIZE`` above 1 raises.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import tempfile
import time

import torch

from repro_torch.common.config import TrainConfig, get_config, list_archs
from repro_torch.common.device import resolve_device
from repro_torch.models.api import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import init_state
from repro_torch.training.train_step import batch_to_tensors, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Train one arch in one process (multi-process training "
                    "arrives with the distributed slice; WORLD_SIZE > 1 "
                    "raises).")
    ap.add_argument("--arch", default="tinyllama-1.1b",
                    help=f"one of {', '.join(list_archs())}")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt", default="",
                    help="checkpoint directory (default: repro_torch_train/"
                         "<arch> under the temp directory)")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none", help="none | full | dots")
    ap.add_argument("--data", default="", help="token .bin file (synthetic "
                    "corpus if empty)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "CPU)")
    args = ap.parse_args(argv)
    if int(os.environ.get("WORLD_SIZE", "1")) > 1:
        raise RuntimeError(
            "repro_torch.launch.train runs one process; multi-process "
            "training arrives with the distributed slice")

    device = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    bundle = build_model(cfg, remat=args.remat)
    print(f"[train] {cfg.name} params={bundle.param_count():,} on {device}")

    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps, remat=args.remat,
                       microbatches=args.microbatches)
    state = init_state(bundle.init(torch.Generator(device=device)
                                   .manual_seed(0), device=device), tcfg)
    ckdir = pathlib.Path(args.ckpt or pathlib.Path(tempfile.gettempdir())
                         / "repro_torch_train" / cfg.name)
    if ckpt.latest_step(ckdir) is not None:
        state = ckpt.restore(state, ckdir)
        print(f"[train] resumed from step {int(state['step'])}")

    extra = {}
    if cfg.has_vision_stub:
        extra["image_embeds"] = ((cfg.n_image_tokens, cfg.d_model), "float32")
    if cfg.is_encoder_decoder:
        extra["audio_frames"] = ((cfg.encoder_seq, cfg.d_model), "float32")
    data = TokenStream(DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab_size=cfg.vocab_size,
        path=args.data or None), extra_features=extra)
    step_fn = make_train_step(bundle, tcfg)
    start = int(state["step"])
    pending = None
    t0 = time.perf_counter()
    for i, batch in zip(range(start, args.steps), data):
        state, metrics = step_fn(state, batch_to_tensors(batch, device))
        if (i + 1) % 10 == 0 or i + 1 == args.steps:
            print(f"[train] step {i + 1} loss={float(metrics['loss']):.4f} "
                  f"({(time.perf_counter() - t0) / (i + 1 - start):.2f}s/step)")
        if (i + 1) % args.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = ckpt.save_async(state, ckdir, step=i + 1)
    if pending is not None:
        pending.join()
    ckpt.save(state, ckdir, step=int(state["step"]))
    print(f"[train] done at step {int(state['step'])}; checkpoint in {ckdir}")
    return state


if __name__ == "__main__":
    main()
