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

Multi-process: launch it under ``torch.distributed.run`` (which sets
``WORLD_SIZE``, ``RANK`` and the rendezvous), e.g.

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc_per_node 2 -m repro_torch.launch.train --smoke --steps 2 \
        --device cpu

With ``WORLD_SIZE`` above 1 it initialises the process group (NCCL on
the card, one card a rank by ``LOCAL_RANK``; gloo with ``--device
cpu``), as the reference calls ``jax.distributed.initialize()`` when
``JAX_NUM_PROCESSES`` is set.  The data stream shards by process (rank r
of n takes rows r·B/n .. (r+1)·B/n of each global batch) and each rank
checkpoints under ``proc<rank>``.  Like the reference's launcher it
builds no mesh, so each rank trains its own replica on its data shard:
no gradient is averaged across ranks.
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
        description="Train one arch; under torch.distributed.run each rank "
                    "trains its own replica on its shard of the data "
                    "(WORLD_SIZE ranks, no gradient averaged).")
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
    device = resolve_device(args.device)
    world = int(os.environ.get("WORLD_SIZE", "1"))
    rank = 0
    if world > 1:
        import torch.distributed as dist

        if device.type == "cuda":
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             "0")))
            torch.cuda.set_device(device)
        dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
        rank = dist.get_rank()
    try:
        return _train(args, device, rank, world)
    finally:
        if world > 1:
            dist.destroy_process_group()


def _train(args, device, rank: int, world: int):
    cfg = get_config(args.arch, smoke=args.smoke)
    bundle = build_model(cfg, compute_dtype=torch.float32, remat=args.remat)
    print(f"[train] {cfg.name} params={bundle.param_count():,} on {device} "
          f"procs={world} rank={rank}")

    tcfg = TrainConfig(learning_rate=args.lr, warmup_steps=10,
                       total_steps=args.steps, remat=args.remat,
                       microbatches=args.microbatches)
    state = init_state(bundle.init(torch.Generator(device=device)
                                   .manual_seed(0), device=device), tcfg)
    ckdir = pathlib.Path(args.ckpt or pathlib.Path(tempfile.gettempdir())
                         / "repro_torch_train" / cfg.name)
    if ckpt.latest_step(ckdir) is not None:
        state = ckpt.restore(state, ckdir, process_index=rank)
        print(f"[train] resumed from step {int(state['step'])}")

    extra = {}
    if cfg.has_vision_stub:
        extra["image_embeds"] = ((cfg.n_image_tokens, cfg.d_model), "float32")
    if cfg.is_encoder_decoder:
        extra["audio_frames"] = ((cfg.encoder_seq, cfg.d_model), "float32")
    data = TokenStream(DataConfig(
        seq_len=args.seq, global_batch=args.batch, vocab_size=cfg.vocab_size,
        path=args.data or None, process_index=rank, process_count=world),
        extra_features=extra)
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
            pending = ckpt.save_async(state, ckdir, step=i + 1,
                                      process_index=rank)
    if pending is not None:
        pending.join()
    ckpt.save(state, ckdir, step=int(state["step"]), process_index=rank)
    print(f"[train] done at step {int(state['step'])}; checkpoint in {ckdir}")
    return state


if __name__ == "__main__":
    main()
