#!/usr/bin/env python3
"""What rematerialising the recurrent stages' inner blocks costs a train
step.

``models/lm.py::_inner_stack`` runs each Mamba2 block of a zamba2
superblock and each mLSTM block of an xLSTM group under the layer's
remat policy, inside the layer's own rematerialisation, as the
reference's nested ``scan_stack`` does: under "full" or "dots" the
backward recomputes each such block twice.  This script times
``make_train_step`` in two forms on the same weights and batches:
"nested" (the port's ``_inner_stack``) and "flat" (each inner block
called directly inside the layer's rematerialisation, the form before
the nested policy).  zamba2-7b is cut to one superblock (7 layers: 6
Mamba2 blocks and the shared attention) and xlstm-1.3b to one group (8
layers: 7 mLSTM and 1 sLSTM), at full width, float32, random weights
from ``--seed``, ``--batch`` x ``--seq`` tokens a step.  Prints, per
arch, policy and form, the median step ms of steps 2 to N (CUDA events
on the card, the host clock on the CPU), the peak GB
(``max_memory_allocated``; not measured on the CPU) and the first
step's loss, which the two forms must give alike.

    PYTHONPATH=src python3 tools/remat_cost.py                # the card
    PYTHONPATH=src python3 tools/remat_cost.py --device cpu --smoke
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import torch  # noqa: E402

from repro_torch.common.config import TrainConfig, get_config  # noqa: E402
from repro_torch.models import lm  # noqa: E402
from repro_torch.models.api import build_model  # noqa: E402
from repro_torch.training.data import DataConfig, TokenStream  # noqa: E402
from repro_torch.training.optimizer import init_state  # noqa: E402
from repro_torch.training.train_step import (  # noqa: E402
    batch_to_tensors, make_train_step,
)

CUTS = {"zamba2-7b": 7, "xlstm-1.3b": 8}


def _flat(block, p, h, cache, ctx, k):
    """``lm._inner_stack`` without the per-block rematerialisation."""
    for j in range(k):
        h = block(lm._sub(p, j), h, cache=lm._sub(cache, j))
    return h


def run(arch, remat, form, args) -> dict:
    dev = torch.device(args.device)
    cfg = get_config(arch, smoke=args.smoke)
    if not args.smoke:
        cfg = cfg.with_overrides(n_layers=CUTS[arch])
    bundle = build_model(cfg, remat=remat, compute_dtype=torch.float32)
    tcfg = TrainConfig(learning_rate=1e-4, warmup_steps=1,
                       total_steps=args.steps)
    state = init_state(bundle.init(
        torch.Generator(device=dev).manual_seed(args.seed), device=dev), tcfg)
    data = TokenStream(DataConfig(seq_len=args.seq, global_batch=args.batch,
                                  vocab_size=cfg.vocab_size))
    batches = [batch_to_tensors(b, dev) for _, b in zip(range(args.steps),
                                                        data)]
    step = make_train_step(bundle, tcfg)
    saved = lm._inner_stack
    if form == "flat":
        lm._inner_stack = _flat
    ms, loss = [], None
    try:
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        for batch in batches:
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                state, m = step(state, batch)
                end.record()
                end.synchronize()
                ms.append(start.elapsed_time(end))
            else:
                t = time.perf_counter()
                state, m = step(state, batch)
                ms.append(1e3 * (time.perf_counter() - t))
            loss = float(m["loss"]) if loss is None else loss
    finally:
        lm._inner_stack = saved
    peak = (torch.cuda.max_memory_allocated() / 1e9 if dev.type == "cuda"
            else None)
    return {"arch": arch, "layers": cfg.n_layers, "remat": remat,
            "form": form, "step_ms": statistics.median(ms[1:]),
            "steps_ms": ms, "peak_gb": peak, "loss_step1": loss}


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the smoke configs at their own depth")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import subprocess

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip())
    out = []
    for arch in CUTS:
        for remat in ("full", "dots"):
            pair = []
            # flat, nested, nested, flat: each form once early, once late
            for form in ("flat", "nested", "nested", "flat"):
                r = run(arch, remat, form, args)
                print(json.dumps(r), flush=True)
                pair.append(r)
                if args.device == "cuda":
                    torch.cuda.empty_cache()
            losses = {r["loss_step1"] for r in pair}
            if len(losses) != 1:
                raise SystemExit(f"{arch} {remat}: the forms' first losses "
                                 f"differ: {sorted(losses)}")
            out += pair
    return out


if __name__ == "__main__":
    main()
