"""Dry run: lay out every (arch x shape x mesh) cell on ``meta`` tensors.

The counterpart of the reference's ``launch/dryrun.py``, which lowers
and compiles each cell's step for 256 or 512 TPU chips from abstract
arrays.  Here a cell starts a *fake* process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg``: every collective
returns at once) in its own process, builds the production mesh over it
(a CUDA mesh, which needs no card over a fake group: DTensor picks the
collectives the card's mesh would, where a CPU mesh swaps all-to-all for
all-gather and a chunk), builds ``build_model(cfg, mesh=, rules=)`` at
the reference's default compute, bfloat16, makes this rank's state,
batch and cache at the reference's dtypes as meta-local DTensors (``ModelBundle.abstract_params``/``batch_specs``/
``cache_specs``), and runs one train step, prefill or decode step under
``common.profiling.measure``.  A meta tensor holds no memory and no
values, so nothing is computed: the step runs its Python and its
dispatch, DTensor picks each redistribute, and the kernel wrappers run
every plan check of the card (``kernels.ops``), which is where a shape
the H100 cannot take fails the cell, as an XLA compile fails one.  It is
the counterpart of XLA's abstract lowering, not a CPU fallback: no
number it records was measured on a device.

Single cell:   python -m repro_torch.launch.dryrun --arch tinyllama-1.1b \\
                   --shape train_4k [--multi-pod] [--perf-variant sp]
Full sweep:    python -m repro_torch.launch.dryrun --all [--jobs 4]
               (one subprocess per cell: each has its own fake group)

Artifacts: results/dryrun_torch/<arch>__<shape>__<mesh>.json with this
rank's ``memory`` (``profiling.measure``'s analysis), ``cost`` (dot
FLOPs, operand bytes, FLOPs by kernel), ``collectives`` (bytes and count
by kind, and the bytes over groups that span nodes) and the three-term
``roofline`` against the H100's published figures
(``common.hw.roofline_terms``: compute at the peak of the cell's
compute dtype, the bfloat16 tensor-core peak, the reference's default
compute, which lays out bfloat16 activations over bfloat16 weights,
batches and caches; a collective over a group that spans nodes at the
NIC's rate, one within a node at NVLink's; on
the production meshes every axis spans nodes); ``lower_s`` times
building the mesh, the model and its abstract inputs, ``compile_s`` the
counted call.  The reference's
``xla_scan_once_*`` costs have no counterpart (the port runs no scan).
The recurrent families' cells run their blocks on each rank's heads
(``models.lm``), the SSD and sLSTM kernel wrappers reporting their work
on meta tensors; the ``slstm*`` variants' unroll changes nothing (the
record's ``note`` says so).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pathlib
import subprocess
import sys
import time

REPO = pathlib.Path(__file__).resolve().parents[3]
OUT_DIR = REPO / "results" / "dryrun_torch"


# ---------------------------------------------------------------------------
# perf-hillclimb variants, the reference's: each is a named bundle of rule
# overrides / train-config / build options / arch-config tweaks.
# ---------------------------------------------------------------------------
VARIANTS: dict[str, dict] = {
    "baseline": {},
    "sp": {"rules": {"seq": "model"}},
    "actrep": {"rules": {"batch": None}},
    "attnrep": {"rules": {"heads": None, "kv_heads": None}},
    "sp2": {"rules": {"seq": "model", "heads": None, "kv_heads": None}},
    "sp3": {"rules": {"seq": "model"}, "opts": {"attn_sp": True}},
    "bf16sm": {"opts": {"softmax_dtype": "bfloat16"}},
    "actshard": {"rules": {"batch": None, "act_embed": "data"}},
    "blend": {"opts": {"cache_update": "blend"}},
    "blendshard": {"rules": {"batch": None, "act_embed": "data"},
                   "opts": {"cache_update": "blend"}},
    "cacheshard": {"opts": {"cache_update": "shard"}},
    "gatherq": {"opts": {"decode_attn": "gatherq"}},
    "gatherqshard": {"opts": {"decode_attn": "gatherq",
                              "cache_update": "shard"}},
    "smattn": {"opts": {"decode_attn": "shardmap",
                        "cache_update": "shard"}},
    "smattn2": {"opts": {"decode_attn": "shardmap", "cache_update": "shard"},
                "rules": {"batch": None, "act_embed": "data"}},
    "slstm8": {"cfg": {"slstm_unroll": 8}},
    "slstm32": {"cfg": {"slstm_unroll": 32}},
    "slstm128": {"cfg": {"slstm_unroll": 128}},
    "slstm32shard": {"cfg": {"slstm_unroll": 32},
                     "rules": {"slstm_rec": "model"}},
    "dots": {"opts": {"remat": "dots"}},
    "mb4": {"tcfg": {"microbatches": 4}},
    "mb4dots": {"tcfg": {"microbatches": 4}, "opts": {"remat": "dots"}},
    "spdots": {"rules": {"seq": "model"}, "opts": {"remat": "dots"}},
    "slstm32dots": {"cfg": {"slstm_unroll": 32}, "opts": {"remat": "dots"}},
}

def _sharding_profile(cfg, shape, perf_variant: str):
    """Per-shape-kind logical rule overrides (+ arch-specific, + perf)."""
    kind_rules = {
        "train": {},
        # serving replicates weights over the data axes (no per-layer FSDP
        # gathers) unless the arch is too big to fit (giants override back)
        "prefill": {"embed": None},
        "decode": {"embed": None},
    }[shape.kind]
    rules = dict(kind_rules)
    rules.update(cfg.sharding_overrides.get(shape.kind, {}))
    rules.update(cfg.sharding_overrides.get(shape.name, {}))
    rules.update(VARIANTS.get(perf_variant, {}).get("rules", {}))
    return rules


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0,
    for the life of the context (no other group may be up)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_group: a process group is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def train_config(n_params: int, variant: dict):
    """The reference's dry-run train config: bfloat16 moments (and
    weights) above 100 B parameters."""
    from repro_torch.common.config import TrainConfig

    giant = n_params > 100e9
    return TrainConfig(
        moment_dtype="bfloat16" if giant else "float32",
        remat=variant.get("opts", {}).get("remat", "full"),
        **variant.get("tcfg", {}))


def step_call(bundle, shape, tcfg=None):
    """The cell's step as ``fn(args...)``: (fn, the names of its tree
    arguments in order).  Serving steps run under ``no_grad``."""
    import torch

    if shape.kind == "train":
        from repro_torch.training.train_step import make_train_step

        return make_train_step(bundle, tcfg), ("state", "batch")
    if shape.kind == "prefill":
        return torch.no_grad()(bundle.prefill), ("params", "batch", "cache")

    def decode(params, batch, cache):
        return bundle.decode_step(params, batch["tokens"], cache,
                                  batch["lengths"])

    return torch.no_grad()(decode), ("params", "batch", "cache")


def abstract_inputs(bundle, shape, tcfg=None):
    """The cell's inputs as meta (DTensor) trees at the reference's
    dtypes: train state float32 (bfloat16 for giants) and the batch;
    serving weights, batch and cache bfloat16."""
    import torch

    from repro_torch.training.optimizer import state_specs

    bf16 = torch.bfloat16
    batch = bundle.abstract(bundle.batch_specs(shape), bf16)
    if shape.kind == "train":
        pdt = bf16 if tcfg.moment_dtype == "bfloat16" else torch.float32
        return {"state": bundle.abstract(state_specs(bundle.specs, tcfg),
                                          pdt), "batch": batch}
    return {"params": bundle.abstract_params(bf16), "batch": batch,
            "cache": bundle.abstract(bundle.cache_specs(
                shape.global_batch, shape.seq_len, bf16), bf16)}


def measure_step(bundle, shape, inputs, tcfg=None):
    """One step of the cell under ``common.profiling.measure``: (its
    result, this rank's ``CostReport``)."""
    from repro_torch.common.profiling import measure

    fn, names = step_call(bundle, shape, tcfg)
    return measure(fn, *(inputs[n] for n in names))


def model_flops(bundle, shape) -> float:
    """6·N·tokens for training, 2·N·tokens for serving (one token a row
    at decode), N the active parameters."""
    n = bundle.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def record_costs(record: dict, rep, n_chips: int, dtype: str) -> dict:
    """The reference's record keys from one rank's ``CostReport``, the
    roofline's compute at the peak of ``dtype``, the cell's compute
    dtype."""
    from repro_torch.common.hw import roofline_terms
    from repro_torch.common.profiling import (
        collective_stats, cost_summary, memory_summary,
    )

    record["memory"] = memory_summary(rep)
    record["hbm_per_device_gib"] = round(
        record["memory"]["total_bytes"] / 1024**3, 3)
    record["cost"] = cost_summary(rep)
    record["collectives"] = collective_stats(rep)
    record["roofline"] = roofline_terms(
        rep.flops, rep.bytes, rep.collective_bytes, dtype,
        inter_node_bytes=rep.inter_node_bytes)
    record["model_vs_hlo_flops"] = (
        record["model_flops"] / (rep.flops * n_chips) if rep.flops else None)
    return record


def lay_out(cfg, shape, mesh, perf_variant="baseline") -> dict:
    """One cell on ``mesh`` (a ``DeviceMesh`` over the fake process group
    that is up): the record without its identifying keys."""
    from repro_torch.common.sharding import merge_rules
    from repro_torch.models.api import build_model

    variant = VARIANTS.get(perf_variant, {})
    if variant.get("cfg"):
        cfg = cfg.with_overrides(**variant["cfg"])
    t0 = time.time()
    rules = merge_rules(_sharding_profile(cfg, shape, perf_variant))
    bundle = build_model(cfg, mesh=mesh, rules=rules,
                         **variant.get("opts", {}))
    record: dict = {"n_params": bundle.param_count(),
                    "n_active_params": bundle.active_param_count()}
    if "slstm_unroll" in variant.get("cfg", {}):
        record["note"] = (
            f"slstm_unroll {cfg.slstm_unroll} changes nothing in the port: "
            "the sLSTM kernel and its plain version have no unroll")
    tcfg = (train_config(record["n_params"], variant)
            if shape.kind == "train" else None)
    inputs = abstract_inputs(bundle, shape, tcfg)
    record["lower_s"] = round(time.time() - t0, 2)
    t1 = time.time()
    _, rep = measure_step(bundle, shape, inputs, tcfg)
    record["compile_s"] = round(time.time() - t1, 2)
    record["model_flops"] = model_flops(bundle, shape)
    return record_costs(record, rep, mesh.size(),
                        str(bundle.compute_dtype).removeprefix("torch."))


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             perf_variant: str = "baseline") -> dict:
    from repro_torch.common.config import SHAPES, get_config
    from repro_torch.launch.mesh import make_production_mesh, mesh_tag

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    n_chips = 512 if multi_pod else 256
    record: dict = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag(multi_pod),
        "perf_variant": perf_variant, "n_chips": n_chips,
    }
    if shape_name in cfg.skip_shapes:
        record["skipped"] = cfg.skip_reason
        return record
    with fake_group(n_chips):
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod)
        mesh_s = time.time() - t0
        rec = lay_out(cfg, shape, mesh, perf_variant)
        rec["lower_s"] = round(rec["lower_s"] + mesh_s, 2)
        record.update(rec)
    return record


def cell_name(arch, shape, multi_pod, perf_variant="baseline") -> str:
    name = f"{arch}__{shape}__{'multipod2x16x16' if multi_pod else 'pod16x16'}"
    if perf_variant != "baseline":
        name += f"__{perf_variant}"
    return name


def _cell_main(args):
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    rec = run_cell(args.arch, args.shape, args.multi_pod, args.perf_variant)
    name = cell_name(args.arch, args.shape, args.multi_pod, args.perf_variant)
    (OUT_DIR / f"{name}.json").write_text(json.dumps(rec, indent=1))
    status = "SKIP" if "skipped" in rec else "OK"
    print(f"[dryrun] {status} {name} "
          f"(lay out {rec.get('lower_s', 0)}s step {rec.get('compile_s', 0)}s "
          f"hbm/dev {rec.get('hbm_per_device_gib', '-')} GiB)")


def _sweep(jobs: int, multi_pod_only: bool, force: bool):
    from repro_torch.common.config import SHAPES, list_archs

    OUT_DIR.mkdir(parents=True, exist_ok=True)
    cells = []
    for arch in list_archs():
        for shape in SHAPES:
            for mp in ([True] if multi_pod_only else [False, True]):
                out = OUT_DIR / f"{cell_name(arch, shape, mp)}.json"
                if force or not out.exists():
                    cells.append((arch, shape, mp))
    print(f"[dryrun] {len(cells)} cells to run, {jobs} jobs")
    procs: list[tuple[subprocess.Popen, tuple]] = []
    failures = []
    idx = 0
    while idx < len(cells) or procs:
        while idx < len(cells) and len(procs) < jobs:
            arch, shape, mp = cells[idx]
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape]
            if mp:
                cmd.append("--multi-pod")
            log = OUT_DIR / f"log_{arch}__{shape}__{'mp' if mp else 'sp'}.txt"
            with log.open("w") as fh:
                p = subprocess.Popen(
                    cmd, stdout=fh, stderr=subprocess.STDOUT,
                    env={**os.environ, "PYTHONPATH": str(REPO / "src")})
            procs.append((p, cells[idx]))
            idx += 1
        done = [(p, c) for p, c in procs if p.poll() is not None]
        procs = [(p, c) for p, c in procs if p.poll() is None]
        for p, c in done:
            if p.returncode != 0:
                failures.append(c)
                print(f"[dryrun] FAIL {c}")
            else:
                print(f"[dryrun] done {c}")
        if procs and not done:
            time.sleep(1)
    if failures:
        print(f"[dryrun] {len(failures)} failures: {failures}")
        sys.exit(1)
    print("[dryrun] sweep complete")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--perf-variant", default="baseline",
                    choices=sorted(VARIANTS))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args()
    if args.all:
        _sweep(args.jobs, args.multi_pod_only, args.force)
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape are required without --all")
        _cell_main(args)


if __name__ == "__main__":
    main()
