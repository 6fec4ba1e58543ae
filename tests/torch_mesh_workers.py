"""The port's side of the multi-rank tests: gloo ranks on the CPU.

``spawn`` starts ``world`` processes (the ``spawn`` start method), each
with a gloo process group initialised through a file in the test's
``tmp_path`` (no port: test files run side by side), runs ``fn(rank,
*args)`` in each and joins them within a timeout of its own, so a hung
collective fails one test.  The workers below compute what
``tests/torch_mesh_ref.py`` computes for the JAX package and write it
from rank 0 into an npz under the same keys (``run_cases`` runs both
sides); ``world1`` is the in-process (1, 1) mesh the test files share.
This module imports no jax: the ranks never load it.
"""

from __future__ import annotations

import math
import time

import numpy as np
import pytest

import torch_mesh_ref as mref


def _entry(rank, fn, world, init, args):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn, world, tmp_path, *args, timeout=300.0):
    import torch.multiprocessing as mp

    init = tmp_path / f"pg_{fn.__name__}_{world}_{time.monotonic_ns()}"
    ctx = mp.start_processes(_entry, args=(fn, world, str(init), args),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{fn.__name__} on {world} ranks did not end "
                               f"within {timeout} s")


def run_cases(kind, worker, cases, tmp, *args):
    """The reference's child over ``cases`` (started first, so it
    computes while the ranks run), then one spawn of ``worker`` per mesh
    shape over that shape's cases.  Returns (the reference's outputs,
    the port's)."""
    proc, npz = mref.start(kind, cases, tmp)
    try:
        port = {}
        for shape in sorted({tuple(c["mesh"]) for c in cases}):
            mine = [(i, c) for i, c in enumerate(cases)
                    if tuple(c["mesh"]) == shape]
            out = tmp / f"port_{kind}_{shape[0]}x{shape[1]}.npz"
            spawn(worker, math.prod(shape), tmp, shape, mine, *args, str(out))
            port.update(np.load(out))
    except BaseException:
        proc.kill()
        raise
    return mref.finish(proc, npz), port


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    """A (1, 1) CPU mesh over a gloo process group of one rank in the
    test process (destroyed after the module)."""
    import torch.distributed as dist

    init = tmp_path_factory.mktemp("pg") / "init"
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=0,
                            world_size=1)
    yield _mesh((1, 1))
    dist.destroy_process_group()


def _mesh(shape):
    from repro_torch.common.sharding import local_mesh

    return local_mesh(tuple(shape), device="cpu")


def _save(rank, out, res):
    if rank == 0:
        np.savez(out, **res)


def model_worker(rank, shape, cases, params, out):
    """Each case's prefill + decode logits (greedy tokens fed back, or
    in a "bf16" case ``torch_mesh_ref.forced_tokens`` at the default
    compute and cache dtypes, bfloat16) on the mesh ``shape``;
    "local_shapes" adds every leaf's local shape.  A case's "cfg"
    overrides the smoke config, its weights then under the key "params"
    of ``params`` (else its arch)."""
    import torch

    from repro_torch.common.bridge import params_from_numpy
    from repro_torch.common.config import get_config
    from repro_torch.common.sharding import shard_tree
    from repro_torch.models.api import build_model

    mesh = _mesh(shape)
    res = {}
    for i, case in cases:
        cfg = get_config(case["arch"], smoke=True).with_overrides(
            **case.get("cfg", {}))
        bf16 = case.get("bf16", False)
        dt = torch.bfloat16 if bf16 else torch.float32
        b = build_model(cfg, mesh=mesh, rules=case.get("rules"),
                        **case.get("opts", {}), compute_dtype=dt)
        p = shard_tree(params_from_numpy(
            params[case.get("params", case["arch"])], "cpu"),
            b.specs, b.rules, mesh)
        batch, n_img = mref.model_batch(cfg)
        B, S = batch["tokens"].shape
        forced = torch.from_numpy(mref.forced_tokens(cfg, B, case["steps"]))
        cache = b.init_cache(B, case["T"], device="cpu", dtype=dt)
        with torch.no_grad():
            lg, cache = b.prefill(p, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, cache)
            logits = [lg.full_tensor()]
            lengths = torch.full((B,), S + n_img, dtype=torch.int32)
            for step in range(case["steps"]):
                tok = (forced[:, step:step + 1] if bf16 else
                       logits[-1].argmax(-1)[:, None].to(torch.int32))
                lg, cache = b.decode_step(p, tok, cache, lengths)
                logits.append(lg.full_tensor())
                lengths = lengths + 1
        res[f"{i}/logits"] = torch.stack(logits).numpy()
        if case.get("local_shapes"):
            for path, leaf in mref.leaf_paths(p):
                res[f"{i}/shape/{path}"] = np.asarray(leaf.to_local().shape)
    _save(rank, out, res)


def _paged_run(b, p, cfg, ps, n_pages, full):
    """``torch_mesh_ref.run_paged``'s path on the bundle ``b`` (weights
    ``p``): the logits, and every pool leaf after each step (``full``
    makes a tensor whole)."""
    import torch

    from repro_torch.serving.kvcache import insert_pages

    rows, tables = mref.paged_scenario(cfg, ps, n_pages)
    B = len(rows)
    pool = b.init_paged_cache(n_pages, ps, device="cpu", dtype=torch.float32)
    res = {}
    with torch.no_grad():
        first = torch.zeros(B, cfg.vocab_size)
        for i, r in enumerate(rows):
            if r is None:
                continue
            one = b.init_cache(1, len(r["pages"]) * ps, device="cpu",
                               dtype=torch.float32)
            lg, one = b.prefill(p, {k: torch.from_numpy(v)
                                    for k, v in r["batch"].items()}, one)
            first[i] = full(lg)[0]
            insert_pages(pool, one, r["pages"], r["L"])
        live = torch.tensor([r is not None for r in rows])
        lengths = torch.tensor([r["L"] if r else 0 for r in rows],
                               dtype=torch.int32)
        tables = torch.from_numpy(tables)
        logits = [first]
        for s in range(mref.PAGED_STEPS):
            tok = torch.where(live, logits[-1].argmax(-1), 0).to(torch.int32)
            lg, pool = b.paged_decode_step(p, tok[:, None], pool, tables,
                                           lengths)
            logits.append(full(lg))
            for path, leaf in mref.leaf_paths(pool):
                res[f"pool{s}/{path}"] = full(leaf).numpy().copy()
            lengths = lengths + live.to(torch.int32)
    res["logits"] = torch.stack(logits).numpy()
    return res


def paged_worker(rank, shape, cases, params, out):
    """``torch_mesh_ref.run_paged`` on the mesh ``shape`` for each case;
    a case with "unsharded" runs the unsharded bundle of the same weights
    too, its outputs under "plain/" (the port pages granite's moe stage,
    which the reference does not)."""
    import torch

    from repro_torch.common.bridge import params_from_numpy
    from repro_torch.common.config import get_config
    from repro_torch.common.sharding import shard_tree
    from repro_torch.models.api import build_model

    mesh = _mesh(shape)
    res = {}
    for i, case in cases:
        cfg = get_config(case["arch"], smoke=True).with_overrides(
            **case.get("cfg", {}))
        full = params_from_numpy(params[case.get("params", case["arch"])],
                                 "cpu")
        b = build_model(cfg, mesh=mesh, rules=case.get("rules"),
                        **case.get("opts", {}), compute_dtype=torch.float32)
        p = shard_tree(full, b.specs, b.rules, mesh)
        for k, v in _paged_run(b, p, cfg, case["ps"], case["n_pages"],
                               lambda t: t.full_tensor()).items():
            res[f"{i}/{k}"] = v
        if case.get("unsharded"):
            for k, v in _paged_run(
                    build_model(cfg, compute_dtype=torch.float32), full, cfg,
                    case["ps"], case["n_pages"], lambda t: t).items():
                res[f"{i}/plain/{k}"] = v
    _save(rank, out, res)


def loss_worker(rank, shape, cases, params, out):
    """Each case's training loss on ``loss_batch`` and (``grads``) every
    gradient leaf, gathered, on the mesh ``shape``; ``cfg`` overrides
    the smoke config and ``opts`` are build options."""
    import torch

    from repro_torch.common.bridge import params_from_numpy
    from repro_torch.common.config import get_config
    from repro_torch.common.sharding import shard_tree
    from repro_torch.models.api import build_model
    from repro_torch.training.train_step import loss_and_grads

    mesh = _mesh(shape)
    res = {}
    for i, case in cases:
        cfg = get_config(case["arch"], smoke=True).with_overrides(
            **case.get("cfg", {}))
        b = build_model(cfg, mesh=mesh, rules=case.get("rules"),
                        **case.get("opts", {}), compute_dtype=torch.float32)
        p = shard_tree(params_from_numpy(params[case["arch"]], "cpu"),
                       b.specs, b.rules, mesh)
        batch = {k: torch.from_numpy(v)
                 for k, v in mref.loss_batch(cfg).items()}
        loss, _, grads = loss_and_grads(b, p, batch)
        res[f"{i}/loss"] = loss.full_tensor().numpy()
        if case.get("grads"):
            for path, g in mref.leaf_paths(grads):
                res[f"{i}/grad/{path}"] = g.full_tensor().numpy()
    _save(rank, out, res)


def dryrun_worker(rank, shape, cells, out):
    """Each dry-run cell's step on real tensors on the mesh ``shape``,
    counted by ``common.profiling`` as ``launch.dryrun`` counts it on
    meta tensors: built at the dry run's default compute (bfloat16), the
    weights drawn at its dtypes (float32 train state, bfloat16 serving
    weights and cache), random tokens, a
    prefill of the whole sequence and a decode at half of it.  Writes
    each cell's FLOPs, collectives by kind and argument bytes as JSON
    from rank 0."""
    import json

    import torch

    from repro_torch.common.config import ShapeConfig, get_config
    from repro_torch.common.sharding import merge_rules
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.training.optimizer import init_state

    mesh = _mesh(shape)
    res = {}
    for i, cell in cells:
        variant = cell.get("variant", "baseline")
        cfg = get_config(cell["arch"], smoke=True)
        shp = ShapeConfig(*cell["shape"])
        v = dryrun.VARIANTS[variant]
        b = build_model(cfg, mesh=mesh, rules=merge_rules(
            dryrun._sharding_profile(cfg, shp, variant)), **v.get("opts", {}))
        gen = torch.Generator().manual_seed(i)
        B, S = shp.global_batch, shp.seq_len
        tok = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                            dtype=torch.int32)
        tcfg = None
        if shp.kind == "train":
            tcfg = dryrun.train_config(b.param_count(), v)
            inputs = {"state": init_state(b.init(gen, device="cpu"), tcfg),
                      "batch": {"tokens": tok, "targets": tok.roll(-1, 1),
                                "mask": torch.ones(B, S)}}
        else:
            bf16 = torch.bfloat16
            lengths = torch.full((B,), S if shp.kind == "prefill" else S // 2,
                                 dtype=torch.int32)
            inputs = {"params": b.init(gen, bf16, device="cpu"),
                      "cache": b.init_cache(B, S, bf16, device="cpu"),
                      "batch": {"tokens": tok if shp.kind == "prefill"
                                else tok[:, :1].clone(), "lengths": lengths}}
        _, rep = dryrun.measure_step(b, shp, inputs, tcfg)
        res[str(i)] = {"flops": rep.flops, "count_by_op": rep.count_by_op,
                       "bytes_by_op": rep.bytes_by_op,
                       "argument": rep.memory["argument_size_in_bytes"]}
    if rank == 0:
        with open(out, "w") as fh:
            json.dump(res, fh)


def moe_worker(rank, shape, cases, cfgs, params, out):
    """``moe_apply_ep`` over each case on the mesh ``shape`` (``cfgs`` and
    ``params`` by the case's config kind)."""
    import torch

    from repro_torch.common.bridge import params_from_numpy
    from repro_torch.layers.moe import moe_apply_ep

    mesh = _mesh(shape)
    res = {}
    for i, case in cases:
        p = params_from_numpy(params[case["cfg"]], "cpu")
        x = torch.from_numpy(mref.moe_x(cfgs[case["cfg"]].d_model,
                                        *case["x"]))
        y, aux = moe_apply_ep(p, x, cfgs[case["cfg"]], mesh,
                              capacity_factor=case["cf"])
        res[f"{i}/y"] = y.full_tensor().numpy()
        res[f"{i}/aux"] = aux.full_tensor().numpy()
    _save(rank, out, res)


def decode_worker(rank, shape, cases, out):
    """``decode_attention_shardmap`` and the three ``cache_insert``
    modes over each case on the mesh ``shape``; the caches are placed
    by the rules first, as the reference's arrays are."""
    import torch

    from repro_torch.common import sharding
    from repro_torch.layers.attention import (
        cache_insert, decode_attention_shardmap)

    mesh = _mesh(shape)
    res = {}
    for i, case in cases:
        rules = sharding.merge_rules(case.get("rules"))
        g = case["geom"]
        inp = {k: torch.from_numpy(v) for k, v in mref.decode_inputs(
            g["B"], g["T"], g["H"], g["K"], g["D"], g["lengths"],
            g.get("seed", 0)).items()}
        axes = ("cache_batch", "cache_seq", None, None)
        k = sharding.constrain(inp["k"], axes, rules, mesh)
        v = sharding.constrain(inp["v"], axes, rules, mesh)
        out_ = decode_attention_shardmap(
            inp["q"], k, v, inp["lengths"], mesh=mesh, rules=rules,
            window=g.get("window", 0), softcap=g.get("softcap", 0.0))
        res[f"{i}/out"] = out_.full_tensor().numpy()
        for mode in ("scatter", "blend", "shard"):
            c = sharding.constrain(inp["k"].clone(), axes, rules, mesh)
            c = cache_insert(c, inp["new"], inp["lengths"], mode=mode,
                             mesh=mesh, rules=rules)
            res[f"{i}/insert/{mode}"] = c.full_tensor().numpy()
    _save(rank, out, res)
