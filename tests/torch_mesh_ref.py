"""The JAX package's sharded outputs for the port's multi-rank tests.

    XLA_FLAGS=--xla_force_host_platform_device_count=4 \\
        python tests/torch_mesh_ref.py <kind> <cases.json> <out.npz>

Run as a child process by ``tests/test_torch_{moe_ep,shardmap_decode,
sharded_model,sharded_loss,paged_mesh}.py``, which set ``XLA_FLAGS`` for
the child only (the test process keeps the one CPU device).  ``kind`` is
"model", "moe", "decode", "loss", "dryrun" or "paged"; each case of the
JSON list names its mesh shape and inputs,
and every output is stored in the npz under ``<case index>/<name>``.
The inputs are rebuilt here from the same seeds the tests use
(``model_tokens``, ``loss_batch``, ``moe_x``, ``decode_inputs``; the
weights from
PRNGKey(0)), so only the case descriptions cross over.
"""

from __future__ import annotations

import json
import sys

import numpy as np


def leaf_paths(tree, prefix=""):
    """(path, leaf) pairs of a tree of nested dicts and lists, the path
    its keys and indices joined by "/" (the same in both packages)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from leaf_paths(v, f"{prefix}{i}/")
    else:
        yield prefix.rstrip("/"), tree


def model_cfg(arch):
    from repro.common.config import get_config

    return get_config(arch, smoke=True)


def model_tokens(cfg, B=2, S=5, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def model_batch(cfg, B=2, S=5):
    """A prefill batch of ``model_tokens``, behind a VLM's image prefix
    (``n_image_tokens`` embeddings, seed 1); and the prefix's length."""
    batch = {"tokens": model_tokens(cfg, B, S)}
    if not cfg.has_vision_stub:
        return batch, 0
    batch["image_embeds"] = np.random.default_rng(1).standard_normal(
        (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return batch, cfg.n_image_tokens


#: the paged cases' rows: each row's sequence length at the first paged
#: step (a VLM's image prefix included; None a dead row, pointed at the
#: dummy page 0 with length 0 and token 0), and the steps
PAGED_LENS, PAGED_STEPS = (14, 37, None, 23), 4


def paged_scenario(cfg, ps, n_pages, lens=PAGED_LENS, steps=PAGED_STEPS):
    """The rows of a paged case: for each live row its prefill batch
    (text tokens from seed 5 behind a VLM's image prefix), its length
    and its pages, enough for ``steps`` more tokens, taken in the order
    1 + m i mod (n_pages - 1), m the first of 5, 7, 11 prime to
    n_pages - 1, so that rows straddle the pool's halves;
    and the (B, n_max) block tables, padded with the dummy page 0.  At
    pages of 16 row 0 crosses a page boundary during the steps and row
    3's first step sees, under a window of 8, only slots 0-7 of its
    second page (a model rank holding slots 8-15 has none of its keys)."""
    import math

    n_img = cfg.n_image_tokens if cfg.has_vision_stub else 0
    rng = np.random.default_rng(5)
    m = next(m for m in (5, 7, 11) if math.gcd(m, n_pages - 1) == 1)
    order = [1 + (m * i) % (n_pages - 1) for i in range(n_pages - 1)]
    rows, k = [], 0
    for L in lens:
        if L is None:
            rows.append(None)
            continue
        n = -(-(L + steps) // ps)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (1, L - n_img))
                 .astype(np.int32)}
        if n_img:
            batch["image_embeds"] = rng.standard_normal(
                (1, n_img, cfg.d_model)).astype(np.float32)
        rows.append({"batch": batch, "L": L, "pages": order[k:k + n]})
        k += n
    if k > n_pages - 1:
        raise ValueError(f"{k} pages for a pool of {n_pages}")
    n_max = max(len(r["pages"]) for r in rows if r)
    tables = np.zeros((len(lens), n_max), np.int32)
    for i, r in enumerate(rows):
        if r:
            tables[i, :len(r["pages"])] = r["pages"]
    return rows, tables


def loss_batch(cfg, B=4, S=8, seed=2):
    """A training batch: tokens, next-token targets and a mask with a
    few zeros (every row keeps most of its positions); an
    encoder-decoder's audio frames too."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    mask = (rng.random((B, S)) > 0.2).astype(np.float32)
    mask[:, 0] = 1.0
    batch = {"tokens": ids[:, :-1], "targets": ids[:, 1:], "mask": mask}
    if cfg.is_encoder_decoder:
        batch["audio_frames"] = rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return batch


def model_params(arch, cfg=None):
    """The reference's smoke weights, PRNGKey(0), as numpy (of the smoke
    config with the ``cfg`` overrides, where given)."""
    import jax

    from repro.models.api import build_model

    cfg = model_cfg(arch).with_overrides(**(cfg or {}))
    return jax.tree.map(np.asarray,
                        build_model(cfg).init(jax.random.PRNGKey(0)))


def moe_cfg(kind):
    """The MoE configs of the EP tests: "granite" (the smoke granite,
    5 experts padded to 6, top-2), "pad4" (6 experts padded to 8, top-2:
    E divides a model axis of 4) and "shared" (pad4 with a shared
    expert)."""
    from repro.common.config import ArchConfig

    if kind == "granite":
        return model_cfg("granite-moe-3b-a800m")
    base = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab_size=32, n_experts=6,
                experts_top_k=2, moe_d_ff=32, expert_pad_to=8)
    if kind == "shared":
        base["n_shared_experts"] = 1
    return ArchConfig(**base)


def moe_params(kind, seed=0):
    import jax

    from repro.layers.initializers import init_tree
    from repro.layers.moe import moe_specs

    return jax.tree.map(np.asarray, init_tree(jax.random.PRNGKey(seed),
                                              moe_specs(moe_cfg(kind))))


def moe_x(d_model, B, S, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, d_model)).astype(np.float32)


def decode_inputs(B, T, H, K, D, lengths, seed=0):
    """q (B, 1, H, D), caches (B, T, K, D), lengths (B,) int32 and one
    new token's k (B, 1, K, D)."""
    rng = np.random.default_rng(seed)
    f = np.float32
    return {"q": rng.standard_normal((B, 1, H, D)).astype(f),
            "k": rng.standard_normal((B, T, K, D)).astype(f),
            "v": rng.standard_normal((B, T, K, D)).astype(f),
            "new": rng.standard_normal((B, 1, K, D)).astype(f),
            "lengths": np.asarray(lengths, np.int32)}


def _mesh(shape):
    import jax
    from jax.sharding import Mesh

    devs = jax.devices()[:int(np.prod(shape))]
    return Mesh(np.asarray(devs).reshape(shape), ("data", "model"))


def forced_tokens(cfg, B, steps, seed=3):
    """A "bf16" case's decode inputs: ``steps`` columns of seeded tokens
    fed in turn (teacher forcing), so a bfloat16 rounding that tips a
    near-tie argmax cannot send the two packages down different paths."""
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, steps)).astype(np.int32)


def run_model(case):
    """A case's prefill and decode logits; a "bf16" case builds with the
    reference's default compute (bfloat16) and caches, and feeds
    ``forced_tokens``, else float32 and greedy tokens fed back."""
    import jax
    import jax.numpy as jnp

    from repro.common.sharding import merge_rules, tree_shardings
    from repro.models.api import build_model

    mesh = _mesh(case["mesh"])
    cfg = model_cfg(case["arch"]).with_overrides(**case.get("cfg", {}))
    rules = merge_rules(case.get("rules"))
    bf16 = case.get("bf16", False)
    dt = {} if bf16 else {"compute_dtype": jnp.float32}
    bundle = build_model(cfg, mesh=mesh, rules=rules, **dt,
                         **case.get("opts", {}))
    params = jax.device_put(model_params(case["arch"], case.get("cfg")),
                            tree_shardings(bundle.specs, rules, mesh))
    batch, n_img = model_batch(cfg)
    B, S = batch["tokens"].shape
    cdt = jnp.bfloat16 if bf16 else jnp.float32
    forced = forced_tokens(cfg, B, case["steps"])
    cache_specs = bundle.cache_specs(B, case["T"], cdt)
    cache = jax.device_put(bundle.init_cache(B, case["T"], cdt),
                           tree_shardings(cache_specs, rules, mesh))
    with mesh:
        prefill = jax.jit(bundle.prefill)
        decode = jax.jit(bundle.decode_step)
        lg, cache = prefill(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, cache)
        logits = [np.asarray(lg)]
        lengths = jnp.full((B,), S + n_img, jnp.int32)
        for step in range(case["steps"]):
            tok = jnp.asarray(forced[:, step:step + 1] if bf16 else
                              logits[-1].argmax(-1)[:, None].astype(np.int32))
            lg, cache = decode(params, tok, cache, lengths)
            logits.append(np.asarray(lg))
            lengths = lengths + 1
    out = {"logits": np.stack(logits)}
    if case.get("local_shapes"):
        # every leaf's first addressable shard, by its path
        for path, leaf in leaf_paths(params):
            out["shape/" + path] = np.asarray(
                leaf.addressable_shards[0].data.shape)
    return out


def run_paged(case):
    """The sharded model's paged decode (``paged_scenario``): each live
    row prefilled alone into a one-row dense cache and copied into the
    sharded pool (``insert_pages``), then ``PAGED_STEPS`` paged steps of
    every row (greedy tokens fed back).  Outputs: the logits (the
    prefills' in a first row of zeros for a dead row, then each step's)
    and every pool leaf after each step."""
    import jax
    import jax.numpy as jnp

    from repro.common.sharding import merge_rules, tree_shardings
    from repro.models.api import build_model
    from repro.serving.kvcache import insert_pages

    mesh = _mesh(case["mesh"])
    cfg = model_cfg(case["arch"]).with_overrides(**case.get("cfg", {}))
    rules = merge_rules(case.get("rules"))
    f32 = jnp.float32
    bundle = build_model(cfg, mesh=mesh, rules=rules, compute_dtype=f32)
    params = jax.device_put(model_params(case["arch"], case.get("cfg")),
                            tree_shardings(bundle.specs, rules, mesh))
    ps, n_pages = case["ps"], case["n_pages"]
    rows, tables = paged_scenario(cfg, ps, n_pages)
    B = len(rows)
    pool = jax.device_put(
        bundle.init_paged_cache(n_pages, ps, f32),
        tree_shardings(bundle.paged_cache_specs(n_pages, ps, f32), rules,
                       mesh))
    out = {}
    with mesh:
        prefill = jax.jit(bundle.prefill)
        step = jax.jit(bundle.paged_decode_step)
        first = np.zeros((B, cfg.vocab_size), np.float32)
        for i, r in enumerate(rows):
            if r is None:
                continue
            T = len(r["pages"]) * ps
            one = jax.device_put(
                bundle.init_cache(1, T, f32),
                tree_shardings(bundle.cache_specs(1, T, f32), rules, mesh))
            lg, one = prefill(params, {k: jnp.asarray(v)
                                       for k, v in r["batch"].items()}, one)
            first[i] = np.asarray(lg)[0]
            pool = insert_pages(pool, one, r["pages"], r["L"])
        live = np.asarray([r is not None for r in rows])
        lengths = np.asarray([r["L"] if r else 0 for r in rows], np.int32)
        logits = [first]
        for s in range(PAGED_STEPS):
            tok = np.where(live, logits[-1].argmax(-1), 0).astype(np.int32)
            lg, pool = step(params, jnp.asarray(tok[:, None]), pool,
                            jnp.asarray(tables), jnp.asarray(lengths))
            logits.append(np.asarray(lg))
            for path, leaf in leaf_paths(pool):
                out[f"pool{s}/{path}"] = np.asarray(leaf)
            lengths = lengths + live
    out["logits"] = np.stack(logits)
    return out


def run_loss(case):
    """The sharded model's training loss on ``loss_batch``."""
    import jax
    import jax.numpy as jnp

    from repro.common.sharding import merge_rules, tree_shardings
    from repro.models.api import build_model

    mesh = _mesh(case["mesh"])
    cfg = model_cfg(case["arch"])
    rules = merge_rules(case.get("rules"))
    bundle = build_model(cfg, mesh=mesh, rules=rules,
                         compute_dtype=jnp.float32)
    params = jax.device_put(model_params(case["arch"]),
                            tree_shardings(bundle.specs, rules, mesh))
    batch = {k: jnp.asarray(v) for k, v in loss_batch(cfg).items()}
    with mesh:
        loss, _ = jax.jit(bundle.loss_fn)(params, batch)
    return {"loss": np.asarray(loss)}


def dots_by_shape(hlo_text):
    """The reference's dot FLOPs by product: (output elements, contracted
    elements, times run) for each distinct pair, each dot instruction
    counted along every call edge with its loop trip counts, as
    ``hlo_cost.HloCost.flops`` counts them; as an (n, 3) float64 array
    sorted by FLOPs."""
    from repro.common.hlo_cost import HloCost, _shape_list

    hc = HloCost(hlo_text)
    out: dict = {}

    def walk(comp, mult):
        shapes = hc._shape_map(comp)
        for ins in hc.comps.get(comp, []):
            if ins.op == "dot":
                n_out = int(np.prod([d for _, dims in _shape_list(
                    ins.out_text) for d in dims]))
                key = (n_out, hc._dot_flops(ins, shapes) / (2 * n_out))
                out[key] = out.get(key, 0.0) + mult
            for callee, m in hc._callees(ins):
                walk(callee, mult * m)

    walk(hc.entry, 1.0)
    rows = sorted(([a, b, n] for (a, b), n in out.items()),
                  key=lambda r: -r[0] * r[1] * r[2])
    return np.asarray(rows, dtype=np.float64).reshape(-1, 3)


def run_dryrun(case):
    """The reference dry run's per-device figures for one small cell:
    the smoke config lowered and compiled for ``case["mesh"]`` (axes
    ("data", "model"), or ("pod", "data", "model") for three dims) as
    ``repro.launch.dryrun.run_cell`` lowers a production cell, with the
    mesh built by ``jax.sharding.Mesh``.  Each step is jitted with
    ``keep_unused=True``, so its argument bytes count every argument as
    the port's do: by default jit drops the ones the step never reads
    (the recurrent state caches of a prefill, which starts from the
    fresh state; the lengths of an xLSTM decode, which has no
    attention), which the port, writing the caches in place, holds."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro.common.config import ShapeConfig, TrainConfig
    from repro.common.hlo_cost import analyze
    from repro.common.profiling import memory_summary
    from repro.common.sharding import merge_rules, tree_shardings
    from repro.launch.dryrun import _sharding_profile
    from repro.layers.initializers import abstract_tree
    from repro.models.api import build_model
    from repro.training.optimizer import state_specs
    from repro.training.train_step import make_train_step

    shape_ = tuple(case["mesh"])
    axes = ("pod", "data", "model")[-len(shape_):]
    devs = jax.devices()[:int(np.prod(shape_))]
    mesh = Mesh(np.asarray(devs).reshape(shape_), axes)
    cfg = model_cfg(case["arch"])
    shape = ShapeConfig(*case["shape"])
    rules = merge_rules(_sharding_profile(cfg, shape, "baseline"))
    bundle = build_model(cfg, mesh=mesh, rules=rules)

    def sds(specs, dtype):
        return abstract_tree(specs, dtype, tree_shardings(specs, rules, mesh))

    with mesh:
        bspecs = bundle.batch_specs(shape)
        batch = sds(bspecs, jnp.bfloat16)
        if shape.kind == "train":
            tcfg = TrainConfig(moment_dtype="float32", remat="full")
            state = sds(state_specs(bundle.specs, tcfg), jnp.float32)
            lowered = jax.jit(make_train_step(bundle, tcfg),
                              donate_argnums=(0,),
                              keep_unused=True).lower(state, batch)
        else:
            params = sds(bundle.specs, jnp.bfloat16)
            cache = sds(bundle.cache_specs(shape.global_batch, shape.seq_len,
                                           jnp.bfloat16), jnp.bfloat16)
            if shape.kind == "prefill":
                lowered = jax.jit(bundle.prefill, keep_unused=True).lower(
                    params, batch, cache)
            else:
                lowered = jax.jit(bundle.decode_step, donate_argnums=(2,),
                                  keep_unused=True).lower(
                    params, batch["tokens"], cache, batch["lengths"])
        compiled = lowered.compile()
    rep = analyze(compiled.as_text())
    mem = memory_summary(compiled)
    return {"argument": np.asarray(mem["argument_size_in_bytes"]),
            "flops": np.asarray(rep.flops),
            "dots": dots_by_shape(compiled.as_text()),
            "collective_bytes": np.asarray(rep.collective_bytes)}


def run_moe(case):
    import jax

    from repro.layers.moe import moe_apply_ep

    mesh = _mesh(case["mesh"])
    cfg = moe_cfg(case["cfg"])
    y, aux = jax.jit(lambda p, x: moe_apply_ep(
        p, x, cfg, mesh, capacity_factor=case["cf"]))(
            moe_params(case["cfg"]), moe_x(cfg.d_model, *case["x"]))
    return {"y": np.asarray(y), "aux": np.asarray(aux)}


def run_decode(case):
    import jax

    from repro.common.sharding import merge_rules
    from repro.layers.attention import cache_insert, decode_attention_shardmap

    mesh = _mesh(case["mesh"])
    rules = merge_rules(case.get("rules"))
    g = case["geom"]
    inp = decode_inputs(g["B"], g["T"], g["H"], g["K"], g["D"],
                        g["lengths"], g.get("seed", 0))
    with mesh:
        out = jax.jit(lambda q, k, v, ln: decode_attention_shardmap(
            q, k, v, ln, mesh=mesh, rules=rules, window=g.get("window", 0),
            softcap=g.get("softcap", 0.0)))(
                inp["q"], inp["k"], inp["v"], inp["lengths"])
        res = {"out": np.asarray(out)}
        for mode in ("scatter", "blend", "shard"):
            res[f"insert/{mode}"] = np.asarray(jax.jit(
                lambda c, n, ln, mode=mode: cache_insert(
                    c, n, ln, mode=mode, mesh=mesh, rules=rules))(
                        inp["k"], inp["new"], inp["lengths"]))
    return res


def start(kind, cases, tmp_path, devices=4):
    """Start this script in a child process over ``cases`` with
    ``devices`` CPU devices; returns (the process, the npz path it
    writes)."""
    import os
    import pathlib
    import subprocess

    cases_path = tmp_path / f"{kind}_cases.json"
    cases_path.write_text(json.dumps(cases))
    out = tmp_path / f"{kind}_ref.npz"
    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [src, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.Popen(
        [sys.executable, __file__, kind, str(cases_path), str(out)],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE,
        text=True)
    return proc, out


def finish(proc, out, timeout=400):
    """Wait for ``start``'s child (killed past ``timeout`` s) and load
    its outputs."""
    import subprocess

    try:
        _, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise
    if proc.returncode:
        raise RuntimeError(f"the reference child failed:\n{err[-4000:]}")
    return dict(np.load(out))


def main(kind, cases_path, out_path):
    cases = json.loads(open(cases_path).read())
    run = {"model": run_model, "moe": run_moe, "decode": run_decode,
           "loss": run_loss, "dryrun": run_dryrun, "paged": run_paged}[kind]
    out = {}
    for i, case in enumerate(cases):
        for name, arr in run(case).items():
            out[f"{i}/{name}"] = arr
    np.savez(out_path, **out)


if __name__ == "__main__":
    main(*sys.argv[1:])
