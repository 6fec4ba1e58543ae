"""The port's training substrate (``repro_torch.training``): the
counterparts of ``tests/test_training.py`` (loss goes down, microbatch
equivalence, optimizer semantics, gradient compression), then the two
packages side by side: ``lr_schedule``, ``adamw_update`` on identical
gradients (float32 and bfloat16 moments), the int8 quantiser on shared
noise, ``state_specs``, and a 5-step loss trajectory of tinyllama-1.1b's
smoke config through ``make_train_step`` on bridged weights.

Tolerances: the schedule at float32 rounding (rtol 1e-6); one AdamW
update on identical gradients at rtol = atol = 2e-4 (bfloat16 moments at
one bfloat16 ulp, 2^-7 relative); the quantiser exact but where a value
sits on a rounding edge (at most one step there); the trajectory at rtol
1e-4.  Adam's first step is nearly a sign function, so parameters after
k steps are not compared across packages: a gradient near 0 that rounds
differently moves its parameter by 2 lr."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import TrainConfig as RefTrainConfig
from repro.common.config import get_config as ref_get_config
from repro.models.api import build_model as ref_build_model
from repro.training import optimizer as jopt
from repro.training.data import DataConfig as RefDataConfig
from repro.training.data import TokenStream as RefTokenStream
from repro.training.train_step import make_train_step as ref_make_train_step
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import TrainConfig, get_config
from repro_torch.common.pytree import tree_leaves, tree_map
from repro_torch.models.api import build_model
from repro_torch.training.data import DataConfig, TokenStream
from repro_torch.training.optimizer import (
    adamw_update, compress_grads_int8, init_state, lr_schedule,
    quantize_int8, state_specs,
)
from repro_torch.training.train_step import (
    batch_to_tensors, loss_and_grads, make_train_step, microbatch_grads,
)

TOL = dict(rtol=2e-4, atol=2e-4)


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _setup(microbatches=1, **tkw):
    cfg = get_config("tinyllama-1.1b", smoke=True)
    bundle = build_model(cfg, compute_dtype=torch.float32)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=5, total_steps=60,
                       microbatches=microbatches, **tkw)
    params = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    state = init_state(params, tcfg)
    return cfg, bundle, tcfg, state, make_train_step(bundle, tcfg)


# -- the counterparts of tests/test_training.py ------------------------------

def test_loss_decreases_on_synthetic_data():
    cfg, bundle, tcfg, state, step = _setup()
    data = TokenStream(DataConfig(seq_len=32, global_batch=8,
                                  vocab_size=cfg.vocab_size))
    losses = []
    for i, batch in zip(range(40), data):
        state, metrics = step(state, batch_to_tensors(batch, "cpu"))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.5, (losses[0], losses[-1])
    assert int(state["step"]) == 40


def test_microbatching_matches_full_batch_grads():
    cfg, bundle, tcfg1, state1, step1 = _setup(microbatches=1)
    _, _, tcfg2, state2, step2 = _setup(microbatches=2)
    data = TokenStream(DataConfig(seq_len=16, global_batch=4,
                                  vocab_size=cfg.vocab_size))
    batch = batch_to_tensors(next(data), "cpu")
    s1, m1 = step1(state1, batch)
    s2, m2 = step2(state2, batch)
    # same params after one update (up to accumulation-order fp error)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=2e-3,
                                   atol=2e-5)
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("k", [2, 4])
def test_microbatch_grads_equal_full_batch_grads(k):
    """The accumulated gradients themselves (the step's input): each
    leaf within 1e-5 relative L2 of the full batch's, the loss at 1e-6."""
    cfg, bundle, _, state, _ = _setup()
    data = TokenStream(DataConfig(seq_len=16, global_batch=8,
                                  vocab_size=cfg.vocab_size))
    batch = batch_to_tensors(next(data), "cpu")
    l1, _, g1 = loss_and_grads(bundle, state["params"], batch)
    lk, mk, gk = microbatch_grads(bundle, state["params"], batch, k)
    assert sorted(mk) == ["loss"]
    np.testing.assert_allclose(float(lk), float(l1), rtol=1e-6)
    for a, b in zip(tree_leaves(gk), tree_leaves(g1)):
        assert a.dtype == torch.float32
        assert float((a - b).norm() / b.norm().clamp_min(1e-30)) <= 1e-5
    with pytest.raises(ValueError):
        microbatch_grads(bundle, state["params"], batch, 3)


def test_lr_schedule_warmup_and_decay():
    tcfg = TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100)
    lr5 = float(lr_schedule(tcfg, torch.tensor(5)))
    lr10 = float(lr_schedule(tcfg, torch.tensor(10)))
    lr100 = float(lr_schedule(tcfg, torch.tensor(100)))
    assert lr5 < lr10
    assert lr100 < lr10
    assert lr100 >= 0.09          # cosine floor at 10%


def test_adamw_moves_params_against_gradient():
    tcfg = TrainConfig(learning_rate=0.1, warmup_steps=0, total_steps=10,
                       weight_decay=0.0, grad_clip=0.0)
    state = init_state({"w": torch.ones((4, 4))}, tcfg)
    new_state, metrics = adamw_update(state, {"w": torch.ones((4, 4))}, tcfg)
    assert float(new_state["params"]["w"].mean()) < 1.0
    assert float(metrics["grad_norm"]) > 0
    assert int(new_state["step"]) == 1


def test_grad_clip_limits_update_norm():
    tcfg = TrainConfig(learning_rate=0.1, grad_clip=1.0, warmup_steps=0,
                       total_steps=10)
    state = init_state({"w": torch.zeros((8,))}, tcfg)
    new_state, metrics = adamw_update(
        state, {"w": torch.full((8,), 1e6)}, tcfg)
    assert torch.isfinite(new_state["params"]["w"]).all()


def test_int8_compression_preserves_grads_approximately():
    g = torch.Generator().manual_seed(0)
    grads = {"a": torch.randn((128,), generator=g),
             "b": torch.randn((64, 8), generator=g) * 10}
    gq = compress_grads_int8(grads, torch.Generator().manual_seed(2))
    for k in grads:
        err = float((gq[k] - grads[k]).abs().max())
        scale = float(grads[k].abs().max()) / 127.0
        assert err <= scale * 1.01   # one quantization step

    # stochastic rounding is unbiased: mean error ~ 0
    big = torch.randn((100_000,), generator=g)
    bq = compress_grads_int8({"x": big}, torch.Generator().manual_seed(4))["x"]
    assert abs(float((bq - big).mean())) < 1e-4
    # the same generator seed gives the same rounding
    again = compress_grads_int8({"x": big},
                                torch.Generator().manual_seed(4))["x"]
    assert torch.equal(bq, again)


def test_int8_compressed_update_is_deterministic_and_near_the_plain_one():
    """Through ``adamw_update``: the noise is seeded from the config's
    seed and the step, so two runs agree bit for bit; the update moves
    each weight within one quantisation step's worth of the uncompressed
    update's direction (Adam normalises it)."""
    g = torch.Generator().manual_seed(7)
    params = {"w": torch.randn((16, 8), generator=g),
              "b": torch.randn((8,), generator=g)}
    grads = {k: torch.randn(v.shape, generator=g) for k, v in params.items()}
    out = {}
    for mode in ("int8", "int8", "none"):
        tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=0, total_steps=4,
                           grad_compression=mode)
        state = init_state(tree_map(torch.clone, params), tcfg)
        for _ in range(2):
            state, _ = adamw_update(state, grads, tcfg)
        out.setdefault(mode, []).append(state["params"])
    a, b = out["int8"]
    for k in params:
        assert torch.equal(a[k], b[k])
        assert float((a[k] - out["none"][0][k]).abs().max()) < 2e-2
        assert not torch.equal(a[k], out["none"][0][k])


def test_moment_dtype_bf16():
    tcfg = TrainConfig(moment_dtype="bfloat16")
    state = init_state({"w": torch.ones((4,))}, tcfg)
    assert state["m"]["w"].dtype == torch.bfloat16
    new_state, _ = adamw_update(state, {"w": torch.ones((4,))}, tcfg)
    assert new_state["m"]["w"].dtype == torch.bfloat16


def test_state_specs_mirror_param_tree():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    bundle = build_model(cfg, compute_dtype=torch.float32)
    ss = state_specs(bundle.specs, TrainConfig())
    assert len(tree_leaves(bundle.specs)) == len(tree_leaves(ss["m"])) \
        == len(tree_leaves(ss["v"]))


# -- the two packages side by side -------------------------------------------

def test_lr_schedule_matches_reference():
    kw = dict(learning_rate=3e-4, warmup_steps=7, total_steps=50)
    for step in (0, 1, 3, 7, 8, 20, 49, 50, 80):
        np.testing.assert_allclose(
            float(lr_schedule(TrainConfig(**kw), torch.tensor(step))),
            float(jopt.lr_schedule(RefTrainConfig(**kw), jnp.asarray(step))),
            rtol=1e-6)


def _param_grad_pairs():
    """tinyllama smoke weights and three sets of gradients, from numpy."""
    cfg = ref_get_config("tinyllama-1.1b", smoke=True)
    jp = jax.tree.map(np.asarray, jax.jit(
        ref_build_model(cfg, compute_dtype=jnp.float32).init)(
            jax.random.PRNGKey(0)))
    rng = np.random.default_rng(5)
    grads = [jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape))
                          .astype(np.float32), jp)
             for scale in (1e-2, 3.0, 1e-4)]
    return jp, grads


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_adamw_update_matches_reference_on_identical_grads(moments):
    """Three updates (the second with gradients above the clip), weight
    decay on the >= 2-d leaves, the same numpy gradients into both."""
    jp, grads = _param_grad_pairs()
    kw = dict(learning_rate=1e-2, warmup_steps=2, total_steps=10,
              weight_decay=0.1, grad_clip=1.0, moment_dtype=moments)
    js = jopt.init_state(jax.tree.map(jnp.asarray, jp), RefTrainConfig(**kw))
    ts = init_state(params_from_numpy(jp, "cpu"), TrainConfig(**kw))
    for g in grads:
        js, jm = jopt.adamw_update(js, jax.tree.map(jnp.asarray, g),
                                   RefTrainConfig(**kw))
        ts, tm = adamw_update(ts, params_from_numpy(g, "cpu"),
                              TrainConfig(**kw))
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-5)
    assert int(ts["step"]) == int(js["step"]) == 3
    mom_tol = TOL if moments == "float32" else dict(rtol=2 ** -7, atol=1e-6)
    for part, tol in (("params", TOL), ("m", mom_tol), ("v", mom_tol)):
        for t, j in zip(_leaves(ts[part]), jax.tree.leaves(js[part])):
            assert str(t.dtype).split(".")[1] == str(j.dtype)
            np.testing.assert_allclose(t.float().numpy(),
                                       np.asarray(j, np.float32), **tol)


def test_int8_quantizer_matches_reference_on_shared_noise():
    """The reference draws leaf i's noise from ``fold_in(key, i)``; the
    same noise into the port's quantiser gives the reference's result."""
    rng = np.random.default_rng(6)
    grads = {"a": rng.standard_normal((257,)).astype(np.float32),
             "b": (10 * rng.standard_normal((64, 9))).astype(np.float32),
             "c": np.zeros((5,), np.float32)}
    key = jax.random.PRNGKey(11)
    want = jopt.compress_grads_int8(jax.tree.map(jnp.asarray, grads), key)
    for i, name in enumerate(sorted(grads)):     # jax's leaf order
        g = grads[name]
        noise = np.array(jax.random.uniform(
            jax.random.fold_in(key, i), g.shape, jnp.float32) - 0.5)
        got = quantize_int8(torch.from_numpy(g),
                            torch.from_numpy(noise)).numpy()
        ref = np.asarray(want[name])
        step = max(np.abs(g).max(), 1e-12) / 127.0
        # identical but where x + noise sits on a rounding edge
        assert np.abs(got - ref).max() <= step * 1.001
        assert np.mean(got == ref) > 0.99


def test_state_specs_match_reference():
    cfg = get_config("tinyllama-1.1b", smoke=True)
    for moments in ("float32", "bfloat16"):
        ts = state_specs(build_model(cfg, compute_dtype=torch.float32).specs,
                         TrainConfig(moment_dtype=moments))
        js = jopt.state_specs(
            ref_build_model(ref_get_config("tinyllama-1.1b", smoke=True)).specs,
            RefTrainConfig(moment_dtype=moments))
        is_ws = lambda x: hasattr(x, "axes")
        j_leaves = jax.tree.leaves(js, is_leaf=is_ws)
        t_leaves = _leaves(ts)
        assert len(t_leaves) == len(j_leaves)
        for t, j in zip(t_leaves, j_leaves):
            assert (t.shape, t.axes, t.init) == (j.shape, j.axes, j.init)
            want = None if j.dtype is None else str(jnp.dtype(j.dtype))
            got = None if t.dtype is None else str(t.dtype).split(".")[1]
            assert got == want


def test_five_step_loss_trajectory_matches_reference():
    cfg = ref_get_config("tinyllama-1.1b", smoke=True)
    kw = dict(learning_rate=3e-3, warmup_steps=2, total_steps=20)
    jb = ref_build_model(cfg, compute_dtype=jnp.float32)
    jp = jax.jit(jb.init)(jax.random.PRNGKey(0))
    js = jopt.init_state(jp, RefTrainConfig(**kw))
    jstep = jax.jit(ref_make_train_step(jb, RefTrainConfig(**kw)))
    tb = build_model(get_config("tinyllama-1.1b", smoke=True),
                     compute_dtype=torch.float32)
    ts = init_state(params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"),
                    TrainConfig(**kw))
    tstep = make_train_step(tb, TrainConfig(**kw))
    dkw = dict(seq_len=32, global_batch=4, vocab_size=cfg.vocab_size)
    jl, tl = [], []
    for jbatch, tbatch in zip(RefTokenStream(RefDataConfig(**dkw)),
                              TokenStream(DataConfig(**dkw))):
        js, jm = jstep(js, {k: jnp.asarray(v) for k, v in jbatch.items()})
        ts, tm = tstep(ts, batch_to_tensors(tbatch, "cpu"))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        if len(tl) == 5:
            break
    np.testing.assert_allclose(tl, jl, rtol=1e-4)
    assert tl[-1] < tl[0]


def test_train_step_leaves_the_params_without_grad():
    """The step differentiates detached aliases: the state's tensors
    never require grad, so a model served from them needs no
    ``torch.no_grad()`` on the card."""
    cfg, bundle, tcfg, state, step = _setup()
    data = TokenStream(DataConfig(seq_len=8, global_batch=2,
                                  vocab_size=cfg.vocab_size))
    before = tree_map(torch.clone, state["params"])
    state, _ = step(state, batch_to_tensors(next(data), "cpu"))
    leaves = tree_leaves(state["params"])
    assert not any(p.requires_grad for p in leaves)
    assert any(not torch.equal(a, b)
               for a, b in zip(leaves, tree_leaves(before)))
