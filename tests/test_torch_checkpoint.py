"""The port's checkpoints (``repro_torch.training.checkpoint``): the
counterparts of ``tests/test_checkpoint.py`` (roundtrip, atomic commit,
latest-step discovery, shape checks, GC, async save, crash-restart),
the async save's host copy against a later in-place update, bfloat16
leaves, and checkpoints that cross packages in both directions: one
package writes a float32 state in the shared layout, the other restores
it leaf for leaf."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.training import checkpoint as jckpt
from repro_torch.common.pytree import tree_leaves
from repro_torch.training import checkpoint as ckpt


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "step": torch.tensor(7, dtype=torch.int32),
        "params": {"w": torch.randn((4, 3), generator=g),
                   "nested": {"b": torch.arange(5, dtype=torch.float32)}},
        "m": {"w": torch.zeros((4, 3)),
              "nested": {"b": torch.zeros((5,))}},
    }


def _ref_state(seed=0):
    k = jax.random.PRNGKey(seed)
    return {
        "step": jnp.asarray(7, jnp.int32),
        "params": {"w": jax.random.normal(k, (4, 3)),
                   "nested": {"b": jnp.arange(5, dtype=jnp.float32)},
                   "layers": [jnp.ones((2,)), jnp.full((3,), 2.0)]},
        "m": {"w": jnp.zeros((4, 3)),
              "nested": {"b": jnp.zeros((5,))}},
    }


def _like(ref):
    """The port's tree of ``ref``'s structure, zeros of its dtypes."""
    return jax.tree.map(
        lambda x: torch.zeros(x.shape, dtype=getattr(torch, str(x.dtype))),
        ref)


def test_roundtrip(tmp_path):
    state = _state()
    ckpt.save(state, tmp_path, step=7)
    restored = ckpt.restore(state, tmp_path)
    for a, b in zip(tree_leaves(state), tree_leaves(restored)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


def test_latest_step_requires_commit(tmp_path):
    state = _state()
    ckpt.save(state, tmp_path, step=3)
    ckpt.save(state, tmp_path, step=9)
    assert ckpt.latest_step(tmp_path) == 9
    # an uncommitted (crashed) save is invisible
    crashed = tmp_path / "step_00000012" / "proc0"
    crashed.mkdir(parents=True)
    assert ckpt.latest_step(tmp_path) == 9


def test_restore_validates_shapes(tmp_path):
    state = _state()
    ckpt.save(state, tmp_path, step=1)
    wrong = dict(state)
    wrong["params"] = {"w": torch.zeros((9, 9)),
                       "nested": {"b": torch.zeros((5,))}}
    with pytest.raises(ValueError):
        ckpt.restore(wrong, tmp_path)
    extra = dict(state)
    extra["v"] = {"w": torch.zeros((4, 3))}
    with pytest.raises(KeyError):
        ckpt.restore(extra, tmp_path)


def test_gc_keeps_latest_k(tmp_path):
    state = _state()
    for s in (1, 2, 3, 4, 5):
        ckpt.save(state, tmp_path, step=s, keep=2)
    steps = sorted(int(p.name.split("_")[1])
                   for p in tmp_path.glob("step_*"))
    assert steps == [4, 5]


def test_save_async_completes(tmp_path):
    state = _state()
    t = ckpt.save_async(state, tmp_path, step=11)
    t.join(timeout=30)
    assert ckpt.latest_step(tmp_path) == 11
    restored = ckpt.restore(state, tmp_path, step=11)
    assert torch.equal(restored["params"]["w"], state["params"]["w"])


def test_save_async_copies_before_a_later_in_place_update(tmp_path):
    state = _state()
    want = state["params"]["w"].clone()
    t = ckpt.save_async(state, tmp_path, step=4)
    state["params"]["w"].add_(100.0)       # the next step, in place
    t.join(timeout=30)
    assert torch.equal(ckpt.restore(state, tmp_path)["params"]["w"], want)


def test_crash_restart_resumes_from_checkpoint(tmp_path):
    """The fault-tolerance contract: train, checkpoint, 'crash', restore,
    and the step counter + params continue from the committed state."""
    from repro_torch.common.config import TrainConfig, get_config
    from repro_torch.models.api import build_model
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_step import batch_to_tensors, make_train_step

    cfg = get_config("tinyllama-1.1b", smoke=True)
    bundle = build_model(cfg, compute_dtype=torch.float32)
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=2, total_steps=20)
    state = init_state(bundle.init(torch.Generator().manual_seed(0),
                                   device="cpu"), tcfg)
    step = make_train_step(bundle, tcfg)
    data = TokenStream(DataConfig(seq_len=16, global_batch=4,
                                  vocab_size=cfg.vocab_size))
    for i, batch in zip(range(3), data):
        state, _ = step(state, batch_to_tensors(batch, "cpu"))
    ckpt.save(state, tmp_path, step=int(state["step"]))

    # "crash": rebuild everything from scratch, restore
    state2 = init_state(bundle.init(torch.Generator().manual_seed(99),
                                    device="cpu"), tcfg)
    state2 = ckpt.restore(state2, tmp_path)
    assert int(state2["step"]) == 3
    for a, b in zip(tree_leaves(state["params"]),
                    tree_leaves(state2["params"])):
        assert torch.equal(a, b)
    # and it can keep stepping, as the uninterrupted run does
    batch = batch_to_tensors(next(data), "cpu")
    state2, m2 = step(state2, batch)
    state, m1 = step(state, batch)
    assert np.isfinite(float(m2["loss"]))
    assert float(m1["loss"]) == float(m2["loss"])
    for a, b in zip(tree_leaves(state["params"]),
                    tree_leaves(state2["params"])):
        assert torch.equal(a, b)


def test_bfloat16_leaf_roundtrip_and_manifest(tmp_path):
    state = {"step": torch.tensor(2, dtype=torch.int32),
             "m": {"w": torch.randn((3, 5)).to(torch.bfloat16)}}
    ckpt.save(state, tmp_path, step=2)
    manifest = json.loads(
        (tmp_path / "step_00000002" / "proc0" / "manifest.json").read_text())
    assert manifest["leaves"]["m__w"] == {"shape": [3, 5],
                                          "dtype": "bfloat16"}
    assert manifest["leaves"]["step"]["dtype"] == "int32"
    restored = ckpt.restore(state, tmp_path)
    assert restored["m"]["w"].dtype == torch.bfloat16
    assert torch.equal(restored["m"]["w"], state["m"]["w"])


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    ref = _ref_state(3)
    jckpt.save(ref, tmp_path, step=5)
    restored = ckpt.restore(_like(ref), tmp_path)
    assert int(restored["step"]) == 7
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(
            jax.tree.map(lambda t: t.numpy(), restored))):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    ref = _ref_state(4)
    port = jax.tree.map(lambda x: torch.from_numpy(np.array(x)), ref)
    ckpt.save(port, tmp_path, step=6)
    assert jckpt.latest_step(tmp_path) == 6
    restored = jckpt.restore(jax.tree.map(jnp.zeros_like, ref), tmp_path)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(restored)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
