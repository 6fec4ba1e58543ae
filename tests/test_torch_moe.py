"""The port's mixture-of-experts layer (``repro_torch.layers.moe``, the
dense form) held to the JAX package's dense oracle on bridged weights:
output at float32 rtol = atol = 2e-4 (another summation order) and the
router's aux loss at 1e-5; padded experts never chosen; the
shared-expert branch (a config override, as deepseek-v3 has one);
``impl="ep"`` with no mesh is the dense form (the expert-parallel path
is ``tests/test_torch_moe_ep.py``'s).  Inputs come from numpy
with a seed."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.common.config import ArchConfig as RefArchConfig
from repro.common.config import get_config as ref_get_config
from repro.layers.initializers import init_tree as ref_init_tree
from repro.layers.moe import moe_apply_dense as ref_moe_apply_dense
from repro.layers.moe import moe_specs as ref_moe_specs
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import ArchConfig
from repro_torch.common.pytree import tree_leaves
from repro_torch.layers import moe

TOL = dict(rtol=2e-4, atol=2e-4)


def _cfgs(**kw):
    """The same MoE config in both packages."""
    base = dict(name="m", family="moe", n_layers=1, d_model=16, n_heads=2,
                n_kv_heads=2, d_ff=32, vocab_size=32, n_experts=6,
                experts_top_k=2, moe_d_ff=32)
    base.update(kw)
    return RefArchConfig(**base), ArchConfig(**base)


def _granite_smoke():
    ref_cfg = ref_get_config("granite-moe-3b-a800m", smoke=True)
    return ref_cfg, ArchConfig(**dataclasses.asdict(ref_cfg))


def _params(ref_cfg, seed=0):
    jp = ref_init_tree(jax.random.PRNGKey(seed), ref_moe_specs(ref_cfg))
    return jp, params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")


def _x(cfg, B=3, S=5, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)


@pytest.mark.parametrize("cfgs", [
    _granite_smoke(),                         # 5 experts padded to 6, top-2
    _cfgs(n_experts=5, expert_pad_to=8, experts_top_k=3),
    _cfgs(act_fn="gelu_tanh"),
], ids=["granite-smoke", "pad-8-top-3", "gelu"])
def test_dense_moe_matches_reference(cfgs):
    ref_cfg, cfg = cfgs
    jp, tp = _params(ref_cfg)
    x = _x(cfg)
    y_j, aux_j = ref_moe_apply_dense(jp, x, ref_cfg)
    y_t, aux_t = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)


def test_specs_match_reference():
    ref_cfg, cfg = _cfgs(n_experts=5, expert_pad_to=8, n_shared_experts=1)
    assert moe.padded_experts(cfg) == 8
    want = jax.tree.leaves(ref_moe_specs(ref_cfg),
                           is_leaf=lambda x: hasattr(x, "shape"))
    got = tree_leaves(moe.moe_specs(cfg))
    assert sorted(w.shape for w in got) == sorted(w.shape for w in want)
    assert moe.moe_specs(cfg)["router"].shape == (16, 5)
    assert moe.moe_specs(cfg)["wi_gate"].shape == (8, 16, 32)


def test_padded_experts_are_never_selected():
    """The router sees the real experts only: no token routes to a padded
    one, and whatever a padded expert's weights hold, the output stays."""
    ref_cfg, cfg = _cfgs(n_experts=5, expert_pad_to=8, experts_top_k=3)
    _, tp = _params(ref_cfg)
    x = torch.from_numpy(_x(cfg, B=4, S=16))
    _, idx, _ = moe._route(x.reshape(-1, cfg.d_model), tp["router"], cfg)
    assert int(idx.max()) < cfg.n_experts
    y, _ = moe.moe_apply(tp, x, cfg)
    poisoned = dict(tp)
    for name in ("wi_gate", "wi_up", "wo"):
        w = tp[name].clone()
        w[cfg.n_experts:] = 1e4
        poisoned[name] = w
    y2, _ = moe.moe_apply(poisoned, x, cfg)
    torch.testing.assert_close(y2, y, rtol=0, atol=0)


def test_gates_renormalise_to_one():
    ref_cfg, cfg = _cfgs(experts_top_k=3)
    _, tp = _params(ref_cfg)
    gates, idx, aux = moe._route(
        torch.from_numpy(_x(cfg)).reshape(-1, cfg.d_model), tp["router"], cfg)
    torch.testing.assert_close(gates.sum(-1), torch.ones(gates.shape[0]))
    assert idx.shape == gates.shape == (15, 3) and float(aux) > 0


def test_shared_expert_branch_matches_reference():
    ref_cfg, cfg = _granite_smoke()
    ref_cfg = ref_cfg.with_overrides(n_shared_experts=1)
    cfg = cfg.with_overrides(n_shared_experts=1)
    jp, tp = _params(ref_cfg, seed=3)
    assert set(tp["shared"]) == {"wi_gate", "wi_up", "wo"}
    x = _x(cfg, seed=4)
    y_j, aux_j = ref_moe_apply_dense(jp, x, ref_cfg)
    y_t, aux_t = moe.moe_apply(tp, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), **TOL)
    np.testing.assert_allclose(float(aux_t), float(aux_j), rtol=1e-5)
    # the shared branch adds to every token
    no_shared = {k: v for k, v in tp.items() if k != "shared"}
    y0, _ = moe.moe_apply(no_shared, torch.from_numpy(x),
                          cfg.with_overrides(n_shared_experts=0))
    assert (y_t - y0).abs().max().item() > 1e-3


def test_expert_parallel_path_waits_for_the_distributed_slice():
    """``impl="ep"`` needs a mesh (``tests/test_torch_moe_ep.py``); with
    none it is the dense form, as the reference's ``moe_apply`` is; an
    unknown impl raises."""
    ref_cfg, cfg = _cfgs()
    _, tp = _params(ref_cfg)
    x = torch.from_numpy(_x(cfg))
    y_ep, aux_ep = moe.moe_apply(tp, x, cfg, impl="ep")
    y_d, aux_d = moe.moe_apply(tp, x, cfg)
    torch.testing.assert_close(y_ep, y_d, rtol=0, atol=0)
    torch.testing.assert_close(aux_ep, aux_d, rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        moe.moe_apply(tp, x, cfg, impl="sparse")
