"""The port's expert-parallel MoE (``layers.moe.moe_apply_ep``) held to
the JAX package's ``moe_apply_ep`` on the same weights and tokens: y at
float32 rtol = atol = 2e-4, ``aux`` at 1e-4, at meshes (1, 1) in this
process and (1, 2), (2, 2), (1, 4) on gloo ranks, with an ample
capacity factor (8: nothing dropped, equal to the dense form) and the
default 1.25 (tokens dropped past capacity, each data shard with its
own; at (2, 2) ``aux`` is the mean of the shards' own losses).  Also:
padded experts are never chosen, the shared expert adds in, the
gradients equal ``jax.grad``'s, ``moe_apply`` falls back to the dense
form where the reference does.

Configs (``tests/torch_mesh_ref.moe_cfg``): "granite" is the smoke
granite (5 experts padded to 6, top-2), "pad4" 6 experts padded to 8
(top-2), "shared" pad4 with one shared expert.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ref as mref
import torch_mesh_workers as mw
from torch_mesh_workers import world1  # noqa: F401  (a fixture)
from repro.common.sharding import local_mesh as ref_local_mesh
from repro.layers.moe import moe_apply_dense as ref_moe_apply_dense
from repro.layers.moe import moe_apply_ep as ref_moe_apply_ep
from repro_torch.common import sharding
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import ArchConfig
from repro_torch.layers import moe

TOL = dict(rtol=2e-4, atol=2e-4)
AUX_TOL = dict(rtol=1e-4, atol=1e-4)
KINDS = ("granite", "pad4", "shared")
MESHES = ((1, 2), (2, 2), (1, 4))
CASES = [dict(mesh=list(m), cfg=k, cf=cf, x=[4, 8])
         for m in MESHES for k in KINDS for cf in (8.0, 1.25)]


def _cfg(kind):
    return ArchConfig(**dataclasses.asdict(mref.moe_cfg(kind)))


def _x(kind, B=4, S=8):
    return mref.moe_x(_cfg(kind).d_model, B, S)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("cf", [8.0, 1.25])
def test_ep_1x1_matches_reference(world1, kind, cf):
    jp = mref.moe_params(kind)
    x = _x(kind)
    y_j, aux_j = jax.jit(lambda p, xx: ref_moe_apply_ep(
        p, xx, mref.moe_cfg(kind), ref_local_mesh((1, 1)),
        capacity_factor=cf))(jp, x)
    y_t, aux_t = moe.moe_apply_ep(params_from_numpy(jp, "cpu"),
                                  torch.from_numpy(x), _cfg(kind), world1,
                                  capacity_factor=cf)
    np.testing.assert_allclose(y_t.full_tensor().numpy(), np.asarray(y_j),
                               **TOL)
    np.testing.assert_allclose(float(aux_t.full_tensor()), float(aux_j),
                               **AUX_TOL)


def test_ep_with_ample_capacity_is_the_dense_form(world1):
    """cf 8 drops nothing: EP == the dense oracle (and the reference's)."""
    jp = mref.moe_params("pad4")
    x = _x("pad4")
    y_d, aux_d = ref_moe_apply_dense(jp, x, mref.moe_cfg("pad4"))
    y_e, aux_e = moe.moe_apply(params_from_numpy(jp, "cpu"),
                               torch.from_numpy(x), _cfg("pad4"),
                               mesh=world1, impl="ep")
    np.testing.assert_allclose(y_e.full_tensor().numpy(), np.asarray(y_d),
                               **TOL)
    np.testing.assert_allclose(float(aux_e.full_tensor()), float(aux_d),
                               **AUX_TOL)


def test_default_capacity_drops_tokens(world1):
    """At cf 1.25 granite's 32 tokens overflow one expert's capacity of
    16: the output leaves the dense form's (the reference's does too)."""
    cfg = _cfg("granite")
    tp = params_from_numpy(mref.moe_params("granite"), "cpu")
    x = torch.from_numpy(_x("granite"))
    _, idx, _ = moe._route(x.reshape(-1, cfg.d_model), tp["router"], cfg)
    C = math.ceil(idx.numel() * 1.25 / cfg.n_experts)
    assert int(torch.bincount(idx.reshape(-1)).max()) > C
    y_d, _ = moe.moe_apply_dense(tp, x, cfg)
    y_e, _ = moe.moe_apply_ep(tp, x, cfg, world1)
    assert float((y_e.full_tensor() - y_d).abs().max()) > 1e-3


def test_padded_experts_are_never_selected(world1):
    """Whatever a padded expert's weights hold, EP's output stays."""
    tp = params_from_numpy(mref.moe_params("pad4"), "cpu")
    cfg = _cfg("pad4")
    x = torch.from_numpy(_x("pad4"))
    y, _ = moe.moe_apply_ep(tp, x, cfg, world1)
    poisoned = dict(tp)
    for name in ("wi_gate", "wi_up", "wo"):
        w = tp[name].clone()
        w[cfg.n_experts:] = 1e4
        poisoned[name] = w
    y2, _ = moe.moe_apply_ep(poisoned, x, cfg, world1)
    torch.testing.assert_close(y2.full_tensor(), y.full_tensor(), rtol=0,
                               atol=0)


def test_shared_expert_adds_to_every_token(world1):
    jp = mref.moe_params("shared")
    tp = params_from_numpy(jp, "cpu")
    x = torch.from_numpy(_x("shared"))
    y1, _ = moe.moe_apply_ep(tp, x, _cfg("shared"), world1)
    no_shared = {k: v for k, v in tp.items() if k != "shared"}
    y0, _ = moe.moe_apply_ep(no_shared, x, _cfg("pad4"), world1)
    diff = (y1.full_tensor() - y0.full_tensor()).abs().amax(-1)
    assert bool((diff > 0).all())


@pytest.mark.parametrize("kind", ["pad4", "shared"])
def test_ep_gradients_match_jax_grad(world1, kind):
    jp = mref.moe_params(kind)
    x = _x(kind, B=2, S=4)
    cfg_j = mref.moe_cfg(kind)

    def loss_j(p):
        y, aux = ref_moe_apply_ep(p, x, cfg_j, ref_local_mesh((1, 1)),
                                  capacity_factor=1.25)
        return jnp.sum(y ** 2) + 0.01 * aux

    g_j = jax.jit(jax.grad(loss_j))(jax.tree.map(jnp.asarray, jp))
    # the weights placed as the model places them (DTensors)
    tp = sharding.shard_tree(params_from_numpy(jp, "cpu"),
                             moe.moe_specs(_cfg(kind)),
                             sharding.merge_rules(), world1)
    leaves = [t.requires_grad_() for t in _leaves(tp)]
    y, aux = moe.moe_apply_ep(tp, torch.from_numpy(x), _cfg(kind), world1)
    ((y.full_tensor() ** 2).sum() + 0.01 * aux.full_tensor()).backward()
    want = [np.asarray(a) for a in _leaves(g_j)]
    assert len(leaves) == len(want)
    for got, w in zip(leaves, want):
        np.testing.assert_allclose(got.grad.full_tensor().numpy(), w,
                                   rtol=2e-4,
                                   atol=2e-4 * max(1.0, np.abs(w).max()))
    assert float(tp["wi_gate"].grad.full_tensor().abs().max()) > 0


def _leaves(tree):
    return [leaf for _, leaf in mref.leaf_paths(tree)]


def test_moe_apply_falls_back_to_dense(world1):
    """No model axis in the mesh, or experts it does not divide: the
    dense form, as in the reference; an unknown impl raises."""
    tp = params_from_numpy(mref.moe_params("granite"), "cpu")
    x = torch.from_numpy(_x("granite"))
    cfg = _cfg("granite")
    y_d, aux_d = moe.moe_apply_dense(tp, x, cfg)
    y_e, aux_e = moe.moe_apply_ep(tp, x, cfg, world1, ep_axis="experts")
    torch.testing.assert_close(y_e.full_tensor(), y_d, **TOL)
    torch.testing.assert_close(aux_e.full_tensor(), aux_d, **TOL)
    y0, _ = moe.moe_apply(tp, x, cfg)
    torch.testing.assert_close(y0, y_d, rtol=0, atol=0)
    with pytest.raises(ValueError, match="impl"):
        moe.moe_apply(tp, x, cfg, impl="routed")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    cfgs = {k: _cfg(k) for k in KINDS}
    params = {k: mref.moe_params(k) for k in KINDS}
    return mw.run_cases("moe", mw.moe_worker, CASES,
                        tmp_path_factory.mktemp("moe_ep"), cfgs, params)


@pytest.mark.parametrize("i", range(len(CASES)), ids=[
    f"{c['mesh'][0]}x{c['mesh'][1]}-{c['cfg']}-cf{c['cf']:g}" for c in CASES])
def test_ep_multi_rank_matches_reference(outputs, i):
    ref, port = outputs
    np.testing.assert_allclose(port[f"{i}/y"], ref[f"{i}/y"], **TOL)
    np.testing.assert_allclose(port[f"{i}/aux"], ref[f"{i}/aux"], **AUX_TOL)


def test_data_shards_route_apart_at_2x2(outputs):
    """At (2, 2) with cf 1.25 the granite shards' capacities and aux are
    their own: the sharded output is not the (1, 1) one."""
    ref, port = outputs
    i22 = next(i for i, c in enumerate(CASES) if c["mesh"] == [2, 2]
               and c["cfg"] == "granite" and c["cf"] == 1.25)
    i12 = next(i for i, c in enumerate(CASES) if c["mesh"] == [1, 2]
               and c["cfg"] == "granite" and c["cf"] == 1.25)
    assert abs(float(port[f"{i22}/aux"]) - float(port[f"{i12}/aux"])) > 1e-4
