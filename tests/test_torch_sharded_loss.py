"""The port's training loss under a mesh held to the JAX package's.

``bundle.loss_fn`` of ``build_model(cfg, mesh=..., rules=...)`` with the
default rules (the vocabulary sharded over "model": a vocab-sharded
embedding gather and a vocab-sharded cross entropy), smoke tinyllama-1.1b
and granite-moe-3b-a800m with weights bridged from the reference's
PRNGKey(0) init, on gloo ranks at meshes (1, 2) and (2, 2)
(``tests/torch_mesh_workers.loss_worker``, ``loss_and_grads``):

* the loss against the reference's *unsharded* ``loss_fn`` at float32
  rtol = atol = 2e-4, and every gradient leaf, gathered, against
  ``jax.grad`` of it at relative L2 <= 1e-4 (a leaf whose reference
  gradient is exactly zero, an expert no token reaches, within 1e-8);
* the loss alone against the reference's *sharded* loss at the same
  mesh (a child process with ``jax.sharding.Mesh``,
  ``tests/torch_mesh_ref.py``'s "loss" kind), at 2e-4.

Under a mesh granite's MoE is expert-parallel: each data shard routes its
own tokens, drops past its own capacity and averages its own router loss.
So it equals the unsharded function only where nothing drops (the port's
``moe_capacity_factor`` at ``n_experts / experts_top_k``) and, across
data shards, without the router loss (``router_aux_loss=0``, both
sides); at the default factor 1.25 it is held to the reference's
sharded loss.  One tinyllama case adds ``z_loss``; deepseek-v3-671b
(the MTP loss, MLA, a shared expert; at its no-drop capacity) and
whisper-tiny (the encoder-decoder loss) add one case each at (1, 2).
zamba2-7b and xlstm-1.3b (the recurrent families: Mamba2's plain SSD and
the sLSTM's plain recurrence per rank on its heads, the mLSTM's cell on
its heads, their gradients through ``shard_map``) at (1, 2) and (2, 2).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_mesh_ref as mref
import torch_mesh_workers as mw
from repro.models.api import build_model as ref_build_model

TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_RTOL = 1e-4
ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m", "zamba2-7b", "xlstm-1.3b")
NO_DROP = {"moe_capacity_factor": 2.5}     # smoke granite: 5 experts, top-2

# the port's cases: with ``grads`` held to the unsharded reference
CASES = [
    dict(arch="tinyllama-1.1b", mesh=[1, 2], grads=True),
    dict(arch="tinyllama-1.1b", mesh=[2, 2], grads=True),
    dict(arch="tinyllama-1.1b", mesh=[1, 2], grads=True,
         opts={"z_loss": 1e-3}),
    dict(arch="granite-moe-3b-a800m", mesh=[1, 2], grads=True,
         opts=NO_DROP),
    dict(arch="granite-moe-3b-a800m", mesh=[2, 2], grads=True,
         opts=NO_DROP, cfg={"router_aux_loss": 0.0}),
    dict(arch="granite-moe-3b-a800m", mesh=[1, 2]),
    dict(arch="granite-moe-3b-a800m", mesh=[2, 2]),
    dict(arch="deepseek-v3-671b", mesh=[1, 2], grads=True,
         opts={"moe_capacity_factor": 4.0}),      # smoke: 8 experts, top-2
    dict(arch="whisper-tiny", mesh=[1, 2], grads=True),
    dict(arch="zamba2-7b", mesh=[1, 2], grads=True),
    dict(arch="zamba2-7b", mesh=[2, 2], grads=True),
    dict(arch="xlstm-1.3b", mesh=[1, 2], grads=True),
    dict(arch="xlstm-1.3b", mesh=[2, 2], grads=True),
]
# the reference's sharded losses: each (arch, mesh) at the defaults
REF_CASES = [dict(arch=a, mesh=m) for a in ARCHS for m in ([1, 2], [2, 2])]


def _case_id(c):
    extra = "".join(f"-{k}" for k in {**c.get("opts", {}),
                                      **c.get("cfg", {})})
    return f"{c['arch'].split('-')[0]}-{c['mesh'][0]}x{c['mesh'][1]}{extra}"


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    params = {a: mref.model_params(a) for a in {c["arch"] for c in CASES}}
    tmp = tmp_path_factory.mktemp("sharded_loss")
    proc, npz = mref.start("loss", REF_CASES, tmp)
    try:
        port = {}
        for shape in ((1, 2), (2, 2)):
            mine = [(i, c) for i, c in enumerate(CASES)
                    if tuple(c["mesh"]) == shape]
            out = tmp / f"port_loss_{shape[0]}x{shape[1]}.npz"
            mw.spawn(mw.loss_worker, shape[0] * shape[1], tmp, shape, mine,
                     params, str(out))
            port.update(np.load(out))
    except BaseException:
        proc.kill()
        raise
    return mref.finish(proc, npz), port


@functools.lru_cache(maxsize=None)
def _unsharded(arch, cfg_items, opt_items):
    """The reference's unsharded loss and ``jax.grad`` by leaf path."""
    cfg = mref.model_cfg(arch).with_overrides(**dict(cfg_items))
    b = ref_build_model(cfg, compute_dtype=jnp.float32, **dict(opt_items))
    params = jax.tree.map(jnp.asarray, mref.model_params(arch))
    batch = {k: jnp.asarray(v) for k, v in mref.loss_batch(cfg).items()}
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: b.loss_fn(p, batch)[0]))(params)
    return float(loss), {path: np.asarray(g)
                         for path, g in mref.leaf_paths(grads)}


GRAD_CASES = [i for i, c in enumerate(CASES) if c.get("grads")]


@pytest.mark.parametrize("i", GRAD_CASES,
                         ids=[_case_id(CASES[i]) for i in GRAD_CASES])
def test_sharded_loss_and_grads_match_unsharded_reference(outputs, i):
    _, port = outputs
    c = CASES[i]
    opts = {k: v for k, v in c.get("opts", {}).items()
            if k != "moe_capacity_factor"}     # a port-only option
    loss, grads = _unsharded(c["arch"], tuple(c.get("cfg", {}).items()),
                             tuple(opts.items()))
    np.testing.assert_allclose(port[f"{i}/loss"], loss, **TOL)
    got = {k.split("/grad/", 1)[1]: v for k, v in port.items()
           if k.startswith(f"{i}/grad/")}
    assert set(got) == set(grads)
    for path, want in grads.items():
        assert got[path].shape == want.shape, path
        err = float(np.linalg.norm(got[path] - want))
        ref = float(np.linalg.norm(want))
        assert err <= max(GRAD_RTOL * ref, 1e-8), (path, err, ref)


@pytest.mark.parametrize("j", range(len(REF_CASES)),
                         ids=[_case_id(c) for c in REF_CASES])
def test_sharded_loss_matches_sharded_reference(outputs, j):
    ref, port = outputs
    c = REF_CASES[j]
    # the port case at the same arch and mesh with the default options
    i = next(i for i, p in enumerate(CASES)
             if p["arch"] == c["arch"] and p["mesh"] == c["mesh"]
             and not p.get("opts") and not p.get("cfg"))
    np.testing.assert_allclose(port[f"{i}/loss"], ref[f"{j}/loss"], **TOL)
