"""The port's sequence-sharded decode (``layers.attention.
decode_attention_shardmap``: each rank's partial softmax over its
sequence tile, an all_reduce MAX and two SUMs) and its cache updates
(``cache_insert`` in the modes "scatter", "blend" and "shard") held to
the JAX package's on the same inputs: float32 rtol = atol = 2e-4 for
the attention, exact for the caches, at meshes (1, 1) in this process
and (1, 2), (2, 2), (1, 4) on gloo ranks.  Geometries: GQA (G = 2),
G = 1, a window, a logit softcap, and rows with no live key in some
ranks' tiles (lengths 0 and 1 over a cache of 16 cut in four).  A
bfloat16 cache (the dry run's serving dtype) under a float32 q: both
decode paths against the reference, which widens the cache to q's dtype.
"""

import jax
import numpy as np
import pytest
import torch

import torch_mesh_ref as mref
import torch_mesh_workers as mw
from torch_mesh_workers import world1  # noqa: F401  (a fixture)
from repro.common.sharding import local_mesh as ref_local_mesh
from repro.common.sharding import merge_rules as ref_merge_rules
from repro.layers.attention import cache_insert as ref_cache_insert
from repro.layers.attention import (
    decode_attention_shardmap as ref_decode_attention_shardmap)
from repro.layers.attention import gqa_scores as ref_gqa_scores
from repro_torch.common import sharding
from repro_torch.kernels import ref as kref
from repro_torch.layers import attention as attn

TOL = dict(rtol=2e-4, atol=2e-4)
GEOMS = {
    "gqa": dict(B=2, T=16, H=4, K=2, D=16, lengths=[3, 12]),
    "window": dict(B=2, T=16, H=4, K=2, D=16, lengths=[9, 15], window=6),
    "softcap-empty-tiles": dict(B=2, T=16, H=4, K=2, D=16, lengths=[0, 1],
                                softcap=30.0, seed=1),
    "g1-window-softcap": dict(B=2, T=16, H=2, K=2, D=16, lengths=[1, 7],
                              window=4, softcap=20.0, seed=2),
}
MESHES = ((1, 2), (2, 2), (1, 4))
CASES = [dict(mesh=list(m), geom=g, name=n) for m in MESHES
         for n, g in GEOMS.items()]
AXES = ("cache_batch", "cache_seq", None, None)


def _inputs(g):
    return mref.decode_inputs(g["B"], g["T"], g["H"], g["K"], g["D"],
                              g["lengths"], g.get("seed", 0))


@pytest.mark.parametrize("name", list(GEOMS))
def test_shardmap_decode_1x1_matches_reference(world1, name):
    g = GEOMS[name]
    inp = _inputs(g)
    mesh_j, rules = ref_local_mesh((1, 1)), ref_merge_rules(None)
    want = jax.jit(lambda q, k, v, ln: ref_decode_attention_shardmap(
        q, k, v, ln, mesh=mesh_j, rules=rules, window=g.get("window", 0),
        softcap=g.get("softcap", 0.0)))(
            inp["q"], inp["k"], inp["v"], inp["lengths"])
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    got = attn.decode_attention_shardmap(
        t["q"], t["k"], t["v"], t["lengths"], mesh=world1,
        rules=sharding.merge_rules(), window=g.get("window", 0),
        softcap=g.get("softcap", 0.0))
    np.testing.assert_allclose(got.full_tensor().numpy(), np.asarray(want),
                               **TOL)


@pytest.mark.parametrize("name", ["gqa", "window"])
def test_shardmap_decode_is_the_decode_kernels_function(world1, name):
    """Over the keys below lengths + 1, the per-rank partial softmax is
    the decode kernel's plain version."""
    g = GEOMS[name]
    t = {k: torch.from_numpy(v) for k, v in _inputs(g).items()}
    got = attn.decode_attention_shardmap(
        t["q"], t["k"], t["v"], t["lengths"], mesh=world1,
        rules=sharding.merge_rules(), window=g.get("window", 0))
    want = kref.decode_attention_ref(t["q"][:, 0], t["k"], t["v"],
                                     t["lengths"] + 1,
                                     window=g.get("window", 0))
    torch.testing.assert_close(got.full_tensor()[:, 0], want, **TOL)


def _ref_dense_decode(q, k, v, lengths, window=0, softcap=0.0):
    """The reference's dense decode attention (``models/lm.py``): the
    cache widened to q's dtype, keys below lengths + 1 valid."""
    jnp = jax.numpy
    B, T = k.shape[:2]
    kv_pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    return ref_gqa_scores(
        q, k.astype(q.dtype), v.astype(q.dtype), q_positions=lengths[:, None],
        kv_positions=kv_pos, causal=True, window=window, softcap=softcap,
        kv_valid=kv_pos < (lengths + 1)[:, None])


@pytest.mark.parametrize("path", ["dense", "dense-mesh", "shardmap"])
@pytest.mark.parametrize("name", ["gqa", "softcap-empty-tiles"])
def test_bfloat16_cache_decode_matches_reference(world1, path, name):
    """A bfloat16 cache under a float32 q: the port computes from the
    same bfloat16 values widened to float32, as the reference does, so
    it keeps float32's tolerance (q rounded to bfloat16 would not)."""
    g = GEOMS[name]
    inp = _inputs(g)
    jnp = jax.numpy
    kw = dict(window=g.get("window", 0), softcap=g.get("softcap", 0.0))
    q, ln = jnp.asarray(inp["q"]), jnp.asarray(inp["lengths"])
    k, v = (jnp.asarray(inp[n], jnp.bfloat16) for n in ("k", "v"))
    tq, tln = torch.from_numpy(inp["q"]), torch.from_numpy(inp["lengths"])
    tk, tv = (torch.from_numpy(inp[n]).to(torch.bfloat16)
              for n in ("k", "v"))
    rules = sharding.merge_rules()
    if path == "shardmap":
        want = ref_decode_attention_shardmap(
            q, k, v, ln, mesh=ref_local_mesh((1, 1)),
            rules=ref_merge_rules(None), **kw)
        got = attn.decode_attention_shardmap(tq, tk, tv, tln, mesh=world1,
                                             rules=rules, **kw)
    else:
        want = _ref_dense_decode(q, k, v, ln, **kw)
        mesh = world1 if path == "dense-mesh" else None
        got = attn.decode_attend(tq, tk, tv, tln + 1, mesh=mesh,
                                 rules=rules, **kw)
    got = got.full_tensor() if sharding.is_dtensor(got) else got
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("mode", ["scatter", "blend", "shard"])
def test_cache_insert_matches_reference(world1, mode):
    """Every mode on a plain cache (no mesh) and on a DTensor cache: the
    reference's cache, and the write lands in place."""
    inp = _inputs(GEOMS["gqa"])
    want = np.asarray(ref_cache_insert(
        jax.numpy.asarray(inp["k"]), jax.numpy.asarray(inp["new"]),
        jax.numpy.asarray(inp["lengths"]), mode=mode))
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    plain = t["k"].clone()
    out = attn.cache_insert(plain, t["new"], t["lengths"], mode=mode)
    assert out is plain
    np.testing.assert_array_equal(plain.numpy(), want)
    rules = sharding.merge_rules()
    c = sharding.constrain(t["k"].clone(), AXES, rules, world1)
    local = c.to_local()
    attn.cache_insert(c, t["new"], t["lengths"], mode=mode, mesh=world1,
                      rules=rules)
    np.testing.assert_array_equal(local.numpy(), want)


def test_cache_write_prefix_in_place(world1):
    t = {k: torch.from_numpy(v) for k, v in _inputs(GEOMS["gqa"]).items()}
    c = sharding.constrain(torch.zeros_like(t["k"]), AXES,
                           sharding.merge_rules(), world1)
    new = t["k"][:, :5]
    attn.cache_write_prefix(c, new)
    torch.testing.assert_close(c.to_local()[:, :5], new, rtol=0, atol=0)
    assert float(c.to_local()[:, 5:].abs().max()) == 0.0
    with pytest.raises(ValueError, match="mode"):
        attn.cache_insert(c, t["new"], t["lengths"], mode="gather")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    return mw.run_cases("decode", mw.decode_worker, CASES,
                        tmp_path_factory.mktemp("shardmap_decode"))


@pytest.mark.parametrize("i", range(len(CASES)), ids=[
    f"{c['mesh'][0]}x{c['mesh'][1]}-{c['name']}" for c in CASES])
def test_shardmap_decode_multi_rank_matches_reference(outputs, i):
    ref, port = outputs
    np.testing.assert_allclose(port[f"{i}/out"], ref[f"{i}/out"], **TOL)
    for mode in ("scatter", "blend", "shard"):
        np.testing.assert_array_equal(port[f"{i}/insert/{mode}"],
                                      ref[f"{i}/insert/{mode}"])
