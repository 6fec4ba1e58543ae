"""The port's layers held to ``repro.layers`` on the same numpy inputs:
norms, rope, the gated MLP (silu and the tanh-form gelu), the GQA core,
cache inserts and the paged gather.  Tolerance: float32 2e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import get_config as ref_get_config
from repro.layers import attention as jattn
from repro.layers import embedding as jemb
from repro.layers import mlp as jmlp
from repro.layers import norms as jnorms
from repro.layers import rope as jrope
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import get_config
from repro_torch.layers import attention as tattn
from repro_torch.layers import embedding as temb
from repro_torch.layers import mlp as tmlp
from repro_torch.layers import norms as tnorms
from repro_torch.layers import rope as trope

TOL = dict(rtol=2e-4, atol=2e-4)


def _rand(rng, *shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(0)
    x = _rand(rng, 2, 5, 32)
    p = {"scale": _rand(rng, 32), "bias": _rand(rng, 32)}
    if kind == "rmsnorm":
        del p["bias"]
    _close(tnorms.apply_norm(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                             kind),
           jnorms.apply_norm(p, jnp.asarray(x), kind))


@pytest.mark.parametrize("heads", [True, False])
def test_rope_matches_reference(heads):
    rng = np.random.default_rng(1)
    shape = (2, 7, 3, 16) if heads else (2, 7, 16)
    x = _rand(rng, *shape)
    pos = rng.integers(0, 600, (2, 7)).astype(np.int32)
    _close(trope.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6),
           jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6))


@pytest.mark.parametrize("act", ["silu", "gelu", "gelu_tanh", "relu"])
def test_mlp_matches_reference(act):
    rng = np.random.default_rng(2)
    p = {"wi_gate": _rand(rng, 16, 40, scale=0.3),
         "wi_up": _rand(rng, 16, 40, scale=0.3),
         "wo": _rand(rng, 40, 16, scale=0.3)}
    x = _rand(rng, 2, 3, 16)
    _close(tmlp.mlp_apply(params_from_numpy(p, "cpu"), torch.from_numpy(x),
                          act),
           jmlp.mlp_apply(p, jnp.asarray(x), act))


def test_embedding_and_tied_head_match_reference():
    rng = np.random.default_rng(3)
    table = _rand(rng, 50, 16)
    ids = rng.integers(0, 50, (2, 4)).astype(np.int32)
    te = temb.embed_apply({"table": torch.from_numpy(table)},
                          torch.from_numpy(ids), scale=2.0,
                          dtype=torch.float32)
    je = jemb.embed_apply({"table": jnp.asarray(table)}, jnp.asarray(ids),
                          scale=2.0, dtype=jnp.float32)
    _close(te, je)
    for cap in (0.0, 5.0):
        _close(temb.head_apply(None, te, softcap=cap,
                               tied_table=torch.from_numpy(table)),
               jemb.head_apply(None, je, softcap=cap,
                               tied_table=jnp.asarray(table)))


@pytest.mark.parametrize("causal,window,softcap,valid", [
    (True, 0, 0.0, False), (False, 0, 0.0, True), (True, 4, 0.0, False),
    (True, 0, 20.0, True),
])
def test_gqa_scores_matches_reference(causal, window, softcap, valid):
    rng = np.random.default_rng(4)
    B, S, T, H, K, D = 2, 5, 9, 14, 2, 16
    q, k, v = _rand(rng, B, S, H, D), _rand(rng, B, T, K, D), \
        _rand(rng, B, T, K, D)
    qpos = np.broadcast_to(np.arange(4, 4 + S, dtype=np.int32), (B, S))
    kpos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    kv_valid = (kpos < np.array([[7], [9]])) if valid else None
    tkw = dict(q_positions=torch.from_numpy(qpos.copy()),
               kv_positions=torch.from_numpy(kpos.copy()), causal=causal,
               window=window, softcap=softcap,
               kv_valid=None if kv_valid is None else torch.from_numpy(kv_valid))
    jkw = dict(q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kpos),
               causal=causal, window=window, softcap=softcap,
               kv_valid=None if kv_valid is None else jnp.asarray(kv_valid))
    _close(tattn.gqa_scores(torch.from_numpy(q), torch.from_numpy(k),
                            torch.from_numpy(v), **tkw),
           jattn.gqa_scores(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **jkw))


def test_attention_apply_matches_reference_xla_path():
    """The port's prefill attention (flash kernel's plain version on
    the CPU) equals the reference's XLA ``gqa_scores`` path."""
    cfg = ref_get_config("internvl2-1b", smoke=True)
    tcfg = get_config("internvl2-1b", smoke=True)
    rng = np.random.default_rng(5)
    d, H, K, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    p = {"wq": _rand(rng, d, H, hd, scale=0.2),
         "wk": _rand(rng, d, K, hd, scale=0.2),
         "wv": _rand(rng, d, K, hd, scale=0.2),
         "wo": _rand(rng, H, hd, d, scale=0.2)}
    x = _rand(rng, 1, 11, d)
    pos = np.arange(11, dtype=np.int32)[None]
    ty, (tk, tv) = tattn.attention_apply(
        params_from_numpy(p, "cpu"), torch.from_numpy(x),
        positions=torch.from_numpy(pos), cfg=tcfg)
    jy, (jk, jv) = jattn.attention_apply(
        p, jnp.asarray(x), positions=jnp.asarray(pos), cfg=cfg)
    _close(ty, jy)
    _close(tk, jk)
    _close(tv, jv)


def test_cache_insert_matches_reference():
    rng = np.random.default_rng(6)
    cache = _rand(rng, 3, 8, 2, 4)
    new = _rand(rng, 3, 1, 2, 4)
    lens = np.array([0, 5, 7], np.int32)
    t = tattn.cache_insert(torch.from_numpy(cache.copy()),
                           torch.from_numpy(new), torch.from_numpy(lens))
    _close(t, jattn.cache_insert(jnp.asarray(cache), jnp.asarray(new),
                                 jnp.asarray(lens)))


def test_paged_insert_and_gather_match_reference():
    rng = np.random.default_rng(7)
    P, ps, K, D = 9, 4, 2, 8
    pages = _rand(rng, P, ps, K, D)
    tables = np.array([[3, 5, 1], [7, 2, 8], [0, 0, 0]], np.int32)
    lens = np.array([5, 11, 0], np.int32)       # row 2: a dead row
    new = _rand(rng, 3, 1, K, D)
    t = tattn.paged_cache_insert(torch.from_numpy(pages.copy()),
                                 torch.from_numpy(new),
                                 torch.from_numpy(tables),
                                 torch.from_numpy(lens))
    j = jattn.paged_cache_insert(jnp.asarray(pages), jnp.asarray(new),
                                 jnp.asarray(tables), jnp.asarray(lens))
    _close(t, j)
    _close(tattn.paged_gather(t, torch.from_numpy(tables)),
           jattn.paged_gather(j, jnp.asarray(tables)))


def test_init_tree_matches_reference_shapes():
    from repro.layers.initializers import init_tree as jinit
    from repro_torch.layers.initializers import init_tree

    from repro.layers.attention import attention_specs as jspecs
    from repro_torch.layers.attention import attention_specs

    jp = jinit(jax.random.PRNGKey(0), jspecs(16, 4, 2, 8))
    tp = init_tree(attention_specs(16, 4, 2, 8),
                   torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in tp.items()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    # fan-in scaled normals: same std within sampling noise
    for k in tp:
        assert abs(float(tp[k].std()) - float(jnp.std(jp[k]))) < 0.05


def test_init_tree_scales_in_place_as_x_times_std():
    """``init_leaf`` scales its draw in place; at a fixed seed the tree is
    bit for bit the formula ``randn(shape) * std`` cast to the leaf's
    dtype, drawn in tree order (fan-in, "small", "embed", an explicit
    scale, a bf16 leaf; zeros and ones draw nothing)."""
    from repro_torch.layers.initializers import WSpec, _std, init_tree

    specs = {"a": WSpec((6, 4, 3), ("embed", "heads", None)),
             "b": WSpec((5, 7), (None, None), init="small"),
             "c": WSpec((9, 4), ("vocab", "embed"), init="embed"),
             "d": WSpec((3, 8), (None, None), scale=0.37),
             "e": WSpec((4, 4), (None, None), dtype=torch.bfloat16),
             "f": WSpec((4,), ("norm",), init="ones"),
             "g": WSpec((4,), ("norm",), init="zeros")}
    got = init_tree(specs, torch.Generator().manual_seed(11))
    g = torch.Generator().manual_seed(11)
    for name, ws in specs.items():
        if ws.init in ("zeros", "ones"):
            want = torch.full(ws.shape, float(ws.init == "ones"))
        else:
            want = (torch.randn(ws.shape, generator=g) * _std(ws)).to(
                ws.dtype or torch.float32)
        assert got[name].dtype == want.dtype
        torch.testing.assert_close(got[name], want, rtol=0, atol=0)
