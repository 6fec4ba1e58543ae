"""The port's dense-family models held to the JAX package's on bridged
weights, each at smoke size: internvl2-1b (vlm, G = 2, with its image
prefix) and tinyllama-1.1b (dense, G = 2).  Prefill, dense-cache decode
and paged decode give the same logits at float32 2e-4, and the bridge
round-trips parameter trees."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import get_config as ref_get_config
from repro.models.api import build_model as ref_build_model
from repro.serving.kvcache import insert_pages as ref_insert_pages
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import get_config
from repro_torch.common.pytree import tree_leaves
from repro_torch.models.api import build_model
from repro_torch.serving.kvcache import insert_pages

TOL = dict(rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module", params=["internvl2-1b", "tinyllama-1.1b"])
def models(request):
    cfg = ref_get_config(request.param, smoke=True)
    jb = ref_build_model(cfg, compute_dtype=jnp.float32)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = build_model(get_config(request.param, smoke=True),
                     compute_dtype=torch.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jb, jp, tb, tp


def _inputs(cfg, B=2, S=5, seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((B, cfg.n_image_tokens, cfg.d_model)
                              ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return img, toks


def _batches(cfg, img, toks):
    """The prefill batch in each package (the image prefix only for a
    VLM), and the prefix length."""
    j = {"tokens": jnp.asarray(toks)}
    t = {"tokens": torch.from_numpy(toks)}
    if cfg.has_vision_stub:
        j["image_embeds"] = jnp.asarray(img)
        t["image_embeds"] = torch.from_numpy(img)
    return j, t, (cfg.n_image_tokens if cfg.has_vision_stub else 0)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_specs_and_param_count_match_reference(models):
    _, jb, jp, tb, tp = models
    assert tb.param_count() == jb.param_count()
    tshapes = [tuple(x.shape) for x in tree_leaves(tb.init(
        torch.Generator().manual_seed(0), device="cpu"))]
    assert sorted(tshapes) == sorted(tuple(x.shape)
                                     for x in jax.tree.leaves(jp))


def test_prefill_then_decode_matches_reference(models):
    cfg, jb, jp, tb, tp = models
    img, toks = _inputs(cfg)
    jbatch, tbatch, n_prefix = _batches(cfg, img, toks)
    T = 24
    jc = jb.init_cache(2, T, jnp.float32)
    jl, jc = jb.prefill(jp, jbatch, jc)
    tc = tb.init_cache(2, T, device="cpu", dtype=torch.float32)
    tl, tc = tb.prefill(tp, tbatch, tc)
    _close(tl, jl)
    _close(tc["blocks"]["k"], jc["blocks"]["k"])
    L = n_prefix + toks.shape[1]
    lens = np.array([L, L - 2], np.int32)      # ragged rows
    nxt = np.array([[7], [11]], np.int32)
    for _ in range(3):
        jl, jc = jb.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(lens))
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        lens = lens + 1


def test_paged_decode_matches_reference(models):
    cfg, jb, jp, tb, tp = models
    img, toks = _inputs(cfg, B=1, S=4, seed=1)
    jbatch, tbatch, n_prefix = _batches(cfg, img, toks)
    ps, n_pages = 8, 9
    L = n_prefix + toks.shape[1]
    pages = [5, 2]                                # shuffled pool pages
    span = len(pages) * ps
    jd = jb.init_cache(1, span, jnp.float32)
    _, jd = jb.prefill(jp, jbatch, jd)
    jpool = ref_insert_pages(jb.init_paged_cache(n_pages, ps, jnp.float32),
                             jd, pages, L)
    td = tb.init_cache(1, span, device="cpu", dtype=torch.float32)
    _, td = tb.prefill(tp, tbatch, td)
    tpool = insert_pages(tb.init_paged_cache(n_pages, ps, torch.float32,
                                             "cpu"), td, pages, L)
    _close(tpool["blocks"]["v"], jpool["blocks"]["v"])
    # row 0 live, row 1 dead (dummy page 0); tables with garbage tails
    tables = np.array([[5, 2, 7, -4], [0, 0, 0, 0]], np.int32)
    lens = np.array([L, 0], np.int32)
    tok = np.array([[3], [0]], np.int32)
    for _ in range(4):
        jl, jpool = jb.paged_decode_step(jp, jnp.asarray(tok), jpool,
                                         jnp.asarray(tables), jnp.asarray(lens))
        tl, tpool = tb.paged_decode_step(tp, torch.from_numpy(tok), tpool,
                                         torch.from_numpy(tables),
                                         torch.from_numpy(lens))
        _close(tl[:1], jl[:1])
        tok = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        lens[0] += 1


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_bridge_round_trip(models, dtype):
    _, _, jp, _, _ = models
    tree = jax.tree.map(lambda x: np.asarray(x.astype(dtype)), jp)
    back = params_from_numpy(tree, "cpu")
    flat_j = jax.tree.leaves(tree)
    flat_t = tree_leaves(back)
    assert len(flat_j) == len(flat_t)
    for j, t in zip(flat_j, flat_t):
        assert t.dtype == (torch.float32 if dtype == jnp.float32
                           else torch.bfloat16)
        np.testing.assert_array_equal(t.float().numpy(),
                                      j.astype(np.float32))
    assert back["stages"]["blocks"]["blocks"]["attn"]["wq"].shape == \
        jp["stages"]["blocks"]["blocks"]["attn"]["wq"].shape
