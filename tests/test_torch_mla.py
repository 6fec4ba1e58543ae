"""The port's Multi-head Latent Attention (``layers.mla``) and the
deepseek-v3-671b model (a dense MLA stage, then MLA + MoE with a shared
expert; the MTP weights carried), held to the JAX package on the same
numpy inputs and bridged weights, at smoke size.

Tolerances: float32 rtol = atol = 2e-4 (``TOLS`` of
``tests/test_kernels.py``: another summation order); greedy tokens
exact; a decode step against a fresh prefill of the same tokens at 5e-4
(``tests/test_models_smoke.py`` holds the reference to the same).  MLA
runs no kernel in the reference; the port's paged decode runs
``paged_mla_decode``, whose plain version runs here, so nothing here
needs the card."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import get_config as ref_get_config
from repro.layers import mla as jmla
from repro.models.api import build_model as ref_build_model
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import get_config
from repro_torch.common.pytree import tree_leaves
from repro_torch.kernels import ops
from repro_torch.launch import serve as tserve
from repro_torch.layers import mla as tmla
from repro_torch.models.api import build_model

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)
ARCH = "deepseek-v3-671b"


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), **tol)


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def model():
    cfg = ref_get_config(ARCH, smoke=True)
    jb = ref_build_model(cfg, compute_dtype=jnp.float32)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = build_model(get_config(ARCH, smoke=True), compute_dtype=torch.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jb, jp, tb, tp


@pytest.fixture(scope="module")
def layer():
    """One smoke MLA layer's weights (the reference's init, bridged) and
    inputs: x (2, 7, d) at positions 0..6; the port's config, which both
    sides read (its fields are the reference's, and the port's own at
    the defaults that keep its behaviour)."""
    cfg = get_config(ARCH, smoke=True)
    from repro.layers.initializers import init_tree

    jp = init_tree(jax.random.PRNGKey(3), jmla.mla_specs(cfg))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32), (2, 7)).copy()
    return cfg, jp, tp, x, pos


#: the port's own config fields (DeepSeek-V3's published router, held
#: experts, YaRN; the image prefix's map) at the defaults that keep the
#: reference's behaviour
PORT_DEFAULTS = dict(moe_router="softmax", n_group=0, topk_group=0,
                     routed_scaling_factor=1.0, experts_held=0,
                     experts_offset=0, rope_yarn=None, image_proj=True)


def test_configs_match_reference():
    """Field for field the reference's, and the port's own fields at the
    defaults that keep its behaviour."""
    for arch in (ARCH, "llama3-405b"):
        for smoke in (False, True):
            got = dataclasses.asdict(get_config(arch, smoke=smoke))
            want = dataclasses.asdict(ref_get_config(arch, smoke=smoke))
            assert {k: got[k] for k in want} == want
            assert {k: v for k, v in got.items() if k not in want} == \
                PORT_DEFAULTS


def test_mla_project_kv_matches_reference(layer):
    cfg, jp, tp, x, pos = layer
    jc, jk = jmla.mla_project_kv(jp, jnp.asarray(x), jnp.asarray(pos), cfg)
    tc, tk = tmla.mla_project_kv(tp, torch.from_numpy(x),
                                 torch.from_numpy(pos), cfg)
    assert tc.shape == (2, 7, cfg.kv_lora_rank)
    assert tk.shape == (2, 7, cfg.qk_rope_dim)
    _close(tc, jc)
    _close(tk, jk)


def test_mla_apply_matches_reference(layer):
    cfg, jp, tp, x, pos = layer
    jy, (jc, jk) = jmla.mla_apply(jp, jnp.asarray(x), positions=jnp.asarray(pos),
                                  cfg=cfg)
    ty, (tc, tk) = tmla.mla_apply(tp, torch.from_numpy(x),
                                  positions=torch.from_numpy(pos), cfg=cfg)
    assert ty.shape == x.shape
    _close(ty, jy)
    _close(tc, jc)
    _close(tk, jk)


def test_mla_attend_decode_over_partly_valid_cache(layer):
    """One query per row at position 11 against a 12-slot latent cache
    of which rows hold 9 and 4 live slots: ``kv_valid`` masks the rest,
    which the causal mask alone would let in."""
    cfg, jp, tp, x, _ = layer
    rng = np.random.default_rng(6)
    T = 12
    ckv = rng.standard_normal((2, T, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((2, T, cfg.qk_rope_dim)).astype(np.float32)
    q_pos = np.array([[11], [11]], np.int32)
    kv_pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T)).copy()
    valid = kv_pos < np.array([[9], [4]], np.int32)
    xq = x[:, :1]
    want = jmla.mla_attend(
        jp, jnp.asarray(xq), positions=jnp.asarray(q_pos), cfg=cfg,
        ckv_all=jnp.asarray(ckv), kr_all=jnp.asarray(kr),
        kv_positions=jnp.asarray(kv_pos), kv_valid=jnp.asarray(valid))
    got = tmla.mla_attend(
        tp, torch.from_numpy(xq), positions=torch.from_numpy(q_pos), cfg=cfg,
        ckv_all=torch.from_numpy(ckv), kr_all=torch.from_numpy(kr),
        kv_positions=torch.from_numpy(kv_pos),
        kv_valid=torch.from_numpy(valid))
    assert got.shape == (2, 1, cfg.d_model)
    _close(got, want)
    # the masked slots do not enter: overwrite them and nothing moves
    ckv2 = np.where(valid[..., None], ckv, 1e3).astype(np.float32)
    again = tmla.mla_attend(
        tp, torch.from_numpy(xq), positions=torch.from_numpy(q_pos), cfg=cfg,
        ckv_all=torch.from_numpy(ckv2), kr_all=torch.from_numpy(kr),
        kv_positions=torch.from_numpy(kv_pos),
        kv_valid=torch.from_numpy(valid))
    torch.testing.assert_close(again, got, rtol=0, atol=0)


def test_specs_and_param_tree_match_reference(model):
    """The parameter tree matches the reference's leaf for leaf, the MTP
    subtree included; the stages are the dense MLA stage then the moe
    stage; the latent cache pages (the reference's does not): each
    stage's ckv and kr pools are (layers, n_pages, page_size, width), and
    the page budget counts kv_lora_rank + qk_rope_dim floats a token and
    layer."""
    cfg, jb, jp, tb, tp = model
    assert tb.param_count() == jb.param_count()
    init = tb.init(torch.Generator().manual_seed(0), device="cpu")
    assert [tuple(x.shape) for x in _leaves(init)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jp)]
    assert list(tp["stages"]) == ["dense", "moe"]
    assert set(tp["mtp"]) == {"proj", "norm_h", "norm_e", "block",
                              "final_norm"}
    assert tb.supports_paged_decode and not jb.supports_paged_decode
    pool = tb.paged_cache_specs(9, 8, torch.float32)
    n_dense = cfg.first_dense_layers
    for stage, n in (("dense", n_dense), ("moe", cfg.n_layers - n_dense)):
        assert {k: ws.shape for k, ws in pool[stage].items()} == {
            "ckv": (n, 9, 8, cfg.kv_lora_rank),
            "kr": (n, 9, 8, cfg.qk_rope_dim)}
    cache = tb.cache_specs(1, 1, dtype=torch.float32)
    floats = sum(int(np.prod(ws.shape)) for ws in tree_leaves(cache))
    assert floats == cfg.n_layers * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    assert tb.kv_bytes_per_token() == 4 * floats


@pytest.mark.parametrize("arch,n_params,n_active", [
    (ARCH, 671_712_669_696, 38_238_547_968),
    ("llama3-405b", 405_853_388_800, 405_853_388_800)])
def test_full_param_counts_match_reference(arch, n_params, n_active):
    """Specs only: the published configs' counts, no init."""
    jb = ref_build_model(ref_get_config(arch))
    tb = build_model(get_config(arch), compute_dtype=torch.float32)
    assert tb.param_count() == jb.param_count() == n_params
    assert tb.active_param_count() == jb.active_param_count() == n_active


def test_prefill_then_decode_matches_reference(model):
    """Two rows of 10 prompt tokens, then four decode steps from ragged
    lengths: logits and the latent caches."""
    cfg, jb, jp, tb, tp = model
    toks = _tokens(cfg, 2, 10, seed=1)
    T = 16
    jc = jb.init_cache(2, T, jnp.float32)
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tc = tb.init_cache(2, T, device="cpu", dtype=torch.float32)
    ops.reset_launches()
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl)
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc), strict=True):
        _close(t, j)
    lens = np.array([10, 7], np.int32)
    nxt = np.array([[7], [11]], np.int32)
    for _ in range(4):
        jl, jc = jb.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(lens))
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        lens = lens + 1
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc), strict=True):
        _close(t, j)
    assert not any(ops.LAUNCHES.values())


def test_decode_equals_fresh_prefill(model):
    """The port's decode step after a prefill of 12 tokens == a fresh
    prefill of the 13."""
    cfg, _, _, tb, tp = model
    toks = _tokens(cfg, 2, 13, seed=3)
    T = 16
    _, cache = tb.prefill(tp, {"tokens": torch.from_numpy(toks[:, :12])},
                          tb.init_cache(2, T, device="cpu",
                                        dtype=torch.float32))
    got, _ = tb.decode_step(tp, torch.from_numpy(toks[:, 12:]), cache,
                            torch.full((2,), 12, dtype=torch.int32))
    want, _ = tb.prefill(tp, {"tokens": torch.from_numpy(toks)},
                         tb.init_cache(2, T, device="cpu",
                                       dtype=torch.float32))
    _close(got, want.numpy(), DECODE_TOL)


def test_serve_launchers_give_the_reference_tokens(model):
    """Three greedy requests through the port's ``serve_arch``, which
    serves MLA through the paged scheduler (the latent pools, the
    absorbed decode's plain version on the CPU), and through the
    reference launcher's path for such a model (``lm_scheduler`` →
    ``engine.generate``, solo: the reference does not page MLA): the
    same tokens."""
    from repro.serving.scheduler import lm_scheduler as ref_lm_scheduler

    cfg, jb, jp, tb, tp = model
    reqs = tserve.make_requests(cfg, 3, 6, prompt_lens=[9, 4, 7], seed=4)
    run = tserve.serve_arch(get_config(ARCH, smoke=True), reqs, device="cpu",
                            params=tp)
    assert run.scheduler is not None
    stats = run.scheduler.stats_dict()[cfg.name]
    assert run.decode_steps == stats["decode_steps"] == 5
    assert stats["decode_tokens"] == sum(len(r.output) - 1
                                         for r in run.results)
    assert not any(run.launches.values())
    ref_engine = ref_lm_scheduler(jb, jp).engine
    for req, got in zip(reqs, run.results, strict=True):
        want = np.asarray(ref_engine.generate(req).output)
        assert len(want) == 6
        np.testing.assert_array_equal(np.asarray(got.output), want)


def test_serve_launcher_runs_on_the_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                 "--requests", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {ARCH} params=" in out and "on cpu" in out
    assert "[serve] 2 requests, 8 tokens" in out


@pytest.mark.parametrize("arch", [ARCH, "llama3-405b"])
def test_plan_and_model_spec_match_reference(arch, capsys):
    from repro.core.zoo import arch_model_spec as ref_spec
    from repro.launch.serve import plan_s2m3 as ref_plan
    from repro_torch.core.zoo import arch_model_spec

    assert dataclasses.asdict(arch_model_spec(get_config(arch))) == \
        dataclasses.asdict(ref_spec(ref_get_config(arch)))
    ref_plan(ref_get_config(arch), "queue_aware")
    want = capsys.readouterr().out
    report = tserve.plan_s2m3(get_config(arch), "queue_aware")
    assert capsys.readouterr().out == want
    # 2.7 TB / 1.6 TB of f32 weights fit no device of the paper's testbed
    assert not report.feasible
