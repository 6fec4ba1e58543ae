"""The port's gemma2-9b (dense ``pairs`` stage: windowed local layers,
both softcaps, post-norms), llama3-8b and llama3-405b (dense) and
granite-moe-3b-a800m (the non-MLA ``moe`` stage) at their smoke
configs, held to the JAX package on bridged weights.

Tolerances: float32 rtol = atol = 2e-4 for prefill and decode logits
(another summation order, the tolerance of ``tests/test_kernels.py``);
greedy tokens exact; the port's paged ``serve()`` against its solo
``submit()`` on every step's logits at 2e-4; a decode step against a
fresh prefill of the same tokens at 5e-4 (``tests/test_models_smoke.py``
holds the reference to the same).  gemma2's smoke window is 8 keys and
every prompt here is longer, so the window bites in prefill, dense and
paged decode.  The reference pages only dense/vlm caches; the port's
moe stage pages too, and granite's paged logits are held to the
reference's dense decode."""

import contextlib
import dataclasses

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
from repro_torch.launch import serve as tserve
from repro_torch.models.api import build_model
from repro_torch.serving.kvcache import insert_pages

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=5e-4, atol=5e-4)
ARCHS = ["gemma2-9b", "llama3-8b", "llama3-405b", "granite-moe-3b-a800m"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg = ref_get_config(request.param, smoke=True)
    jb = ref_build_model(cfg, compute_dtype=jnp.float32)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = build_model(get_config(request.param, smoke=True),
                     compute_dtype=torch.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jb, jp, tb, tp


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **tol)


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


def test_configs_match_reference():
    """Field for field the reference's, and the port's own fields
    (DeepSeek-V3's serving path, the image prefix's map) at the defaults
    that keep its behaviour."""
    from test_torch_mla import PORT_DEFAULTS

    for arch in ARCHS:
        for smoke in (False, True):
            got = dataclasses.asdict(get_config(arch, smoke=smoke))
            want = dataclasses.asdict(ref_get_config(arch, smoke=smoke))
            assert {k: got[k] for k in want} == want
            assert {k: v for k, v in got.items() if k not in want} == \
                PORT_DEFAULTS


def test_specs_param_count_and_stages_match_reference(models):
    cfg, jb, jp, tb, tp = models
    assert tb.param_count() == jb.param_count()
    init = tb.init(torch.Generator().manual_seed(0), device="cpu")
    shapes = [tuple(x.shape) for x in _leaves(init)]
    assert shapes == [tuple(x.shape) for x in jax.tree.leaves(jp)]
    want = {"gemma2-9b": "pairs", "llama3-8b": "blocks",
            "llama3-405b": "blocks", "granite-moe-3b-a800m": "moe"}[cfg.name]
    assert list(tp["stages"]) == [want]
    assert tb.paged_decode_step is not None


@pytest.mark.parametrize("arch,n_params", [
    ("gemma2-9b", 9_241_705_984), ("llama3-8b", 8_030_261_248),
    ("llama3-405b", 405_853_388_800),
    ("granite-moe-3b-a800m", 3_902_773_248)])
def test_full_param_count_matches_reference(arch, n_params):
    """Specs only: the published configs' counts, no init."""
    want = ref_build_model(ref_get_config(arch)).param_count()
    assert build_model(get_config(arch)).param_count() == want == n_params


def test_prefill_then_decode_matches_reference(models):
    """Two rows of 12 prompt tokens (past gemma2's window of 8), then four
    dense-cache decode steps from ragged lengths."""
    cfg, jb, jp, tb, tp = models
    toks = _tokens(cfg, 2, 12, seed=1)
    T = 24
    jc = jb.init_cache(2, T, jnp.float32)
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tc = tb.init_cache(2, T, device="cpu", dtype=torch.float32)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl)
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc), strict=True):
        _close(t, j)
    lens = np.array([12, 9], np.int32)
    nxt = np.array([[7], [11]], np.int32)
    for _ in range(4):
        jl, jc = jb.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(lens))
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        lens = lens + 1


def test_paged_decode_matches_reference(models):
    """A 10-token prompt in shuffled pool pages of 4, a dead row, tables
    with garbage tails, five paged steps (to position 14: two pages past
    gemma2's window).  The reference's paged step where it has one, its
    dense decode for granite (the reference pages no moe cache)."""
    cfg, jb, jp, tb, tp = models
    toks = _tokens(cfg, 1, 10, seed=2)
    ps, n_pages, pages = 4, 9, [6, 2, 8, 5]
    L, span = toks.shape[1], len(pages) * ps
    jd = jb.init_cache(1, span, jnp.float32)
    _, jd = jb.prefill(jp, {"tokens": jnp.asarray(toks)}, jd)
    td = tb.init_cache(1, span, device="cpu", dtype=torch.float32)
    _, td = tb.prefill(tp, {"tokens": torch.from_numpy(toks)}, td)
    tpool = insert_pages(tb.init_paged_cache(n_pages, ps, device="cpu",
                                             dtype=torch.float32), td,
                         pages, L)
    paged_ref = jb.paged_decode_step is not None
    if paged_ref:
        jpool = ref_insert_pages(jb.init_paged_cache(n_pages, ps, jnp.float32),
                                 jd, pages, L)
        for t, j in zip(_leaves(tpool), jax.tree.leaves(jpool), strict=True):
            _close(t, j)
    else:
        assert cfg.family == "moe"
    tables = np.array([pages + [7, -3], [0] * 6], np.int32)
    lens = np.array([L, 0], np.int32)
    tok = np.array([[3], [0]], np.int32)
    for _ in range(5):
        tl, tpool = tb.paged_decode_step(tp, torch.from_numpy(tok), tpool,
                                         torch.from_numpy(tables),
                                         torch.from_numpy(lens))
        if paged_ref:
            jl, jpool = jb.paged_decode_step(
                jp, jnp.asarray(tok), jpool, jnp.asarray(tables),
                jnp.asarray(lens))
        else:
            jl, jd = jb.decode_step(jp, jnp.asarray(tok[:1]), jd,
                                    jnp.asarray(lens[:1]))
        _close(tl[:1], jl[:1])
        tok = np.array([[int(jnp.argmax(jl[0]))], [0]], np.int32)
        lens[0] += 1


def test_decode_equals_fresh_prefill(models):
    """The port's decode step after a prefill of 12 tokens == a fresh
    prefill of the 13 (as the reference's own smoke test holds it)."""
    cfg, _, _, tb, tp = models
    toks = _tokens(cfg, 2, 13, seed=3)
    T = 32
    _, cache = tb.prefill(tp, {"tokens": torch.from_numpy(toks[:, :12])},
                          tb.init_cache(2, T, device="cpu",
                                        dtype=torch.float32))
    got, _ = tb.decode_step(tp, torch.from_numpy(toks[:, 12:]), cache,
                            torch.full((2,), 12, dtype=torch.int32))
    want, _ = tb.prefill(tp, {"tokens": torch.from_numpy(toks)},
                         tb.init_cache(2, T, device="cpu",
                                       dtype=torch.float32))
    _close(got, want.numpy(), DECODE_TOL)


def _ref_deployment(jb, jp):
    """The reference's head-only generative deployment of the bundle."""
    from repro.core.cluster import ClusterSpec, DeviceSpec
    from repro.core.module import ModelSpec, ModuleSpec
    from repro.s2m3 import Deployment

    name = jb.cfg.name
    head = ModuleSpec(name, "head", "task", jb.param_count(),
                      bytes_per_param=4.0, generative=True)
    return (Deployment(ClusterSpec(devices=[DeviceSpec("dev0", 1 << 34, 1e12)]))
            .add_model(ModelSpec("lm", "generation", (), head),
                       {name: lambda: (jb, jp)})
            .plan("greedy").materialize())


@contextlib.contextmanager
def _record_logits(store):
    """Every logits row a token is chosen from, by rid, on the decode
    stream (serve: a tick's greedy rows through ``pick_tokens``) and the
    solo path (submit)."""
    from repro_torch.serving import decode, sampler

    select = sampler.select_token
    pick = decode.pick_tokens

    def recording(logits, generator=None, **kw):
        store.setdefault(generator.initial_seed(), []).append(
            logits.detach().clone())
        return select(logits, generator, **kw)

    def picking(logits, live):
        for row, seq in live:
            if seq.request.temperature <= 0.0:
                store.setdefault(seq.rng.initial_seed(), []).append(
                    logits[row].detach().clone())
        return pick(logits, live)

    decode.select_token = sampler.select_token = recording
    decode.pick_tokens = picking
    try:
        yield
    finally:
        decode.select_token = sampler.select_token = select
        decode.pick_tokens = pick


def test_serve_equals_submit_and_reference_tokens(models):
    """Three greedy requests (prompts of 11, 4 and 9 tokens, 6 new) through
    the port's paged scheduler (``serve_arch``), then each through its
    solo ``submit()``: tokens equal each other and the reference's
    ``submit()``, every step's logits serve == submit at 2e-4."""
    cfg, jb, jp, tb, tp = models
    reqs = tserve.make_requests(cfg, 3, 6, prompt_lens=[11, 4, 9], seed=4)
    served, solo = {}, {}
    with _record_logits(served):
        run = tserve.serve_arch(get_config(cfg.name, smoke=True), reqs,
                                device="cpu", params=tp, max_batch=2,
                                cache_len=32)
    assert run.scheduler is not None          # the paged path
    engine = run.engine
    with _record_logits(solo):
        solo_out = {r.rid: engine.generate(r).output for r in reqs}
    dep = _ref_deployment(jb, jp)
    for req, got in zip(reqs, run.results, strict=True):
        want = np.asarray(dep.submit(req).output)
        np.testing.assert_array_equal(np.asarray(got.output), want)
        np.testing.assert_array_equal(np.asarray(solo_out[req.rid]), want)
        a, b = torch.stack(served[req.rid]), torch.stack(solo[req.rid])
        assert a.shape == b.shape == (len(want), cfg.vocab_size)
        _close(a, b.numpy())
    assert run.scheduler.check_invariants() == []


def test_serve_launcher_runs_on_the_cpu(models, capsys):
    cfg = models[0]
    tserve.main(["--arch", cfg.name, "--smoke", "--device", "cpu",
                 "--requests", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {cfg.name} params=" in out and "on cpu" in out
    assert "[serve] 2 requests, 8 tokens" in out


def test_plan_and_model_spec_match_reference(models, capsys):
    from repro.core.zoo import arch_model_spec as ref_spec
    from repro.launch.serve import plan_s2m3 as ref_plan
    from repro_torch.core.zoo import arch_model_spec

    name = models[0].name
    assert dataclasses.asdict(arch_model_spec(get_config(name))) == \
        dataclasses.asdict(ref_spec(ref_get_config(name)))
    ref_plan(ref_get_config(name), "queue_aware")
    want = capsys.readouterr().out
    report = tserve.plan_s2m3(get_config(name), "queue_aware")
    assert capsys.readouterr().out == want
    # gemma2-9b's 37 GB, llama3-8b's 32 GB and llama3-405b's 1.6 TB of
    # f32 weights fit no device of the paper's edge testbed: both plans
    # say so alike (their printouts are equal)
    assert report.feasible == (name == "granite-moe-3b-a800m")


def test_kv_bytes_per_token(models):
    """What the page-budget pre-flight charges a token: every layer's k
    and v (gemma2: two caches a pair)."""
    cfg, _, _, tb, _ = models
    want = 2 * cfg.n_layers * cfg.n_kv_heads * cfg.head_dim * 4
    assert tb.kv_bytes_per_token() == want
    full = build_model(get_config(cfg.name), compute_dtype=torch.float32)
    c = full.cfg
    assert full.kv_bytes_per_token() == \
        2 * c.n_layers * c.n_kv_heads * c.head_dim * 4
    dep = tserve.head_only_deployment(tb, models[4], torch.device("cpu"))
    head = dep.registry.models["lm"].head
    assert head.kv_bytes_per_token == want
