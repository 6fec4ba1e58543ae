"""The port's recurrent families (zamba2-7b hybrid, xlstm-1.3b ssm) at
their smoke configs, held to the JAX package on bridged weights:
prefill logits and three dense-cache decode steps at float32 rtol =
atol = 2e-4 (another summation order), greedy ``Deployment.submit()``
tokens equal, ``serve()`` of such a head refused alike (no paged
layout), and the port's serve launcher against the reference's."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import get_config as ref_get_config
from repro.models.api import build_model as ref_build_model
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import get_config
from repro_torch.launch import serve as tserve
from repro_torch.models.api import build_model

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ["zamba2-7b", "xlstm-1.3b"]


@pytest.fixture(scope="module", params=ARCHS)
def models(request):
    cfg = ref_get_config(request.param, smoke=True)
    jb = ref_build_model(cfg, compute_dtype=jnp.float32)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = build_model(get_config(request.param, smoke=True),
                     compute_dtype=torch.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jb, jp, tb, tp


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _leaves(tree):
    """Leaves in ``jax.tree.leaves`` order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def test_specs_param_count_and_bridge_match_reference(models):
    _, jb, jp, tb, tp = models
    assert tb.param_count() == jb.param_count()
    init = tb.init(torch.Generator().manual_seed(0), device="cpu")
    tshapes = [tuple(x.shape) for x in _leaves(init)]
    assert tshapes == [tuple(x.shape) for x in jax.tree.leaves(jp)]
    assert [tuple(x.shape) for x in _leaves(tp)] == tshapes
    assert tb.paged_decode_step is None and tb.paged_cache_specs is None


def test_prefill_then_decode_matches_reference(models):
    """Two rows, 13 prompt tokens (one chunk of 8 and a ragged tail of
    5), then three greedy decode steps from the prefill's caches."""
    cfg, jb, jp, tb, tp = models
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 13)).astype(np.int32)
    T = 24
    jc = jb.init_cache(2, T, jnp.float32)
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks)}, jc)
    tc = tb.init_cache(2, T, device="cpu", dtype=torch.float32)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks)}, tc)
    _close(tl, jl)
    for t, j in zip(_leaves(tc), jax.tree.leaves(jc), strict=True):
        _close(t, j)
    lens = np.array([13, 13], np.int32)
    nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    for _ in range(3):
        jl, jc = jb.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(lens))
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        lens = lens + 1


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


def test_greedy_submit_tokens_equal_reference(models):
    cfg, jb, jp, tb, tp = models
    reqs = tserve.make_requests(cfg, 2, 6, prompt_lens=[11, 4], seed=2)
    run = tserve.serve_arch(get_config(cfg.name, smoke=True), reqs,
                            device="cpu", params=tp)
    dep = _ref_deployment(jb, jp)
    for req, got in zip(reqs, run.results, strict=True):
        want = dep.submit(req).output
        np.testing.assert_array_equal(np.asarray(got.output), np.asarray(want))
    assert run.decode_steps == sum(len(r.output) - 1 for r in run.results)
    assert not any(run.launches.values())       # the CPU runs no kernel


def test_serve_of_a_recurrent_head_is_refused_alike(models):
    """No paged-KV layout for recurrent caches: ``serve()`` raises the
    reference's NotImplementedError in both packages."""
    cfg, jb, jp, tb, tp = models
    req = tserve.make_requests(cfg, 1, 3, seed=3)
    with pytest.raises(NotImplementedError, match="paged-KV") as want:
        _ref_deployment(jb, jp).serve(req)
    dep = tserve.head_only_deployment(tb, tp, torch.device("cpu"))
    with pytest.raises(NotImplementedError, match="paged-KV") as got:
        dep.serve(req)
    assert type(got.value) is type(want.value)


@pytest.mark.parametrize("arch", ARCHS + ["internvl2-1b", "tinyllama-1.1b",
                                          "whisper-tiny"])
def test_serve_launcher_runs_on_the_cpu(arch, capsys):
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                 "--requests", "2", "--max-new", "4"])
    out = capsys.readouterr().out
    assert f"[serve] {arch} params=" in out and "on cpu" in out
    assert "[serve] 2 requests, 8 tokens" in out


@pytest.mark.parametrize("arch", ARCHS + ["internvl2-1b", "tinyllama-1.1b",
                                          "whisper-tiny"])
def test_plan_matches_reference_launcher(arch, capsys):
    from repro.launch.serve import plan_s2m3 as ref_plan

    cfg = get_config(arch)
    ref_plan(ref_get_config(arch), "queue_aware")
    want = capsys.readouterr().out
    report = tserve.plan_s2m3(cfg, "queue_aware")
    assert capsys.readouterr().out == want
    assert report.feasible and "predicted latency" in want


def test_paper_zoo_matches_reference():
    """The port's copy of the zoo tables gives the reference's ModelSpecs."""
    import dataclasses

    from repro.core.zoo import paper_zoo as ref_zoo
    from repro_torch.core.zoo import paper_zoo

    want, got = ref_zoo(), paper_zoo()
    assert list(got) == list(want)
    for name in want:
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(want[name])
