"""The port's serving path held to the JAX package: the two-task VLM
scenario ("caption" + "ocr" share the encoder ``pix-enc`` and the
generative head ``vlm-head``, internvl2-1b smoke) built in both
packages from the same weights gives the same greedy tokens from
``serve()``, the same routes and the same ``stats_dict()`` schema."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import get_config as ref_get_config
from repro.core.cluster import ClusterSpec as RefClusterSpec
from repro.core.cluster import DeviceSpec as RefDeviceSpec
from repro.core.module import ModelSpec as RefModelSpec
from repro.core.module import ModuleSpec as RefModuleSpec
from repro.models.api import build_model as ref_build_model
from repro.s2m3 import Deployment as RefDeployment
from repro.s2m3 import Request as RefRequest
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import get_config
from repro_torch.core.cluster import ClusterSpec, DeviceSpec
from repro_torch.core.module import ModelSpec, ModuleSpec
from repro_torch.models.api import build_model
from repro_torch.s2m3 import Deployment, Request

GB = 1024**3
SERVE_KW = dict(decode_rows=2, page_size=8, max_seq_len=64, decode_pages=33)


def _specs(pkg_module, pkg_model, d):
    enc = pkg_module("pix-enc", "encoder", "vision", 4 * d * d,
                     flops_per_query=2e5)
    head = pkg_module("vlm-head", "head", "task", 100_000, generative=True,
                      flops_per_query=4e5, kv_bytes_per_token=1024)
    return (pkg_model("caption", "captioning", (enc,), head),
            pkg_model("ocr", "ocr", (enc,), head))


@pytest.fixture(scope="module")
def both():
    """The reference's ``vlm_deployment`` fixture, and its port built
    from the same (bridged) weights."""
    cfg = ref_get_config("internvl2-1b", smoke=True)
    bundle = ref_build_model(cfg, compute_dtype=jnp.float32)
    params = bundle.init(jax.random.PRNGKey(0))
    d = cfg.d_model
    w = 0.1 * jax.random.normal(jax.random.PRNGKey(1), (d, d))
    caption, ocr = _specs(RefModuleSpec, RefModelSpec, d)
    ref = (RefDeployment(RefClusterSpec(
        devices=[RefDeviceSpec(f"dev{i}", GB, 1e9) for i in range(2)]))
        .add_model(caption, {
            "pix-enc": lambda: (lambda p, x: jnp.tanh(x @ p), w),
            "vlm-head": lambda: (bundle, params)})
        .add_model(ocr).plan("greedy").materialize())

    tcfg = get_config("internvl2-1b", smoke=True)
    tbundle = build_model(tcfg, compute_dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    tw = params_from_numpy(np.asarray(w), "cpu")
    caption, ocr = _specs(ModuleSpec, ModelSpec, d)
    port = (Deployment(ClusterSpec(
        devices=[DeviceSpec(f"dev{i}", GB, 1e9) for i in range(2)]))
        .add_model(caption, {
            "pix-enc": lambda: (lambda p, x: torch.tanh(x @ p), tw),
            "vlm-head": lambda: (tbundle, tparams)})
        .add_model(ocr).plan("greedy").materialize(device="cpu"))
    return ref, port, cfg


def _workload(req_cls, cfg, n=4):
    img = 0.1 * np.random.default_rng(0).standard_normal(
        (cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    return [req_cls(rid=i, model=("caption" if i % 2 == 0 else "ocr"),
                    source="dev0", prompt=(1, 2, 3 + i),
                    max_new_tokens=3 + i, inputs={"vision": img},
                    slo_deadline=30.0)
            for i in range(n)]


@pytest.fixture(scope="module")
def served(both):
    ref, port, cfg = both
    ref_out = ref.serve(_workload(RefRequest, cfg), **SERVE_KW)
    port_out = port.serve(_workload(Request, cfg), **SERVE_KW)
    return ref_out, port_out


def test_serve_tokens_equal_reference(served):
    ref_out, port_out = served
    assert len(ref_out) == len(port_out) == 4
    for r, p in zip(ref_out, port_out):
        assert p.rid == r.rid and p.model == r.model
        np.testing.assert_array_equal(p.output, np.asarray(r.output))


def test_a_generative_request_holds_its_own_encoder_output(both, served):
    """A generative request keeps its encoder output until it finishes:
    cut from a batched encoder call as a view, it would keep the whole
    batch's output alive with it.  The encoder batched these requests,
    and each output owns just its own bytes."""
    _, port, _ = both
    _, port_out = served
    batches = [s.attrs["batch"] for s in port.scheduler.tracer.trace.spans
               if s.phase == "encode"]
    assert max(batches) > 1
    for r in port_out:
        out = r.encoder_outputs["vision"]
        assert out.untyped_storage().nbytes() == \
            out.numel() * out.element_size()


def test_routes_and_stats_schema_match_reference(both, served):
    ref, port, cfg = both
    _, port_out = served
    sim_ref = ref.simulate(_workload(RefRequest, cfg))
    sim_port = port.simulate(_workload(Request, cfg))
    assert sim_port.routes == sim_ref.routes
    for p in port_out:
        assert p.devices == sim_port.routes[p.rid]
    ref_stats, port_stats = ref.scheduler.stats_dict(), \
        port.scheduler.stats_dict()
    assert port_stats.keys() == ref_stats.keys()
    for m in ref_stats:
        assert port_stats[m].keys() == ref_stats[m].keys()
    assert port.scheduler.cross_task_decode_batches == \
        ref.scheduler.cross_task_decode_batches
    assert port.scheduler.cross_task_batches == ref.scheduler.cross_task_batches


def test_port_serve_equals_submit_and_drains_clean(both, served):
    _, port, cfg = both
    _, port_out = served
    for req, res in zip(_workload(Request, cfg), port_out):
        solo = port.submit(req)
        np.testing.assert_array_equal(solo.output, res.output)
        assert solo.devices == res.devices
    assert port.scheduler.check_invariants() == []
    stream = port.scheduler.decode["vlm-head"]
    assert stream.pool.n_live_pages == 1            # only the dummy page
    assert port.trace().validate() == []


def test_sampled_decode_is_deterministic_within_port(both):
    _, port, cfg = both
    reqs = [Request(rid=7, model="caption", source="dev0", prompt=(4, 5),
                    max_new_tokens=6, temperature=0.8,
                    inputs={"vision": _workload(Request, cfg)[0]
                            .inputs["vision"]})]
    a = port.serve(reqs, **SERVE_KW)[0].output
    b = port.submit(reqs[0]).output
    np.testing.assert_array_equal(a, b)


def test_classify_head_batches_across_tasks_with_generative_ones(both):
    """A non-generative head on the shared encoder rides the same
    scheduler: the encoder batch spans the generative and the
    classification task, and the head's output matches submit()."""
    _, port, cfg = both
    d = cfg.d_model
    gen = torch.Generator().manual_seed(3)
    wc = torch.randn(d, 10, generator=gen) * 0.1
    enc = port.registry.modules["pix-enc"]
    head = ModuleSpec("cls-head", "head", "task", d * 10,
                      flops_per_query=1e4)
    port.add_model(ModelSpec("classify", "classification", (enc,), head),
                   {"cls-head": lambda: (
                       lambda p, e: e["vision"].mean(-2) @ p, wc)})
    try:
        wl = _workload(Request, cfg, n=2) + [
            Request(rid=10, model="classify", source="dev0",
                    inputs={"vision": _workload(Request, cfg)[0]
                            .inputs["vision"]})]
        out = port.serve(wl, **SERVE_KW)
        assert port.scheduler.stats_dict()["pix-enc"][
            "cross_task_batches"] >= 1
        solo = port.submit(wl[-1])
        torch.testing.assert_close(out[-1].output, solo.output,
                                   rtol=2e-4, atol=2e-4)
    finally:
        port.evict("classify")


def test_serving_package_is_lint_clean():
    from pathlib import Path

    import repro_torch.serving
    from repro_torch.analysis.concurrency_lint import lint_paths
    from repro_torch.analysis.diagnostics import errors

    diags = lint_paths([Path(repro_torch.serving.__file__).parent])
    assert errors(diags) == []


def test_lm_scheduler_tokens_equal_reference():
    """The bare-bundle convenience path: a head-only generative model
    whose requests carry precomputed image embeds."""
    from repro.serving.scheduler import SchedulerConfig as RefConfig
    from repro.serving.scheduler import lm_scheduler as ref_lm_scheduler
    from repro_torch.serving.scheduler import SchedulerConfig, lm_scheduler

    cfg = ref_get_config("internvl2-1b", smoke=True)
    bundle = ref_build_model(cfg, compute_dtype=jnp.float32)
    params = bundle.init(jax.random.PRNGKey(2))
    tbundle = build_model(get_config("internvl2-1b", smoke=True),
                          compute_dtype=torch.float32)
    tparams = params_from_numpy(jax.tree.map(np.asarray, params), "cpu")
    knobs = dict(decode_rows=2, page_size=8, max_seq_len=48, decode_pages=20)
    img = np.random.default_rng(5).standard_normal(
        (cfg.n_image_tokens, cfg.d_model)).astype(np.float32)

    def reqs(cls):
        return [cls(rid=i, model="lm", source="dev0", prompt=(5 + i, 9),
                    max_new_tokens=4 + i, inputs={"vision": img})
                for i in range(3)]

    ref = ref_lm_scheduler(bundle, params, config=RefConfig(**knobs))
    port = lm_scheduler(tbundle, tparams, device="cpu",
                        config=SchedulerConfig(**knobs))
    for r, p in zip(ref.serve(reqs(RefRequest)), port.serve(reqs(Request))):
        np.testing.assert_array_equal(p.output, np.asarray(r.output))
    assert port.check_invariants() == []


def test_plan_and_replan_match_reference():
    """The copied placement/routing code plans, simulates and replans
    like the reference on a three-device cluster."""
    def build(mod, mdl, cluster_cls, dev_cls, dep_cls, req_cls):
        enc = mod("enc-a", "encoder", "vision", 10**8, flops_per_query=1e9)
        enc2 = mod("enc-b", "encoder", "text", 5 * 10**7, flops_per_query=4e8)
        head = mod("head", "head", "task", 10**7, flops_per_query=1e8)
        cluster = cluster_cls(devices=[dev_cls(f"d{i}", (i + 1) * GB // 2,
                                               1e10 * (i + 1))
                                       for i in range(3)])
        dep = (dep_cls(cluster)
               .add_model(mdl("vqa", "vqa-enc", (enc, enc2), head))
               .add_model(mdl("cls", "classification", (enc,), head))
               .plan("greedy", replicate=True))
        wl = [req_cls(i, "vqa" if i % 2 else "cls", "d0", arrival=0.1 * i)
              for i in range(6)]
        before = dep.simulate(wl)
        after = dep.replan(cluster.without("d2"))
        return before, after, dep.simulate(wl)

    ref = build(RefModuleSpec, RefModelSpec, RefClusterSpec, RefDeviceSpec,
                RefDeployment, RefRequest)
    port = build(ModuleSpec, ModelSpec, ClusterSpec, DeviceSpec, Deployment,
                 Request)
    for r, p in zip(ref, port):
        assert p.assignments == r.assignments
        assert p.migrations == r.migrations
        assert p.routes == r.routes
        assert p.memory == r.memory
    assert port[2].sim.latencies == ref[2].sim.latencies
