"""The port's ``obs.summary`` and ``obs.drift`` (copies of the JAX
package's) and ``Deployment.compare()``: the SLO rows of one metrics
history equal the reference's; on the mini-clip scenario (retrieval,
classify and vqa sharing the towers) the port's ``compare()`` reports
no route divergence and the same simulated and served routes as the
reference's on the same requests.  Measured/predicted latency ratios
time two different machines' work and are not compared across
packages."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.s2m3_zoo import get_clip_config as ref_clip_config
from repro.core.cluster import ClusterSpec as RefClusterSpec
from repro.core.cluster import DeviceSpec as RefDeviceSpec
from repro.core.module import ModelSpec as RefModelSpec
from repro.core.module import ModuleSpec as RefModuleSpec
from repro.models import clip as JC
from repro.obs import MetricsRegistry as RefRegistry
from repro.obs import format_slo_summary as ref_format
from repro.obs import slo_summary as ref_slo_summary
from repro.s2m3 import Deployment as RefDeployment
from repro.s2m3 import Request as RefRequest
from repro_torch.obs import (DriftReport, MetricsRegistry, compare_deployment,
                             format_slo_summary, slo_summary)
from repro_torch.s2m3 import Request

GB = 1024**3
TASKS = ["retrieval", "classify", "vqa"]


def _history(reg):
    """One metrics history: latencies and SLO outcomes of three tasks."""
    rng = np.random.default_rng(0)
    for i, model in enumerate(["retrieval", "classify", "vqa", "retrieval"]):
        for x in rng.uniform(0.001, 0.5, size=5 + i):
            reg.histogram("request.latency_s", model=model).observe(float(x))
            if i != 1:      # classify carries no deadline
                reg.counter("slo.hit" if x < 0.3 else "slo.miss",
                            model=model).inc()
    return reg


def test_slo_summary_rows_equal_reference():
    want = ref_slo_summary(_history(RefRegistry()))
    got = slo_summary(_history(MetricsRegistry()))
    assert got == want
    assert [r["model"] for r in got] == ["classify", "retrieval", "vqa"]
    assert format_slo_summary(got) == ref_format(want)
    assert format_slo_summary([]) == ref_format([])


def _ref_deployment():
    """The reference's multi-task scenario (examples/multi_task_serving.py)
    on one jax CPU device."""
    ccfg = ref_clip_config("mini-clip")
    params = JC.init_clip(jax.random.PRNGKey(0), ccfg)
    vis = RefModuleSpec("mini-vit", "encoder", "vision", 60_000,
                        flops_per_query=2e6)
    txt = RefModuleSpec("mini-trf", "encoder", "text", 50_000,
                        flops_per_query=1e6)
    cos = RefModuleSpec("cosine", "head", "task", 0)
    cls = RefModuleSpec("mini-classifier", "head", "task", 1_000,
                        flops_per_query=1e4)
    lm = RefModuleSpec("mini-lm", "head", "task", 80_000, flops_per_query=4e6)
    w_cls = jnp.ones((ccfg.embed_dim, 10))
    w_lm = jnp.ones((2 * ccfg.embed_dim, 32))
    builders = {
        "mini-vit": lambda: (partial(JC.encode_image, cfg=ccfg),
                             params["vision"]),
        "mini-trf": lambda: (partial(JC.encode_text, cfg=ccfg),
                             params["text"]),
        "cosine": lambda: (
            lambda p, enc: JC.retrieval_logits(enc["vision"], enc["text"], p),
            params["logit_scale"]),
        "mini-classifier": lambda: (lambda p, enc: enc["vision"] @ p, w_cls),
        "mini-lm": lambda: (
            lambda p, enc: jnp.argmax(jnp.concatenate(
                [enc["vision"], enc["text"]], -1) @ p, -1), w_lm),
    }
    pool = RefClusterSpec(devices=[
        RefDeviceSpec(f"dev{i}", 1 * GB, (2.0 if i < 2 else 1.0) * 1e9)
        for i in range(4)])
    return (RefDeployment(pool)
            .add_model(RefModelSpec("retrieval", "retrieval", (vis, txt), cos),
                       builders)
            .add_model(RefModelSpec("classify", "classification", (vis,), cls))
            .add_model(RefModelSpec("vqa", "vqa-dec", (vis, txt), lm))
            .plan(placement="greedy", routing="paper")
            .materialize())


def _burst(req_cls, inputs, n=9):
    return [req_cls(10 + i, TASKS[i % 3], "dev0", inputs=inputs[TASKS[i % 3]],
                    slo_deadline=2.0)
            for i in range(n)]


def _inputs(patches, ids):
    return {"retrieval": {"vision": patches, "text": ids},
            "classify": {"vision": patches},
            "vqa": {"vision": patches, "text": ids}}


@pytest.fixture(scope="module")
def port():
    from repro_torch.examples import multi_task_serving as ex

    dep, _, _, ccfg = ex.build_deployment("cpu")
    patches, ids = ex.make_inputs(ccfg)
    return dep, _inputs(patches, ids)


def test_compare_reports_no_route_divergence(port):
    dep, inputs = port
    drift = dep.compare(_burst(Request, inputs), max_batch=8)
    assert isinstance(drift, DriftReport)
    assert drift.n_requests == 9 and drift.n_route_divergences == 0
    assert drift.routes_checked == 24        # 9 x 2 encoders + 6 timed heads
    assert set(drift.modules) == {"cosine", "mini-classifier", "mini-lm",
                                  "mini-trf", "mini-vit"}
    assert all(md.n > 0 and md.measured_s > 0 and md.predicted_s > 0
               for md in drift.modules.values())
    assert set(drift.request_latency) == {r.rid for r in
                                          _burst(Request, inputs)}
    rows = slo_summary(dep.scheduler)
    assert [r["model"] for r in rows] == sorted(TASKS)
    assert all(r["requests"] == 3 and r["slo_requests"] == 3 for r in rows)


def test_compare_is_compare_deployment(port):
    """``Deployment.compare`` is ``obs.drift.compare_deployment`` on the
    deployment: the same routes and modules on the same requests."""
    dep, inputs = port
    a = dep.compare(_burst(Request, inputs, 6), max_batch=8)
    b = compare_deployment(dep, _burst(Request, inputs, 6), max_batch=8)
    assert (a.routes_checked, a.route_divergences, sorted(a.modules)) == \
        (b.routes_checked, b.route_divergences, sorted(b.modules))


def test_routes_equal_reference_compare(port):
    dep, inputs = port
    ccfg = ref_clip_config("mini-clip")
    rng = np.random.default_rng(1)
    ref_inputs = _inputs(
        rng.standard_normal((4, ccfg.n_image_tokens, ccfg.vision_width)
                            ).astype(np.float32),
        rng.integers(0, ccfg.vocab_size, (4, 12)).astype(np.int32))
    ref = _ref_deployment()
    want = ref.compare(_burst(RefRequest, ref_inputs), max_batch=8)
    got = dep.compare(_burst(Request, inputs), max_batch=8)
    assert got.n_route_divergences == want.n_route_divergences == 0
    assert got.routes_checked == want.routes_checked
    assert sorted(got.modules) == sorted(want.modules)
    assert [m.n for _, m in sorted(got.modules.items())] == \
        [m.n for _, m in sorted(want.modules.items())]
    sim_r = ref.simulate(_burst(RefRequest, ref_inputs)).routes
    sim_p = dep.simulate(_burst(Request, inputs)).routes
    assert sim_p == sim_r
    served_r = ref.serve(_burst(RefRequest, ref_inputs), max_batch=8)
    served_p = dep.serve(_burst(Request, inputs), max_batch=8)
    assert [r.devices for r in served_p] == [r.devices for r in served_r]
    assert torch.is_tensor(served_p[0].output)


def test_encode_spans_end_after_the_device_sync(port, monkeypatch):
    """The measured side of ``compare()``: an encoder batch's span ends
    after the wait for its device work (CUDA launches return at once,
    so a span closed before the wait would time the enqueue)."""
    import time

    import repro_torch.serving.scheduler as sched_mod

    dep, inputs = port
    monkeypatch.setattr(sched_mod, "sync", lambda device: time.sleep(0.02))
    served = dep.serve(_burst(Request, inputs, 3), max_batch=8)
    spans = [s for r in served for s in r.timeline if s.phase == "encode"]
    assert spans and all(s.t1 - s.t0 >= 0.02 for s in spans)
