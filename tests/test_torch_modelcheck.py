"""The port's schedule-space model checker: exhaustive exploration of
bounded serving interleavings over the port's ``PagePool``/``SlotPool``
and ``ModuleRegistry`` against the invariant catalog, replayable
counterexamples, the seeded-mutation self-test, the
``Deployment.verify(model_check=True)`` wiring — and parity with the JAX
package's checker: the same states and transitions on the default
scenario, each seeded bug caught under the same invariant, the same
scenario derived from twin deployments."""

import dataclasses
import json

import pytest

from repro.analysis import modelcheck as ref_mc
from repro_torch.analysis import invariants as inv
from repro_torch.analysis import modelcheck as mc
from repro_torch.analysis.diagnostics import errors
from repro_torch.core.cluster import ClusterSpec, DeviceSpec
from repro_torch.s2m3 import Deployment

pytestmark = pytest.mark.modelcheck

GB = 1024**3


# ---- invariant catalog --------------------------------------------------

def test_catalog_is_populated_and_layered():
    cat = inv.catalog()
    names = {i.name for i in cat}
    assert {"pages/no-double-free", "pages/conservation", "pages/no-leak",
            "admission/reservation-sound", "rows/slot-consistent",
            "registry/refcount-consistent", "registry/decoder-pinned",
            "sched/deadlock-free", "slo/bounded-inversion"} <= names
    assert all(i.checked_by for i in cat)
    assert any("model-check" in i.checked_by for i in cat)


def test_check_state_filters_by_layer():
    view = inv.StateView(enabled=(), terminal=False,
                         waiting=(inv.WaitView(rid=1, worst_pages=1),))
    assert "sched/deadlock-free" in {n for n, _ in inv.check_state(view)}
    assert "sched/deadlock-free" not in {
        n for n, _ in inv.check_state(view, where="runtime")}


# ---- clean exploration --------------------------------------------------

def test_default_scenario_verifies_clean_and_complete():
    res = mc.check(mc.default_scenario())
    assert res.ok and res.complete and res.counterexample is None
    assert res.states > 10 and res.transitions >= res.states - 1
    assert "no invariant violation" in res.summary()


def test_budget_truncates_exploration():
    res = mc.check(mc.default_scenario(), budget_s=0.0)
    assert not res.complete and res.counterexample is None


def test_config_validation():
    with pytest.raises(ValueError, match="unknown mutation"):
        mc.MCConfig(requests=(), models=(), mutate="no-such-bug")
    with pytest.raises(ValueError, match="unregistered"):
        mc.MCConfig(requests=(mc.MCRequest(rid=1, model="ghost"),),
                    models=(mc.MCModel("chat", decoder="lm"),))


# ---- seeded mutations ---------------------------------------------------

@pytest.mark.parametrize("mutation", sorted(mc.MUTATIONS))
def test_mutation_caught_and_replayable(mutation):
    cfg = mc.default_scenario(mutate=mutation)
    res = mc.check(cfg)
    cx = res.counterexample
    assert cx is not None and cx.invariant in mc.MUTATIONS[mutation]
    assert cx.script and cx.format_script()
    assert any(name == cx.invariant for name, _ in mc.replay(cfg, cx.script))


def test_self_test_is_all_clear():
    diags = mc.self_test(budget_s=10.0)
    assert diags and not errors(diags)
    caught = {d.message.split("'")[1] for d in diags
              if d.code == "modelcheck/mutation-caught"}
    assert caught == set(mc.MUTATIONS)


def test_counterexample_exports_chrome_trace(tmp_path):
    cx = mc.check(mc.default_scenario(mutate="double-free")).counterexample
    assert cx.to_chrome_trace()["traceEvents"]
    path = tmp_path / "cx.json"
    cx.save_trace(path)
    assert json.loads(path.read_text())["traceEvents"]


def test_replay_rejects_disabled_transition():
    with pytest.raises(ValueError, match="not enabled"):
        mc.replay(mc.default_scenario(), [("finish", 99)])


# ---- parity with the JAX package's checker ------------------------------

def test_default_scenario_explores_the_reference_space():
    mine, theirs = (m.check(m.default_scenario()) for m in (mc, ref_mc))
    assert mine.complete and theirs.complete
    assert (mine.states, mine.transitions) == (theirs.states,
                                                theirs.transitions)


@pytest.mark.parametrize("mutation", sorted(ref_mc.MUTATIONS))
def test_mutation_caught_under_the_reference_invariant(mutation):
    assert mc.MUTATIONS[mutation] == ref_mc.MUTATIONS[mutation]
    mine = mc.check(mc.default_scenario(mutate=mutation)).counterexample
    theirs = ref_mc.check(
        ref_mc.default_scenario(mutate=mutation)).counterexample
    assert mine.invariant == theirs.invariant
    assert mine.script == theirs.script


def _twins(build):
    """The same deployment built from each package's specs, planned."""
    from repro.core.cluster import ClusterSpec as RefClusterSpec
    from repro.core.cluster import DeviceSpec as RefDeviceSpec
    from repro.core.module import ModelSpec as RefModelSpec
    from repro.core.module import ModuleSpec as RefModuleSpec
    from repro.s2m3 import Deployment as RefDeployment
    from repro_torch.core.module import ModelSpec, ModuleSpec

    return (build(RefDeployment, RefClusterSpec, RefDeviceSpec,
                  RefModuleSpec, RefModelSpec),
            build(Deployment, ClusterSpec, DeviceSpec, ModuleSpec, ModelSpec))


def _vlm(Dep, Cluster, Dev, Module, Model):
    """tests/test_torch_serving.py's two tasks on one generative head."""
    enc = Module("pix-enc", "encoder", "vision", 4 * 64 * 64,
                 flops_per_query=2e5)
    head = Module("vlm-head", "head", "task", 100_000, generative=True,
                  flops_per_query=4e5, kv_bytes_per_token=1024)
    return (Dep(Cluster(devices=[Dev(f"dev{i}", GB, 1e9) for i in range(2)]))
            .add_model(Model("caption", "captioning", (enc,), head))
            .add_model(Model("ocr", "ocr", (enc,), head)).plan("greedy"))


def _scenario(Dep, Cluster, Dev, Module, Model):
    """The multi-task scenario's three tasks on the mini-clip towers."""
    vis = Module("mini-vit", "encoder", "vision", 60_000, flops_per_query=2e6)
    txt = Module("mini-trf", "encoder", "text", 50_000, flops_per_query=1e6)
    cos = Module("cosine", "head", "task", 0)
    cls = Module("mini-classifier", "head", "task", 1_000,
                 flops_per_query=1e4)
    lm = Module("mini-lm", "head", "task", 80_000, flops_per_query=4e6)
    return (Dep(Cluster(devices=[
        Dev(f"dev{i}", GB, (2.0 if i < 2 else 1.0) * 1e9) for i in range(4)]))
        .add_model(Model("retrieval", "retrieval", (vis, txt), cos))
        .add_model(Model("classify", "classification", (vis,), cls))
        .add_model(Model("vqa", "vqa-dec", (vis, txt), lm))
        .plan(placement="greedy", routing="paper"))


@pytest.mark.parametrize("build", [_vlm, _scenario], ids=["vlm", "scenario"])
def test_scenario_from_twin_deployments_equal(build):
    ref_dep, dep = _twins(build)
    mine = mc.scenario_from_deployment(dep)
    theirs = ref_mc.scenario_from_deployment(ref_dep)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    res = mc.check(mine)
    assert res.ok and res.complete
    assert (res.states, res.transitions) == (
        ref_mc.check(theirs).states, ref_mc.check(theirs).transitions)


# ---- deployment wiring --------------------------------------------------

def _dep():
    from repro_torch.core.module import ModelSpec, ModuleSpec

    cluster = ClusterSpec(devices=[
        DeviceSpec(f"dev{i}", 1 * GB, 1e9) for i in range(2)])
    enc = ModuleSpec("enc", "encoder", "text", 1_000)
    lm = ModuleSpec("lm", "head", "task", 2_000, generative=True,
                    kv_bytes_per_token=64)
    return (Deployment(cluster)
            .add_model(ModelSpec("chat", "chat", (enc,), lm))
            .add_model(ModelSpec("summarize", "sum", (enc,), lm))
            .plan("greedy"))


def test_verify_model_check_reports_clean():
    diags = _dep().verify(model_check=True, mc_budget=10.0)
    assert "modelcheck/clean" in [d.code for d in diags]
    assert not errors(diags)


def test_verify_model_check_truncated_by_budget_warns():
    diags = _dep().verify(model_check=True, mc_budget=0.0)
    assert [d.code for d in diags if d.code.startswith("modelcheck/")] == [
        "modelcheck/truncated"]


def test_scenario_from_deployment_shares_modules():
    cfg = mc.scenario_from_deployment(_dep())
    assert {m.name for m in cfg.models} == {"chat", "summarize"}
    assert {m.decoder for m in cfg.models} == {"lm"}
    res = mc.check(cfg)
    assert res.ok and res.complete
