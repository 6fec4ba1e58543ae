"""The port stands alone: ``repro_torch`` and ``chip_smoke.py`` import
no jax and nothing of ``repro``; the port runs on the card unless the
caller asks for the CPU, and never drops to the CPU by itself."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(m for m, mod in sys.modules.items() if mod is not "
        "None and (m == 'repro' or m.startswith(('repro.', 'jax'))))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 30


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_no_jax_or_reference_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods = [node.module or ""]
        else:
            continue
        for m in mods:
            root = m.split(".")[0]
            assert root not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {m}"


def _tiny_deployment():
    from repro_torch.core.cluster import ClusterSpec, DeviceSpec
    from repro_torch.core.module import ModelSpec, ModuleSpec
    from repro_torch.s2m3 import Deployment

    enc = ModuleSpec("enc", "encoder", "vision", 16, flops_per_query=1e3)
    head = ModuleSpec("head", "head", "task", 16, flops_per_query=1e3)
    w = torch.eye(4)
    builders = {"enc": lambda: (lambda p, x: x @ p, w),
                "head": lambda: (lambda p, e: e["vision"] @ p, w)}
    return (Deployment(ClusterSpec(devices=[DeviceSpec("dev0", 1 << 30, 1e9)]))
            .add_model(ModelSpec("m", "classification", (enc,), head),
                       builders).plan("greedy"))


def test_materialize_needs_cuda_unless_cpu_is_asked_for(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        _tiny_deployment().materialize()
    from repro_torch.s2m3 import Request

    dep = _tiny_deployment().materialize(device="cpu")
    assert dep.engine.device_map == {"dev0": torch.device("cpu")}
    x = np.ones((2, 4), np.float32)
    out = dep.submit(Request(0, "m", "dev0", inputs={"vision": x}))
    np.testing.assert_array_equal(out.output.numpy(), x)
    assert out.devices == {"enc": "dev0", "head": "dev0"}


@pytest.mark.parametrize("arch", ["internvl2-1b", "zamba2-7b", "xlstm-1.3b",
                                  "tinyllama-1.1b", "whisper-tiny",
                                  "deepseek-v3-671b", "llama3-405b"])
def test_model_init_needs_cuda_unless_cpu_is_asked_for(monkeypatch, arch):
    """A model built with no device lands on the card: with CUDA hidden,
    its weights and caches raise instead of falling back to the CPU."""
    from repro_torch.common.config import get_config
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.models.api import build_model

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    b = build_model(get_config(arch, smoke=True), compute_dtype=torch.float32)
    for make in (lambda: b.init(torch.Generator().manual_seed(0)),
                 lambda: b.init_cache(1, 8, dtype=torch.float32)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    params = b.init(torch.Generator().manual_seed(0), device="cpu")
    assert {t.device.type for t in tree_leaves(params)} == {"cpu"}
    if b.paged_cache_specs is not None:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            b.init_paged_cache(4, 8, dtype=torch.float32)


@pytest.mark.parametrize("kw,code", [
    ({"kernels": True}, "kernel/summary"),
    ({"model_check": True, "mc_budget": 10.0}, "modelcheck/clean"),
])
def test_verify_passes_return_diagnostics(kw, code):
    """verify(kernels=True) and verify(model_check=True) are ported: each
    returns its findings as Diagnostics, without an ERROR here."""
    from repro_torch.analysis import Diagnostic, errors

    dep = _tiny_deployment()
    assert dep.verify() == []
    diags = dep.verify(**kw)
    assert diags and all(isinstance(d, Diagnostic) for d in diags)
    assert code in {d.code for d in diags} and errors(diags) == []


def test_no_unported_pass_left_in_analysis():
    for f in sorted((PORT / "analysis").glob("*.py")):
        assert "NotImplementedError" not in f.read_text(), f.name


def test_kernel_wrappers_take_plain_version_for_cpu_tensors(monkeypatch):
    """Without CUDA, a CPU tensor goes through the plain version and no
    build is attempted (the build module is never asked for nvcc)."""
    from repro_torch.kernels import build, ops, ref

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("built"))
    ops.reset_launches()
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 14, 16, generator=g)
    k = torch.randn(2, 20, 2, 16, generator=g)
    lens = torch.tensor([20, 3], dtype=torch.int32)
    torch.testing.assert_close(ops.decode_attention(q, k, k, lens),
                               ref.decode_attention_ref(q, k, k, lens),
                               rtol=0, atol=0)
    assert set(ops.LAUNCHES) == {"flash_attention", "decode_attention",
                                 "paged_decode_attention", "paged_mla_decode",
                                 "ssd_intra_chunk", "slstm_scan",
                                 "slstm_scan_s1"}
    assert not any(ops.LAUNCHES.values())


def test_build_names_libraries_by_source_hash():
    from repro_torch.kernels import build

    paths = {name: build.lib_path(name) for name in build.LIBRARIES}
    assert len(set(paths.values())) == len(paths)
    for name, p in paths.items():
        assert p.parent == build.BUILD_DIR and p.name.startswith(name + "-")
        assert (build.CSRC / build.LIBRARIES[name][0]).exists()


def test_live_replan_backs_new_hosts_with_the_deployment_device():
    from repro_torch.core.cluster import DeviceSpec
    from repro_torch.s2m3 import Request

    dep = _tiny_deployment().materialize(device="cpu")
    report = dep.replan(dep.cluster.with_device(
        DeviceSpec("dev1", 4 << 30, 1e11)))
    assert dep.engine.device_map == {"dev0": torch.device("cpu"),
                                     "dev1": torch.device("cpu")}
    assert report.feasible
    x = np.ones((1, 4), np.float32)
    out = dep.submit(Request(1, "m", "dev0", inputs={"vision": x}))
    assert set(out.devices) == {"enc", "head"}
    np.testing.assert_array_equal(out.output.numpy(), x)
