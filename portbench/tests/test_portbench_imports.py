"""What the benchmark's modules may import and read, by their syntax
trees: no JAX and no JAX package anywhere (top-level names compared
whole: ``repro_torch`` is not ``repro``), nothing of the program in the
references, nothing of the JAX package's benchmark."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in PB.rglob("*.py") if "__pycache__" not in p.parts)


def imported_tops(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def strings(path: Path) -> list:
    return [n.value for n in ast.walk(ast.parse(path.read_text()))
            if isinstance(n, ast.Constant) and isinstance(n.value, str)]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & {"jax", "jaxlib", "flax", "repro",
                                      "benchmarks"}


@pytest.mark.parametrize(
    "path", [p for p in FILES if p.name != Path(__file__).name],
    ids=lambda p: str(p.relative_to(PB)))
def test_reads_nothing_of_the_jax_benchmark(path):
    for s in strings(path):
        assert "BENCH_" not in s and not s.startswith("benchmarks")


@pytest.mark.parametrize(
    "path", sorted((PB / "reference").glob("*.py")),
    ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not imported_tops(path) & {"repro_torch", "portbench_config"}
    assert imported_tops(path) <= {"__future__", "torch", "numpy", "math",
                                   "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_the_walk_sees_a_jax_import(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import repro.models as m\nfrom jax import numpy\n")
    assert imported_tops(f) == {"repro", "jax"}
    f.write_text("import repro_torch\n")
    assert imported_tops(f) == {"repro_torch"}
