"""BENCHMARK.json against the contract's letter: keys, names, units,
files found by name, the cells' metrics, the run length's budget."""

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["portbench"]
    assert 1 <= len(M["command"]) <= 32 and all(TEXT.match(w)
                                                for w in M["command"])
    assert (ROOT / M["command"][1]).is_file()
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_run_seconds_fit_the_check_with_24_cells():
    n = 24
    total = (2 + 14 * n) * (M["run_seconds"] + 60) + n * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_keys():
    seen = set()
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["why"])
        assert (ROOT / c["file"]).is_file()
        assert (ROOT / c["file"]).with_suffix(".py").is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"]) and w["chips"] in (1, 4)
        assert (ROOT / "portbench" / "traffic"
                / f"{w['traffic']}.json").is_file()
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["name"] not in seen
        seen.add(m["name"])
        assert harness.reader_path(ROOT / "portbench" / "metrics",
                                   m["name"]).is_file()
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert TEXT.match(m["layer"])
        assert m["moves"] in {e["name"] for e in M["end_to_end"]}


@pytest.mark.parametrize("cell", [w["name"] for w in M["workloads"]])
def test_every_cell_reports_setup_another_and_a_layer(cell):
    def reports(m):
        return cell in m.get("workloads", [cell])

    e2e = {m["name"] for m in M["end_to_end"] if reports(m)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = [m for m in M["per_layer"] if reports(m)]
    assert layer
    assert all(m["moves"] in e2e for m in layer)


def test_at_most_a_quarter_of_the_cells_on_four_chips():
    fours = sum(w["chips"] == 4 for w in M["workloads"])
    assert fours <= max(1, len(M["workloads"]) // 4)
