"""Fixtures of the benchmark's CPU tests: a copy of the benchmark with
its configurations and mixes cut to smoke size, and the card fixture
that the ``cuda``-marked tests take."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for _p in (ROOT / "src", ROOT):
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

SEED = 2**31 + 7


def smoke_copy(dst: Path) -> Path:
    """BENCHMARK.json and portbench/ under ``dst``, every configuration
    and mix cut to a size a CPU runs in seconds (widths included: these
    copies are the CPU's, never a cell)."""
    shutil.copytree(ROOT / "portbench", dst / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    c = dst / "portbench" / "configs"
    s = json.loads((c / "clip-vit-b16-mt.json").read_text())
    s["vision_config"].update(hidden_size=64, intermediate_size=256,
                              num_attention_heads=4, num_hidden_layers=2,
                              image_size=32, patch_size=8)
    s["text_config"].update(hidden_size=64, intermediate_size=256,
                            num_attention_heads=4, num_hidden_layers=2,
                            vocab_size=256, max_position_embeddings=12)
    s["projection_dim"] = 32
    s["tasks"]["classify"]["classes"] = 10
    s["tasks"]["vqa"]["classes"] = 20
    (c / "clip-vit-b16-mt.json").write_text(json.dumps(s))
    s = json.loads((c / "internvl2-1b-mt.json").read_text())
    s["llm_config"].update(hidden_size=64, intermediate_size=128,
                           num_attention_heads=4, num_key_value_heads=2,
                           num_hidden_layers=2, vocab_size=256)
    s["vision_config"].update(hidden_size=64, image_size=56, patch_size=14)
    s["tasks"]["classify"]["classes"] = 10
    (c / "internvl2-1b-mt.json").write_text(json.dumps(s))
    t = dst / "portbench" / "traffic"
    for f in t.glob("*.json"):
        m = json.loads(f.read_text())
        m["scheduler"]["max_batch"] = 4
        m["pool"] = 8
        m["trace_slice_s"] = 0.3
        if "rate" in m:
            m["rate"] = 30.0
        if "clients" in m:
            m["clients"] = 6
            m["lead_in"] = min(m.get("lead_in", 6), 6)
        for task in m["tasks"]:
            if isinstance(task.get("prompt"), dict):
                task["prompt"].update(min=2, max=24, median=6)
            if isinstance(task.get("output"), dict) and \
                    "median" in task["output"]:
                task["output"].update(min=2, max=16, median=5)
        if "decode_rows" in m["scheduler"]:
            m["scheduler"].update(decode_rows=6, page_size=4, max_seq_len=56,
                                  decode_pages=6 * 14 + 1)
        f.write_text(json.dumps(m))
    return dst


@pytest.fixture
def smoke_root(tmp_path):
    return smoke_copy(tmp_path)


@pytest.fixture
def card():
    """The card, decided here and never at import: the ``cuda`` tests
    skip without one."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")
