"""Readings for the limits of ``correct``: runs one cell on several
seeds in one process, each with a short window, and prints for each the
numbers the check compares and the control's (the reference at TF32 in
the program's place).  Not part of the benchmark's runs.

    python3 portbench/tools/readings.py --workload <cell> --seconds 8 \
        --seeds 101 102 103 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    from portbench import harness

    for seed in args.seeds:
        out = harness.run(ROOT, args.workload, seed, args.seconds, False,
                          args.device, control=True)
        row = {"seed": seed, "correct": out["correct"],
               "failed": out["failed"], "metrics": {
                   k: v["value"] for k, v in out["metrics"].items()},
               "program": {k: v["value"] for k, v in out["checks"].items()},
               "control": out["control"]}
        print("READING " + json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
