"""The knee of an open-loop cell: the highest offered rate at which at
least 99 % of the requests due in a window finish in it and the backlog
does not grow.  Runs the cell at each ``--rates`` in one process and
prints, for each, the share finished in the window, the requests still
owed at its close and the p95 time to first output.  Not part of the
benchmark's runs.

    python3 portbench/tools/sweep.py --workload clip-b16.poisson \
        --seconds 8 --rates 200 300 400 500 600
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
    ap.add_argument("--rates", type=float, nargs="+", required=True)
    ap.add_argument("--seed", type=int, default=2**31 + 99)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        sys.path.insert(0, str(p))
    from portbench import harness

    for rate in args.rates:
        out = harness.run(ROOT, args.workload, args.seed, args.seconds,
                          False, args.device, mix={"rate": rate})
        due = out["attempted"]
        done = out["served"]["in_window"]
        print("SWEEP " + json.dumps({
            "rate": rate, "due": due, "done_in_window": done,
            "share": done / due if due else None,
            "owed_at_close": due - done, "failed": out["failed"],
            "ttft_p95_ms": out["metrics"]["ttft_p95_ms"]["value"],
            "correct": out["correct"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
