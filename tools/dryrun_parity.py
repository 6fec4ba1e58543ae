"""Print the port's dry run beside the reference's at small meshes.

    PYTHONPATH=src python3 tools/dryrun_parity.py

The cells of ``tests/test_torch_dryrun.py`` (smoke tinyllama-1.1b and
granite-moe-3b-a800m at (2, 2), a train, a prefill and a decode cell;
tinyllama's train cell at (2, 2, 2)): the port laid out on meta tensors
over a fake process group, the reference lowered and compiled in a child
process with eight CPU devices (``tests/torch_mesh_ref.py``; this script
imports no jax).  One line a cell: argument bytes, dot FLOPs and
collective bytes per device on each side.  CPU only, about 30 s.
"""

from __future__ import annotations

import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "tests")]
    import test_torch_dryrun as cells
    import torch_mesh_ref as mref

    with tempfile.TemporaryDirectory() as tmp:
        proc, npz = mref.start("dryrun", cells.REF_CELLS, pathlib.Path(tmp),
                               devices=8)
        ports = [cells._lay_out(c["arch"], c["shape"], c["mesh"])
                 for c in cells.REF_CELLS]
        ref = mref.finish(proc, npz)
    for i, (c, got) in enumerate(zip(cells.REF_CELLS, ports)):
        flops, want = got["cost"]["flops"], float(ref[f"{i}/flops"])
        print(f"[parity] {c['arch']} {c['shape'][1]} mesh {c['mesh']}: "
              f"arguments {got['memory']['argument_size_in_bytes']:,} B "
              f"(reference {int(ref[f'{i}/argument']):,}); dot FLOPs "
              f"{flops:,.0f} (reference {want:,.0f}, "
              f"{100 * (flops / want - 1):+.2f} %); collective bytes "
              f"{got['collectives']['total_bytes']:,.0f} "
              f"{got['collectives']['count_by_op']} (reference "
              f"{float(ref[f'{i}/collective_bytes']):,.0f})")


if __name__ == "__main__":
    main()
