"""Print the port's dry run beside the reference's at small meshes.

    PYTHONPATH=src python3 tools/dryrun_parity.py

The cells of ``tests/test_torch_dryrun.py`` (``REF_CELLS``: smoke
tinyllama-1.1b, granite-moe-3b-a800m, zamba2-7b and xlstm-1.3b at (2,
2), a train, a prefill and a decode cell; tinyllama's train cell at (2,
2, 2); the recurrent train cells again at S 64, B 4): the port laid out
on meta tensors over a fake process group, the reference lowered and
compiled in a child process with eight CPU devices
(``tests/torch_mesh_ref.py``; this script imports no jax).  One line a
cell: argument bytes, dot FLOPs and collective bytes per device on each
side.  Where the products differ, by (output elements, contracted
elements) (the port's ``CostReport.dots_by_shape``, the reference's HLO
dots along every call edge with their trip counts), one line for each
key that differs, and for a recurrent train cell whether the difference
is the test's ``train_residue``.  CPU only, about 40 s.
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
        print(f"[parity] {c['arch']} {c['shape'][1]} S {c['shape'][2]} B "
              f"{c['shape'][3]} mesh {c['mesh']}: arguments "
              f"{got['memory']['argument_size_in_bytes']:,} B (reference "
              f"{int(ref[f'{i}/argument']):,}); dot FLOPs {flops:,.0f} "
              f"(reference {want:,.0f}, {100 * (flops / want - 1):+.3f} %); "
              f"collective bytes {got['collectives']['total_bytes']:,.0f} "
              f"{got['collectives']['count_by_op']} (reference "
              f"{float(ref[f'{i}/collective_bytes']):,.0f})")
        diff = cells.dots_residue(got["cost"]["dots_by_shape"],
                                  ref[f"{i}/dots"])
        for (n_out, k), n in sorted(diff.items(), key=lambda kv: (
                -abs(kv[1]) * kv[0][0] * kv[0][1])):
            print(f"[parity]   products of {n_out:,} outputs contracting "
                  f"{k:,}: port - reference {n:+} ({2 * n_out * k * n:+,} "
                  f"FLOPs)")
        if c["shape"][1] == "train" and c["arch"] in cells.RECURRENT:
            named = cells.train_residue(c["arch"], c["shape"], c["mesh"])
            print(f"[parity]   the difference is train_residue's named "
                  f"terms ({cells.dot_flops(named):+,} FLOPs): "
                  f"{diff == named}")


if __name__ == "__main__":
    main()
