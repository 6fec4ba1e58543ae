#!/usr/bin/env python3
"""Where the SSD intra-chunk kernel's float32 y_intra loses precision.

    python3 tools/ssd_precision.py [--device cuda|cpu] [--cases N]

From the root of a checkout.  The inputs are ``chip_smoke.py`` phase
10's: the kernel checker's zoo cases drawn in order from one generator
(seed 0) on ``--device``, of which the ``ssd_intra_chunk`` cases
(zamba2-7b: 8 chunks of 128, and its 1-, 2- and 3-chunk prefills; H =
112, P = N = 64) are used.  Every number is a max |difference| from the
same function evaluated in float64 (``ref.ssd_intra_chunk_ref(...,
dtype=torch.float64)``):

* ``kernel`` — the CUDA kernel (on ``--device cuda`` only);
* ``plain f32`` — the plain version in float32;
* ``emulated`` — the kernel's own float32 arithmetic, step for step, in
  torch (``emulate``): a = -exp(A_log) in log2 units, cum by the
  kernel's warp scan over each y tile's keys (in float64, stored in
  float32 relative to the tile's last key), C.B^T and M @ x as chained
  FMAs in key order, M = (C.B^T * exp2(cum_t - cum_s)) * dt_s;
* ``emulated, f32 scan`` — the same with the scan the kernel had
  before: a rounded to float32, the warp scan's adds in float32, cum
  absolute;
* ``only <stage>`` — the emulation in float64 with one stage rounded
  to float32 the kernel's way: the share of that stage (``only cum,
  f32 scan``: of the scan before).

Where ``emulated`` lands on ``kernel``, the stages' shares say which of
the kernel's products loses the bits.  For the ``ssd_chunked`` case
(zamba2-7b, 1024 steps) it prints y's distance from the float64
step-by-step recurrence (``ref.ssd_scan_ref``) of ``ops.ssd_chunked``
(``kernel`` on the card; ``plain f32`` on host copies, its intra-chunk
part the plain version), of the same with the intra-chunk part in
float64 (``f64 intra``: the inter-chunk part's own share) and of the
float32 recurrence (``step-by-step f32``).  On the card it prints the card's
name and power limit first; on the CPU every number is of the
emulation and the plain version, none of the card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

LOG2E = 1.4426950408889634
STAGES = ("cum", "exp2", "score", "m", "y")
TR = 32          # ssd_plan's query rows a y tile (ops.SSD_PLAN_ROWS)


def _fma32(a, b, c):
    """fmaf(a, b, c): the exact a b + c rounded once to float32 (a
    float32 product is exact in float64)."""
    import torch

    return (a.double() * b.double() + c.double()).float()


def _scan_cum_f32(terms):
    """The float32 ``scan_cum`` the kernel had before, over the last dim
    (n <= 128 terms dt_s a): 32 lanes of E = ceil(n / 32) consecutive
    terms, each lane's running sum, a Hillis-Steele scan of the lanes'
    totals, then (total before the lane) + (lane's running sum), every
    add rounded to float32 (the first is an FMA)."""
    import torch

    n = terms.shape[-1]
    E = -(-n // 32)
    pad = torch.zeros(*terms.shape[:-1], 32 * E - n, dtype=terms.dtype)
    t = torch.cat([terms, pad], dim=-1).reshape(*terms.shape[:-1], 32, E)
    rnd = (lambda v: v.float().double())
    loc, run = [], torch.zeros_like(t[..., 0])
    for e in range(E):
        run = rnd(run + t[..., e])
        loc.append(run)
    incl = run
    o = 1
    while o < 32:
        shifted = torch.cat([torch.zeros_like(incl[..., :o]),
                             incl[..., :-o]], dim=-1)
        incl = rnd(incl + shifted)
        o *= 2
    excl = rnd(incl - run)
    cum = torch.stack([rnd(excl + l) for l in loc], dim=-1)
    return cum.reshape(*terms.shape[:-1], 32 * E)[..., :n]


def emulate(x, Bm, Cm, dt, A_log, f32_stages=STAGES, f32_scan=False):
    """The kernel's y_intra (B, nc, L, H, P) with the stages in
    ``f32_stages`` rounded to float32 as the kernel rounds them and the
    rest in float64; ``f32_scan``: cum by the float32 scan the kernel
    had before."""
    import torch

    x, Bm, Cm, dt = (t.double() for t in (x, Bm, Cm, dt))
    B, nc, L, H, P = x.shape
    r = {s: ((lambda v: v.float().double()) if s in f32_stages
             else (lambda v: v)) for s in STAGES}
    if f32_scan:
        a = (-torch.exp(A_log.float()) * torch.tensor(
            LOG2E, dtype=torch.float32)).double()
    else:
        a = -torch.exp(A_log.double()) * LOG2E
    dtT = dt.permute(0, 1, 3, 2)                         # (B,nc,H,L)
    terms = dtT * a[:, None]     # exact: the scan's first add is an FMA
    # each y tile scans the keys it reads: s < min(t0 + TR, L)
    cum_of_tile = []
    for t0 in range(0, L, TR):
        S = min(t0 + TR, L)
        if f32_scan:
            c = _scan_cum_f32(terms[..., :S])
        else:                    # float64, then relative to key S - 1
            c = torch.cumsum(terms[..., :S], dim=-1)
            c = r["cum"](c - c[..., -1:])
        cum_of_tile.append(torch.nn.functional.pad(c, (0, L - S)))
    # the score C_t . B_s: a chain of FMAs along n
    if "score" in f32_stages:
        G = torch.zeros(B, nc, L, L, dtype=torch.float32)
        for n in range(Bm.shape[-1]):
            G = _fma32(Cm[..., :, None, n].float(),
                       Bm[..., None, :, n].float(), G)
        G = G.double()
    else:
        G = torch.einsum("bcln,bcmn->bclm", Cm, Bm)
    y = torch.zeros(B, nc, L, H, P, dtype=torch.float64)
    causal = torch.ones(L, L, dtype=torch.bool).tril()
    for i, t0 in enumerate(range(0, L, TR)):
        rows = slice(t0, min(t0 + TR, L))
        cum = cum_of_tile[i]                             # (B,nc,H,L)
        ct = cum[..., rows, None]                        # (B,nc,H,t,1)
        diff = r["exp2"](ct - cum[..., None, :])         # the f32 subtract
        dec = r["exp2"](torch.exp2(diff))
        g = G[:, :, rows, :][:, :, None]                 # (B,nc,1,t,s)
        m = r["m"](r["m"](g * dec) * dtT[..., None, :])  # (B,nc,H,t,s)
        m = torch.where(causal[rows][None, None, None], m,
                        torch.zeros((), dtype=torch.float64))
        if "y" in f32_stages:                            # FMAs in key order
            acc = torch.zeros(B, nc, m.shape[3], H, P, dtype=torch.float32)
            for s in range(min(t0 + TR, L)):
                acc = _fma32(m[..., s].permute(0, 1, 3, 2)[..., None].float(),
                             x[:, :, s, None].float(), acc)
            y[:, :, rows] = acc.double()
        else:
            y[:, :, rows] = torch.einsum("bchts,bcshp->bcthp", m, x)
    return y


def chunked(case, args, dev) -> None:
    import torch

    from repro_torch.kernels import ops, ref

    t64 = ref.ssd_scan_ref(*args, dtype=torch.float64)[0].cpu()
    cpu = [t.cpu() for t in args]

    def err(y):
        return (y.double().cpu() - t64).abs().max().item()

    def intra64(*a):
        return tuple(t.float() for t in ref.ssd_intra_chunk_ref(
            *a, dtype=torch.float64))

    row = {"step-by-step f32": err(ref.ssd_scan_ref(*args)[0]),
           "plain f32": err(ops.ssd_chunked(*cpu, **case.kwargs)[0])}
    if dev.type == "cuda":
        row["kernel"] = err(ops.ssd_chunked(*args, **case.kwargs)[0])
    real, ops.ssd_intra_chunk = ops.ssd_intra_chunk, intra64
    try:
        row["f64 intra"] = err(ops.ssd_chunked(*cpu, **case.kwargs)[0])
    finally:
        ops.ssd_intra_chunk = real
    print(f"[precision] {case.name} y {tuple(t64.shape)}, max |f64| "
          f"{t64.abs().max().item():.3e}; max |y - f64|: " + ", ".join(
              f"{k} {v:.3e}" for k, v in row.items()), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cases", type=int, default=4,
                    help="how many of the SSD intra-chunk cases to run")
    args_ns = ap.parse_args()

    import torch

    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.analysis import kernel_check as kc
    from repro_torch.kernels import ops, ref

    dev = torch.device(args_ns.device)
    if dev.type == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True
        ).stdout.strip(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    done = 0
    for case in kc.zoo_cases():
        args = case.inputs(g)
        if case.entry == "ssd_chunked":
            chunked(case, args, dev)
        if case.entry != "ssd_intra_chunk" or done >= args_ns.cases:
            continue
        done += 1
        f64 = ref.ssd_intra_chunk_ref(*args, dtype=torch.float64)[0]
        cpu = [t.cpu() for t in args]
        t64 = f64.cpu()

        def err(y):
            return (y.double().cpu() - t64).abs().max().item()

        row = {"plain f32": err(ref.ssd_intra_chunk_ref(*args)[0])}
        if dev.type == "cuda":
            row["kernel"] = err(ops.ssd_intra_chunk(*args)[0])
        row["emulated"] = err(emulate(*cpu))
        row["emulated, f32 scan"] = err(emulate(*cpu, f32_scan=True))
        for s in STAGES:
            row[f"only {s}"] = err(emulate(*cpu, f32_stages=(s,)))
        row["only cum, f32 scan"] = err(emulate(*cpu, f32_stages=(),
                                                f32_scan=True))
        print(f"[precision] {case.name} y_intra "
              f"{tuple(f64.shape)}, max |f64| {t64.abs().max().item():.3e}; "
              "max |y - f64|: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in row.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
