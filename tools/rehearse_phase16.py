"""Phase 16 of ``chip_smoke.py`` and its bfloat16 kernel rows on the CPU,
at the smoke configs: the wrappers take their plain versions and count
their launches under their own keys, so every exact-launch check runs as
on the card; no time is measured.

    python3 tools/rehearse_phase16.py        # from the repository root
"""
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.common import config as C  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

if __name__ == "__main__":
    real_get = C.get_config
    C.get_config = lambda name, smoke=False: real_get(name, smoke=True)
    for f in ("synchronize", "empty_cache", "reset_peak_memory_stats"):
        setattr(torch.cuda, f, lambda *a, **k: None)
    torch.cuda.max_memory_allocated = lambda *a, **k: 0
    import repro_torch.serving.engine as E
    import repro_torch.s2m3.deployment as Dp
    for mod in (E, Dp):
        if hasattr(mod, "resolve_device"):
            mod.resolve_device = lambda d=None: torch.device("cpu")
    # count the wrappers' launches on the CPU with their own keys
    fa, da, pa, sa = (ops.flash_attention, ops.decode_attention,
                      ops.paged_decode_attention, ops.ssd_intra_chunk)

    def flash(q, k, v, *, causal=True, window=0, softcap=0.0):
        B, S, H, D = q.shape
        ops._count("flash_attention", (B, S, k.shape[1], H, k.shape[2], D,
                                       bool(causal), window), q.dtype)
        return fa(q, k, v, causal=causal, window=window, softcap=softcap)

    def dec(q, k, v, lengths, *, window=0, softcap=0.0):
        B, H, D = q.shape
        ops._count("decode_attention", (B, k.shape[1], H, k.shape[2], D,
                                        window), q.dtype)
        return da(q, k, v, lengths, window=window, softcap=softcap)

    def paged(q, kp, vp, tables, lengths, *, window=0, softcap=0.0,
              tile=None):
        B, H, D = q.shape
        ops._count("paged_decode_attention", (B, tables.shape[1],
                                              kp.shape[1], H, kp.shape[2], D,
                                              window), q.dtype)
        return pa(q, kp, vp, tables, lengths, window=window, softcap=softcap,
                  tile=tile)

    def ssd(x, Bm, Cm, dt, A_log):
        B, nc, L, H, P = x.shape
        ops._count("ssd_intra_chunk", (B, nc, L, H), x.dtype)
        return sa(x, Bm, Cm, dt, A_log)

    ops.flash_attention, ops.decode_attention = flash, dec
    ops.paged_decode_attention, ops.ssd_intra_chunk = paged, ssd
    cs.H, cs.K, cs.D, cs.N_IMG = 4, 2, 16, 8
    cs.Z_HEADS, cs.Z_D = 4, 16
    cs.G2_LONG, cs.G2_WINDOW = 40, 32
    cs.FAM_GEOM = {**cs.FAM_GEOM, "gemma2-9b": (4, 2, 16)}
    cs._row = lambda name, *a, **k: {"name": name}
    dev = torch.device("cpu")
    t0 = time.time()
    rows, keys = cs.phase_kernels_bf16(dev)
    print("rows", [r["name"] for r in rows], keys)
    rates = {k: 1.0 for k in ("ttft_mean_ms", "ttft_max_ms", "tick_ms",
                              "tok_s", "solo_tok_s", "peak_gb")}
    paths = cs.phase_bf16(dev, rates)
    for name, (path, kernel, key) in keys.items():
        if isinstance(path, tuple):     # a row none of these paths runs
            assert not any(paths[p]["shapes"][kernel].get(key)
                           for p in path), name
            print("[launches]", name, 0, "(no bf16 path runs it)")
            continue
        print("[launches]", name, paths[path]["shapes"][kernel].get(key, 0),
              "of", paths[path]["launches"][kernel])
    print(f"rehearsal done in {time.time() - t0:.1f} s")
