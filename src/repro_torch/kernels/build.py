"""Build and load the hand-written CUDA kernels.

Each source under ``repro_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, and
loaded with ``ctypes`` — no PyTorch headers, so a build takes seconds.
Libraries land in ``<repo>/build/kernels/`` (git-ignored), named by a
hash of their source and flags, so an edited source is rebuilt on its
next use and an unchanged one is reused.  ``build_all()`` starts one
``nvcc`` per source at once and waits for all of them.

Nothing here runs at import time: importing the module (as the CPU
tests do) never looks for ``nvcc``; the build happens when a kernel is
first launched on a CUDA tensor, or when ``build_all()`` is called.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: library name -> (source file, {C entry point: argtypes})
LIBRARIES = {
    "flash_attention": ("flash_attention.cu", {
        # q, k, v, o, B, S, T, H, K, D, dtype, causal, window, softcap, stream
        "flash_attention_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                _I, _I, _F, _P],
        # D, dtype, int[4] out: BQ, BK, threads, dynamic shared-memory
        # bytes of that dtype's instance
        "flash_attention_plan": [_I, _I, _P],
    }),
    "decode_attention": ("decode_attention.cu", {
        # q, k, v, lengths, o, ws, counters, B, H, K, D, T, n_split,
        # window, dtype, softcap, stream
        "decode_attention_fwd": [_P] * 7 + [_I] * 8 + [_F, _P],
        # q, kp, vp, tables, lengths, o, ws, counters, B, H, K, D, P, ps,
        # n_max, n_split, window, dtype, softcap, stream
        "paged_decode_attention_fwd": [_P] * 8 + [_I] * 10 + [_F, _P],
        # q, kp, vp, tables, lengths, o, lse, ws, counters, B, H, K, D,
        # n_pages, p0, P, ps, s0, ps_loc, n_max, n_split, window, dtype,
        # softcap, stream
        "paged_decode_attention_tile_fwd": [_P] * 9 + [_I] * 14 + [_F, _P],
        # D, dtype, int[3] out: threads a block, the blocks an SM holds,
        # static shared-memory bytes of the tile mode's kernel
        "paged_decode_tile_info": [_I, _I, _P],
    }),
    "mla_decode": ("mla_decode.cu", {
        # q_lat, q_pe, ckv, kr, tables, lengths, o, ws, B, H, r, rope, P,
        # ps, n_max, n_split, scale, stream
        "paged_mla_decode_fwd": [_P] * 8 + [_I] * 8 + [_F, _P],
        # int[3] out: threads a block, dynamic shared-memory bytes, the
        # blocks an SM holds
        "paged_mla_decode_info": [_P],
    }),
    "ssd_scan": ("ssd_scan.cu", {
        # x, Bm, Cm, dt, A_log, y, s_loc, lam, BC, L, H, P, N, then the
        # plan (tr, ns, n_heavy, threads, smem), dtype, stream
        "ssd_intra_chunk_fwd": [_P] * 8 + [_I] * 11 + [_P],
        # L, P, N, tr, ns, int[3] out: dynamic shared-memory bytes,
        # threads, the blocks an SM holds
        "ssd_intra_chunk_info": [_I] * 5 + [_P],
    }),
    "slstm_scan": ("slstm_scan.cu", {
        # pre, r_i, r_f, r_z, r_o, y, c, n, h, m, state_out, B, S, d, H,
        # hd, C, jr, rows, dtype, stream
        "slstm_scan_fwd": [_P] * 11 + [_I] * 9 + [_P],
        # pre, r_i, r_f, r_z, r_o, y, c, n, h, m, state_out, B, d, H, hd,
        # dtype, stream
        "slstm_step_fwd": [_P] * 11 + [_I] * 5 + [_P],
        # hd, C, jr, rows, int[3] out: shared-memory bytes, threads, the
        # clusters the card holds at once
        "slstm_prefill_info": [_I, _I, _I, _I, _P],
    }),
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """``nvcc`` is missing or refused a source."""


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildError(
        "nvcc not found on PATH or under $CUDA_HOME/bin; the CUDA kernels "
        "build only where the CUDA toolkit is installed")


def lib_path(name: str) -> Path:
    src = (CSRC / LIBRARIES[name][0]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def _start(name: str) -> subprocess.Popen | None:
    out = lib_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
           str(CSRC / LIBRARIES[name][0])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen | None) -> str:
    """Wait for one build; install the library atomically and keep the
    compiler's report (registers, shared memory, spills) beside it."""
    out = lib_path(name)
    log_path = out.with_suffix(".log")
    if proc is None:
        return log_path.read_text() if log_path.exists() else ""
    log, _ = proc.communicate()
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"nvcc failed for {name}:\n{log}")
    log_path.write_text(log)
    os.replace(tmp, out)
    return log


def build_all() -> dict[str, str]:
    """Compile every kernel library that is missing, one ``nvcc`` per
    source, all started together.  Returns name -> compiler report."""
    with _lock:
        procs = {name: _start(name) for name in LIBRARIES}
        reports, failed = {}, []
        for name, proc in procs.items():    # wait for every nvcc first
            try:
                reports[name] = _finish(name, proc)
            except KernelBuildError as e:
                failed.append(str(e))
        if failed:
            raise KernelBuildError("\n".join(failed))
        return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name`` (building it first if needed), with
    ``argtypes``/``restype`` declared for each C entry point."""
    with _lock:
        lib = _loaded.get(name)
        if lib is not None:
            return lib
        _finish(name, _start(name))
        lib = ctypes.CDLL(str(lib_path(name)))
        for fn, argtypes in LIBRARIES[name][1].items():
            f = getattr(lib, fn)
            f.argtypes = argtypes
            f.restype = ctypes.c_int
        _loaded[name] = lib
        return lib
