"""Wrappers over the hand-written CUDA attention kernels.

Each wrapper checks its inputs, then either launches its kernel on the
current CUDA stream or — only for tensors that lie on the CPU — takes
the plain version from ``kernels.ref``.  A CUDA tensor never falls back:
a kernel that does not build or launch raises.  ``LAUNCHES`` counts the
kernel launches of each wrapper (the CPU path does not count), so a run
can show that its work went through the kernels.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ref

#: kernel name -> launches since the last ``reset_launches()``
LAUNCHES = {"flash_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0}

#: head dims the kernels are instantiated for: internvl2-1b's 64 and
#: the smoke configs' 16
HEAD_DIMS = (16, 64)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _check(name, tensors):
    """One device (CPU or CUDA) and one float32/bfloat16 dtype for all."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    dts = {t.dtype for t in tensors.values()}
    if len(dts) != 1 or next(iter(dts)) not in _DTYPES:
        raise TypeError(f"{name}: q/k/v must share one dtype of "
                        f"float32/bfloat16, got {sorted(map(str, dts))}")
    return dev


def _cuda_ready(name, tensors, D):
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head_dim {D} not in {HEAD_DIMS}")


def _raise_on(name, err):
    if err != 0:
        raise KernelLaunchError(f"{name}: CUDA error {err} at launch")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B,S,H,D); k/v: (B,T,K,D) with H % K == 0.  Returns (B,S,H,D)
    in q's dtype.  Positions are the trivial arange on both sides."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or K < 1 or H % K:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not "
                         f"match k/v{tuple(k.shape)}")
    dev = _check("flash_attention", {"q": q, "k": k, "v": v})
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    _cuda_ready("flash_attention", {"q": q, "k": k, "v": v}, D)
    from repro_torch.kernels.build import load

    lib = load("flash_attention")
    o = torch.empty_like(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, T, H,
        K, D, _DTYPES[q.dtype], int(bool(causal)), int(window),
        float(softcap), _stream(q))
    _raise_on("flash_attention", err)
    LAUNCHES["flash_attention"] += 1
    return o


def _lengths_ok(name, lengths, B, dev):
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or \
            lengths.device != dev:
        raise ValueError(f"{name}: lengths must be ({B},) int32 on {dev}, "
                         f"got {tuple(lengths.shape)} {lengths.dtype} on "
                         f"{lengths.device}")


def decode_attention(q, k, v, lengths, *, softcap=0.0):
    """q: (B,H,D); k/v: (B,T,K,D); lengths: (B,) int32 valid key counts
    (keys at or past them are masked).  Returns (B,H,D)."""
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or K < 1 or H % K:
        raise ValueError(f"decode_attention: q{tuple(q.shape)} does not "
                         f"match k/v{tuple(k.shape)}")
    dev = _check("decode_attention", {"q": q, "k": k, "v": v})
    _lengths_ok("decode_attention", lengths, B, dev)
    if dev.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths, softcap=softcap)
    _cuda_ready("decode_attention",
                {"q": q, "k": k, "v": v, "lengths": lengths}, D)
    from repro_torch.kernels.build import load

    lib = load("decode_attention")
    o = torch.empty_like(q)
    err = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), B, H, K, D, T, _DTYPES[q.dtype], float(softcap),
        _stream(q))
    _raise_on("decode_attention", err)
    LAUNCHES["decode_attention"] += 1
    return o


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           softcap=0.0):
    """Batched paged-KV decode: q (B,H,D); k/v pages (n_pages, page_size,
    K, D); block_tables (B, n_max) int32 page ids, clamped into range;
    lengths (B,) int32 masks each row's ragged tail.  Returns (B,H,D)."""
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged_decode_attention: bad shapes q{tuple(q.shape)} "
            f"pages{tuple(k_pages.shape)} {tuple(v_pages.shape)}")
    B, H, D = q.shape
    P, ps, K = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    if k_pages.shape[3] != D or K < 1 or H % K or block_tables.ndim != 2 \
            or block_tables.shape[0] != B:
        raise ValueError(
            f"paged_decode_attention: q{tuple(q.shape)} does not match "
            f"pages{tuple(k_pages.shape)} / tables{tuple(block_tables.shape)}")
    dev = _check("paged_decode_attention",
                 {"q": q, "k_pages": k_pages, "v_pages": v_pages})
    _lengths_ok("paged_decode_attention", lengths, B, dev)
    if block_tables.dtype != torch.int32 or block_tables.device != dev:
        raise ValueError("paged_decode_attention: block_tables must be "
                         f"int32 on {dev}")
    if dev.type == "cpu":
        return ref.paged_decode_attention_ref(q, k_pages, v_pages,
                                              block_tables, lengths,
                                              softcap=softcap)
    _cuda_ready("paged_decode_attention",
                {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                 "block_tables": block_tables, "lengths": lengths}, D)
    from repro_torch.kernels.build import load

    lib = load("decode_attention")
    o = torch.empty_like(q)
    n_max = block_tables.shape[1]
    err = lib.paged_decode_attention_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(), B, H, K,
        D, P, ps, n_max, _DTYPES[q.dtype], float(softcap), _stream(q))
    _raise_on("paged_decode_attention", err)
    LAUNCHES["paged_decode_attention"] += 1
    return o
