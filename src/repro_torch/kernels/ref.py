"""Plain PyTorch versions of the attention kernels.

Each is the function its CUDA kernel computes, written with plain
tensor ops and float32 softmax: the CPU tests run them, the kernel
wrappers in ``kernels.ops`` take them for CPU tensors, and
``chip_smoke.py`` holds each kernel against them on the card.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -2.0e38


def flash_attention_ref(q, k, v, *, causal=True, window=0, softcap=0.0,
                        lengths=None):
    """q: (B,S,H,D); k/v: (B,T,K,D). Plain softmax attention."""
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if G > 1:
        k = k.repeat_interleave(G, dim=2)
        v = v.repeat_interleave(G, dim=2)
    s = torch.einsum("bshd,bthd->bhst", q.float(), k.float()) / math.sqrt(D)
    if softcap and softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(T, device=q.device)[None, :]
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kp <= qp
    if window and window > 0:
        mask &= kp > qp - window
    mask = mask[None, None].expand(B, H, S, T)
    if lengths is not None:
        mask = mask & (kp[None, None] < lengths.to(q.device)[:, None, None, None])
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    # rows with every key masked produce 0 (matches the streaming kernel)
    p = torch.where(mask.any(-1, keepdim=True), p, torch.zeros_like(p))
    return torch.einsum("bhst,bthd->bshd", p, v.float()).to(q.dtype)


def decode_attention_ref(q, k, v, lengths, *, softcap=0.0):
    """q: (B,H,D) single query; k/v: (B,T,K,D); lengths: (B,) valid key
    count (keys at or past it are masked)."""
    out = flash_attention_ref(q[:, None], k, v, causal=False,
                              softcap=softcap, lengths=lengths)
    return out[:, 0]


def paged_decode_attention_ref(q, k_pages, v_pages, block_tables, lengths,
                               *, softcap=0.0):
    """q: (B,H,D); k_pages/v_pages: (n_pages, page_size, K, D);
    block_tables: (B, n_max) page ids; lengths: (B,) valid key counts.

    Gathers each row's pages (table entries clamped into range) into a
    contiguous (B, n_max*ps, K, D) view and defers to
    ``decode_attention_ref``; positions past ``lengths`` are masked.
    """
    B = q.shape[0]
    P, ps, K, D = k_pages.shape
    n_max = block_tables.shape[1]
    tables = block_tables.long().clamp(0, P - 1)
    k = k_pages[tables].reshape(B, n_max * ps, K, D)
    v = v_pages[tables].reshape(B, n_max * ps, K, D)
    return decode_attention_ref(q, k, v, lengths, softcap=softcap)
