"""Windowed decode attention, held on the CPU.

The JAX package computes a local (sliding-window) layer's decode step
outside its kernels, with ``repro.layers.attention.gqa_scores`` over the
cache (dense) or the gathered pages (paged).  The port's decode kernels
take the window themselves (``csrc/decode_attention.cu``): a row of
length n sees keys [max(0, n - window), n).  Here the port's plain
versions (the wrappers' CPU path) are held to ``gqa_scores`` with the
same window, the reference's decode-step arguments (query position
n - 1, ``kv_valid`` = key < n), over a contiguous cache and a shuffled
page pool: lengths below, at and above the window, G = 1, 2 and 3,
softcap 0 and 50.  A row of length 0 gives 0 in the port (the kernel's
rule; the reference's fully masked softmax averages every key, and no
caller reads that row), so it is checked apart.  The split-KV rule the
kernels apply on the device is emulated here over the window's span,
and ``ops.decode_splits`` is held to its rule under a window.

Inputs come from numpy with a seed.  Tolerance: float32 2e-4
(summation order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers.attention import gqa_scores
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-4, atol=2e-4)
N_SM = 132  # the H100's streaming multiprocessors
WINDOW = 8
LENGTHS = (0, 1, 5, WINDOW - 1, WINDOW, WINDOW + 1, 20, 32)
GEOMS = [(4, 4), (4, 2), (6, 2)]              # (H, K): G = 1, 2, 3


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _gqa_decode(q, k, v, lens, window, softcap):
    """The reference's decode-step attention: one query at position
    n - 1 over a cache whose keys below n are valid."""
    B, T = k.shape[:2]
    kv_pos = jnp.broadcast_to(jnp.arange(T, dtype=jnp.int32), (B, T))
    lens = jnp.asarray(lens)
    out = gqa_scores(jnp.asarray(q)[:, None], jnp.asarray(k), jnp.asarray(v),
                     q_positions=(lens - 1)[:, None], kv_positions=kv_pos,
                     causal=True, window=window, softcap=softcap,
                     kv_valid=kv_pos < lens[:, None])
    return np.asarray(out[:, 0])


def _hold(out, want, lens):
    live = lens > 0
    np.testing.assert_allclose(out[live], want[live], **TOL)
    assert np.all(out[~live] == 0.0)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("H,K", GEOMS)
def test_windowed_decode_matches_reference(H, K, softcap):
    rng = np.random.default_rng(H * 10 + K)
    B, T, D = len(LENGTHS), 32, 16
    q, k, v = _rand(rng, B, H, D), _rand(rng, B, T, K, D), _rand(rng, B, T, K, D)
    lens = np.asarray(LENGTHS, np.int32)
    out = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), torch.from_numpy(lens),
                               window=WINDOW, softcap=softcap).numpy()
    _hold(out, _gqa_decode(q, k, v, lens, WINDOW, softcap), lens)


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("H,K", GEOMS)
def test_windowed_paged_decode_matches_reference(H, K, softcap):
    """A shuffled pool of pages of 4; entries past each row's pages are
    garbage (some out of range)."""
    rng = np.random.default_rng(100 + H * 10 + K)
    B, D, ps, n_max = len(LENGTHS), 16, 4, 8
    P = B * n_max + 1
    tables = (rng.permutation(P - 1) + 1)[:B * n_max].reshape(B, n_max)
    lens = np.asarray(LENGTHS, np.int32)
    owned = np.arange(n_max)[None] * ps < lens[:, None]
    tables = np.where(owned, tables, rng.integers(-9, P + 9, (B, n_max))
                      ).astype(np.int32)
    q, kp, vp = _rand(rng, B, H, D), _rand(rng, P, ps, K, D), \
        _rand(rng, P, ps, K, D)
    out = ops.paged_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), torch.from_numpy(lens), window=WINDOW,
        softcap=softcap).numpy()
    # the reference's paged local path: gather the row's pages, then
    # gqa_scores with the window (tables clamped, as the kernel reads)
    idx = np.clip(tables, 0, P - 1)
    k = kp[idx].reshape(B, n_max * ps, K, D)
    v = vp[idx].reshape(B, n_max * ps, K, D)
    _hold(out, _gqa_decode(q, k, v, lens, WINDOW, softcap), lens)


def test_window_wider_than_the_cache_is_no_window():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(_rand(rng, *s))
               for s in ((3, 6, 16), (3, 24, 2, 16), (3, 24, 2, 16)))
    lens = torch.tensor([24, 9, 1], dtype=torch.int32)
    torch.testing.assert_close(
        ops.decode_attention(q, k, v, lens, window=24),
        ops.decode_attention(q, k, v, lens), rtol=0, atol=0)


def test_window_is_checked():
    q, k = torch.zeros(1, 2, 16), torch.zeros(1, 4, 2, 16)
    lens = torch.tensor([3], dtype=torch.int32)
    with pytest.raises(ValueError, match="window"):
        ops.decode_attention(q, k, k, lens, window=-1)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q[:, None], k, k, window=-2)


@pytest.mark.parametrize("T,window,B,K,G,want", [
    # gemma2-9b's dense solo decode: a 4,100-token prompt, K = 8, G = 2
    (4128, 4096, 1, 8, 2, 33),
    # its paged tick: 4 rows, tables of 264 pages of 16
    (4224, 4096, 4, 8, 2, 8),
    # a short cache under a long window: the cache's keys bound it
    (64, 4096, 1, 8, 2, 4),
    # a window much shorter than the cache: the window's keys bound it
    (4096, 64, 1, 8, 2, 4),
])
def test_decode_splits_under_a_window(T, window, B, K, G, want):
    """The split count reads min(T, window) live keys: each split keeps
    ``DECODE_MIN_KEYS`` keys of a full window, and no more blocks than
    two an SM."""
    n = ops.decode_splits(T, B, K, G, N_SM, window)
    assert n == want
    live = min(T, window)
    blocks = B * K * -(-G // ops.DECODE_HEADS_PER_BLOCK)
    assert n == max(1, min(2 * N_SM // blocks, live // ops.DECODE_MIN_KEYS,
                           ops.DECODE_MAX_SPLITS))
    assert ops.decode_splits(T, B, K, G, N_SM, 0) == \
        ops.decode_splits(T, B, K, G, N_SM)


@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_split_range_over_the_window_span(n_split):
    """Split i of a row whose live span is [lo, lo + n) covers [lo + a,
    lo + b): the shares tile the span, none reaches below lo."""
    for n_len in list(range(0, 40)) + [4100]:
        lo = max(n_len - WINDOW, 0)
        n = n_len - lo
        ranges = [ops.split_range(n, n_split, i, lo) for i in range(n_split)]
        assert ranges[0][0] == lo and ranges[-1][1] == n_len
        for (_, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2


def _split_state(q_b, kk, vv, G, softcap):
    H, D = q_b.shape
    if kk.shape[0] == 0:
        return (torch.full((H,), ref.NEG_INF), torch.zeros(H),
                torch.zeros(H, D))
    kk = kk.repeat_interleave(G, dim=1)
    vv = vv.repeat_interleave(G, dim=1)
    s = torch.einsum("hd,thd->ht", q_b, kk) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    m = s.max(dim=-1).values
    p = torch.exp(s - m[:, None])
    return m, p.sum(-1), torch.einsum("ht,thd->hd", p, vv)


def _lse_merge(states):
    ms, ls, accs = zip(*states)
    m_all = torch.stack(ms).max(dim=0).values
    w = [torch.where(m > ref.NEG_INF / 2, torch.exp(m - m_all),
                     torch.zeros(())) for m in ms]
    L = sum(wi * li for wi, li in zip(w, ls))
    acc = sum(wi[:, None] * ai for wi, ai in zip(w, accs))
    return torch.where(L[:, None] > 0, acc / L.clamp_min(1e-30)[:, None],
                       torch.zeros(()))


@pytest.mark.parametrize("softcap", [0.0, 50.0])
@pytest.mark.parametrize("H,K", GEOMS)
def test_windowed_split_kv_emulation_matches_plain(H, K, softcap):
    """The kernels' algorithm under a window: each row's span [max(0,
    n - w), min(n, T)) cut into the planner's splits (at least 2 here),
    the partial states merged by log-sum-exp; no key below the span is
    read (a key there set to 1e6 changes nothing)."""
    rng = np.random.default_rng(200 + H)
    B, T, D = len(LENGTHS), 32, 16
    q, k, v = (torch.from_numpy(x) for x in (
        _rand(rng, B, H, D), _rand(rng, B, T, K, D), _rand(rng, B, T, K, D)))
    lens = torch.tensor(LENGTHS, dtype=torch.int32)
    n_split = max(2, ops.decode_splits(T, B, K, H // K, N_SM, WINDOW))
    out = torch.zeros(B, H, D)
    k_poison = k.clone()
    for b in range(B):
        n_len = int(lens[b])
        lo = max(n_len - WINDOW, 0)
        k_poison[b, :lo] = 1e6
        states = []
        for i in range(n_split):
            a, e = ops.split_range(min(n_len, T) - lo, n_split, i, lo)
            states.append(_split_state(q[b], k_poison[b, a:e], v[b, a:e],
                                       H // K, softcap))
        out[b] = _lse_merge(states)
    want = ref.decode_attention_ref(q, k, v, lens, window=WINDOW,
                                    softcap=softcap)
    torch.testing.assert_close(out, want, **TOL)
