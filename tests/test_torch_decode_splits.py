"""The split-KV decode algorithm, held on the CPU.

The decode kernels (``csrc/decode_attention.cu``: ``decode_fwd`` over a
contiguous cache, ``paged_decode_fwd`` over a page pool) cut each row's
keys into ``n_split`` shares, one block each, and merge the blocks'
partial softmax states with log-sum-exp weights.  The kernels run only
on a card; here their host-visible rules are checked:

* the planner ``ops.decode_splits`` and the share rule
  ``ops.split_range`` (the formula the kernels apply on the device),
  also at the paged serve tick's static span n_max * page_size;
* the merge: a torch emulation of the partials (m, l, acc) per split and
  of their merge, against the plain versions ``ref.decode_attention_ref``
  / ``ref.paged_decode_attention_ref`` and the JAX package's Pallas
  ``decode_attention`` / ``paged_decode_attention`` in interpret mode;
  the paged emulation reads a key's page from its row's table (clamped)
  only for keys below the row's length, as the kernel does.

Inputs come from numpy with a seed.  Tolerance: float32 2e-4 (the merge
sums in another order).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-4, atol=2e-4)
N_SM = 132  # the H100's streaming multiprocessors


def _blocks(T, B, K, G, n_sm=N_SM):
    n = ops.decode_splits(T, B, K, G, n_sm)
    return n, n * B * K * -(-G // ops.DECODE_HEADS_PER_BLOCK)


@pytest.mark.parametrize("arch,T,B,K,G,want_splits", [
    ("internvl2-1b solo decode", 304, 1, 2, 7, 19),
    ("zamba2-7b solo decode", 400, 1, 32, 1, 8),
])
def test_planner_fills_the_card_at_the_path_shapes(arch, T, B, K, G,
                                                   want_splits):
    """Both path launches run a few dozen blocks or more (2 and 32 blocks
    without splits), at most two an SM, each split keeping its floor."""
    n, blocks = _blocks(T, B, K, G)
    assert n == want_splits, arch
    assert 32 <= blocks <= 2 * N_SM
    assert T // n >= ops.DECODE_MIN_KEYS


def test_paged_planner_fills_the_card_at_the_serve_tick():
    """internvl2-1b's paged tick: 4 rows, K = 2, G = 7, tables of 32
    pages of 16 (span 512): 32 splits, 256 blocks (8 without splits),
    at most two an SM, 16 keys of a full span a split."""
    span = 32 * 16
    n, blocks = _blocks(span, 4, 2, 7)
    assert (n, blocks) == (32, 256)
    assert blocks <= 2 * N_SM
    assert span // n >= ops.DECODE_MIN_KEYS


@pytest.mark.parametrize("T", [1, 15, 16, 47, 304, 400, 4096, 100_000])
@pytest.mark.parametrize("B,K,G", [(1, 1, 1), (1, 2, 7), (1, 32, 1),
                                   (4, 2, 7), (3, 4, 9), (64, 8, 4)])
def test_planner_bounds(T, B, K, G):
    n, blocks = _blocks(T, B, K, G)
    assert 1 <= n <= ops.DECODE_MAX_SPLITS
    if n > 1:
        assert T // n >= ops.DECODE_MIN_KEYS       # the floor of keys
        assert blocks <= 2 * N_SM                  # no more than it aims for
    # it never splits less than it could: one more split would break
    # the floor, the block target or the cap
    base = blocks // n
    assert (T // (n + 1) < ops.DECODE_MIN_KEYS
            or (n + 1) * base > 2 * N_SM
            or n + 1 > ops.DECODE_MAX_SPLITS)


@pytest.mark.parametrize("n_split", [1, 2, 3, 7, 8, 19, 256])
def test_split_range_covers_every_key_once(n_split):
    for n_keys in list(range(0, 70)) + [303, 304, 399, 4096]:
        ranges = [ops.split_range(n_keys, n_split, i)
                  for i in range(n_split)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n_keys
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2                       # contiguous, no overlap
        sizes = [hi - lo for lo, hi in ranges]
        assert min(sizes) >= 0 and max(sizes) - min(sizes) <= 1
        # a split is empty only when there are fewer keys than splits
        assert min(sizes) > 0 or n_keys < n_split


def _split_state(q_b, kk, vv, G, softcap):
    """One split's partial state (m, l, acc) per q-head over its keys
    kk/vv (t, K, D); the empty state when it has none."""
    H, D = q_b.shape
    if kk.shape[0] == 0:
        return (torch.full((H,), ref.NEG_INF), torch.zeros(H),
                torch.zeros(H, D))
    kk = kk.repeat_interleave(G, dim=1)                  # (t, H, D)
    vv = vv.repeat_interleave(G, dim=1)
    s = torch.einsum("hd,thd->ht", q_b, kk) / math.sqrt(D)
    if softcap > 0:
        s = softcap * torch.tanh(s / softcap)
    m = s.max(dim=-1).values
    p = torch.exp(s - m[:, None])
    return m, p.sum(-1), torch.einsum("ht,thd->hd", p, vv)


def _lse_merge(states):
    """The log-sum-exp merge of the splits' states: a split with no key
    has weight 0, and a row with none gives 0."""
    ms, ls, accs = zip(*states)
    m_all = torch.stack(ms).max(dim=0).values
    w = [torch.where(m > ref.NEG_INF / 2, torch.exp(m - m_all),
                     torch.zeros(())) for m in ms]
    L = sum(wi * li for wi, li in zip(w, ls))
    acc = sum(wi[:, None] * ai for wi, ai in zip(w, accs))
    return torch.where(L[:, None] > 0, acc / L.clamp_min(1e-30)[:, None],
                       torch.zeros(()))


def split_kv_emulation(q, k, v, lengths, n_split, softcap=0.0):
    """The kernel's algorithm in torch: per row and split, the partial
    state (m, l, acc) over the split's keys, then the log-sum-exp merge
    in which a split with no key has weight 0 (and a row with none
    gives 0)."""
    B, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    out = torch.zeros(B, H, D)
    for b in range(B):
        n_keys = min(max(int(lengths[b]), 0), T)
        states = []
        for i in range(n_split):
            lo, hi = ops.split_range(n_keys, n_split, i)
            states.append(_split_state(q[b], k[b, lo:hi], v[b, lo:hi],
                                       H // K, softcap))
        out[b] = _lse_merge(states)
    return out


def paged_split_kv_emulation(q, k_pages, v_pages, tables, lengths, n_split,
                             softcap=0.0):
    """The paged kernel's algorithm: each row's live keys [0, min(length,
    n_max * ps)) cut into n_split shares; key t of a share read from page
    tables[b, t // ps] clamped into [0, P - 1], slot t % ps.  Returns the
    output and the highest table column read per row (None for a row
    that reads none)."""
    B, H, D = q.shape
    P, ps, K = k_pages.shape[:3]
    n_max = tables.shape[1]
    out = torch.zeros(B, H, D)
    read = []
    for b in range(B):
        n_keys = min(max(int(lengths[b]), 0), n_max * ps)
        cols = []
        states = []
        for i in range(n_split):
            lo, hi = ops.split_range(n_keys, n_split, i)
            t = torch.arange(lo, hi)
            cols += (t // ps).tolist()
            page = tables[b, t // ps].long().clamp(0, P - 1)
            states.append(_split_state(q[b], k_pages[page, t % ps],
                                       v_pages[page, t % ps], H // K,
                                       softcap))
        out[b] = _lse_merge(states)
        read.append(max(cols) if cols else None)
    return out, read


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("H,K", [(14, 2), (4, 4)])     # G = 7 and G = 1
@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_merge_matches_plain_and_pallas(n_split, H, K, softcap):
    """Lengths 0, 1, the first split boundary of a full row - 1 and + 1,
    and T, in one batch."""
    T, D = 48, 16
    rng = np.random.default_rng(n_split * 10 + H)
    c = ops.split_range(T, n_split, 1)[0] if n_split > 1 else T // 2
    lens = np.asarray([0, 1, c - 1, c + 1, T], np.int32)
    B = len(lens)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((B, T, K, D)).astype(np.float32)
    v = rng.standard_normal((B, T, K, D)).astype(np.float32)
    tq, tk, tv, tl = (torch.from_numpy(a) for a in (q, k, v, lens))
    got = split_kv_emulation(tq, tk, tv, tl, n_split, softcap)
    np.testing.assert_allclose(
        got.numpy(), ref.decode_attention_ref(tq, tk, tv, tl,
                                              softcap=softcap).numpy(), **TOL)
    pallas = jops.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(lens),
                                   softcap=softcap, block_k=16,
                                   interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    assert np.all(got[0].numpy() == 0.0)          # the row with no key


PS, N_MAX, N_PAGES = 8, 6, 29


def _paged_inputs(rng, lens, H, K, D):
    """A pool of N_PAGES pages of PS; each row's pages random, the table
    entries past them garbage, many out of range (a read of one would
    index out of bounds unclamped)."""
    B = len(lens)
    tables = rng.integers(0, N_PAGES, (B, N_MAX)).astype(np.int32)
    owned = np.arange(N_MAX)[None] * PS < np.asarray(lens)[:, None]
    junk = rng.integers(-40, N_PAGES + 40, (B, N_MAX)).astype(np.int32)
    junk[:, ::2] = np.where(junk[:, ::2] >= 0, junk[:, ::2] + 10_000, -7)
    tables = np.where(owned, tables, junk).astype(np.int32)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    kp = rng.standard_normal((N_PAGES, PS, K, D)).astype(np.float32)
    vp = rng.standard_normal((N_PAGES, PS, K, D)).astype(np.float32)
    return q, kp, vp, tables


@pytest.mark.parametrize("softcap", [0.0, 30.0])
@pytest.mark.parametrize("H,K", [(14, 2), (4, 4)])     # G = 7 and G = 1
@pytest.mark.parametrize("n_split", [1, 3, 8])
def test_paged_merge_matches_plain_and_pallas(n_split, H, K, softcap):
    """Lengths 0, 1, ps - 1, ps, ps + 1, the first split boundary of a
    full span - 1 and + 1, and the full span n_max * ps, in one batch
    over tables with garbage tails; no table entry past a row's pages is
    read."""
    span, D = N_MAX * PS, 16
    rng = np.random.default_rng(n_split * 10 + H + int(softcap))
    c = ops.split_range(span, n_split, 1)[0] if n_split > 1 else span // 2
    lens = np.asarray([0, 1, PS - 1, PS, PS + 1, c - 1, c + 1, span],
                      np.int32)
    q, kp, vp, tables = _paged_inputs(rng, lens, H, K, D)
    tq, tkp, tvp, ttab, tl = (torch.from_numpy(a)
                              for a in (q, kp, vp, tables, lens))
    got, read = paged_split_kv_emulation(tq, tkp, tvp, ttab, tl, n_split,
                                         softcap)
    for n, col in zip(lens, read):
        assert (col is None) == (n == 0)
        assert col is None or col == (n - 1) // PS    # the row's last page
    np.testing.assert_allclose(
        got.numpy(), ref.paged_decode_attention_ref(
            tq, tkp, tvp, ttab, tl, softcap=softcap).numpy(), **TOL)
    pallas = jops.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(tables), jnp.asarray(lens), softcap=softcap,
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **TOL)
    assert np.all(got[0].numpy() == 0.0)          # the row with no key
