"""The port's attention kernels held to the JAX package.

On the CPU each wrapper in ``repro_torch.kernels.ops`` takes its plain
version, so these tests hold the plain versions (and the wrappers'
CPU path) against the Pallas kernels in interpret mode and against
``repro.kernels.ref``, on the shapes of ``tests/test_kernels.py`` plus
a ragged S and the odd GQA group G = 7 of internvl2-1b.  Inputs come
from numpy with a seed.  Tolerance: float32 2e-4 (summation order).

The CUDA kernels themselves run only on a card; their tests are in
``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as _jref
from repro_torch.kernels import ops, ref

TOL = dict(rtol=2e-4, atol=2e-4)


class jref:
    """The JAX oracles, jitted: one compile per shape instead of one
    per primitive keeps this file's CPU time down."""

    flash_attention_ref = staticmethod(jax.jit(
        _jref.flash_attention_ref,
        static_argnames=("causal", "window", "softcap")))
    decode_attention_ref = staticmethod(jax.jit(
        _jref.decode_attention_ref, static_argnames=("softcap",)))
    paged_decode_attention_ref = staticmethod(jax.jit(
        _jref.paged_decode_attention_ref, static_argnames=("softcap",)))


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(*arrays):
    return ([jnp.asarray(a) for a in arrays],
            [torch.from_numpy(a) for a in arrays])


@pytest.mark.parametrize("B,S,H,K,D,bq,bk", [
    (1, 32, 2, 2, 16, 16, 16),
    (2, 64, 4, 2, 32, 16, 32),     # GQA 2:1
    (1, 128, 8, 1, 16, 32, 32),    # MQA
    (2, 64, 4, 4, 64, 64, 16),     # MHA, tall blocks
    (1, 37, 14, 2, 16, 256, 256),  # ragged S, G = 7 (one Pallas block)
])
def test_flash_plain_matches_pallas_and_ref(B, S, H, K, D, bq, bk):
    rng = np.random.default_rng(S * 10 + H)
    (jq, jk, jv), (tq, tk, tv) = _both(_rand(rng, B, S, H, D),
                                       _rand(rng, B, S, K, D),
                                       _rand(rng, B, S, K, D))
    out = ops.flash_attention(tq, tk, tv).numpy()
    pallas = jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bk,
                                  interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(jref.flash_attention_ref(
        jq, jk, jv)), **TOL)


@pytest.mark.parametrize("causal,window,softcap,S", [
    (True, 0, 0.0, 64), (False, 0, 0.0, 64), (True, 16, 0.0, 64),
    (True, 8, 50.0, 64), (True, 5, 30.0, 29),
])
def test_flash_plain_variants(causal, window, softcap, S):
    rng = np.random.default_rng(1)
    (jq, jk, jv), (tq, tk, tv) = _both(_rand(rng, 2, S, 2, 16),
                                       _rand(rng, 2, S, 2, 16),
                                       _rand(rng, 2, S, 2, 16))
    kw = dict(causal=causal, window=window, softcap=softcap)
    out = ref.flash_attention_ref(tq, tk, tv, **kw).numpy()
    bq = 16 if S % 16 == 0 else S
    pallas = jops.flash_attention(jq, jk, jv, block_q=bq, block_k=bq,
                                  interpret=True, **kw)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(jref.flash_attention_ref(
        jq, jk, jv, **kw)), **TOL)


def test_flash_plain_fully_masked_rows_give_zero():
    """S > T with a window: rows whose window holds no key give 0, as
    the streaming kernel's guard does."""
    rng = np.random.default_rng(2)
    (jq, jk, jv), (tq, tk, tv) = _both(_rand(rng, 1, 24, 2, 16),
                                       _rand(rng, 1, 8, 1, 16),
                                       _rand(rng, 1, 8, 1, 16))
    out = ref.flash_attention_ref(tq, tk, tv, window=4).numpy()
    np.testing.assert_allclose(out, np.asarray(jref.flash_attention_ref(
        jq, jk, jv, window=4)), **TOL)
    assert np.all(out[:, 12:] == 0.0)


@pytest.mark.parametrize("B,H,K,D,T,lengths,softcap", [
    (2, 4, 2, 16, 64, (1, 64), 0.0),
    (3, 14, 2, 16, 48, (48, 17, 0), 20.0),  # G = 7, softcap, an empty row
])
def test_decode_plain_matches_pallas_and_ref(B, H, K, D, T, lengths, softcap):
    rng = np.random.default_rng(T + B)
    (jq, jk, jv), (tq, tk, tv) = _both(_rand(rng, B, H, D),
                                       _rand(rng, B, T, K, D),
                                       _rand(rng, B, T, K, D))
    lens = np.asarray(lengths, np.int32)
    out = ops.decode_attention(tq, tk, tv, torch.from_numpy(lens),
                               softcap=softcap).numpy()
    pallas = jops.decode_attention(jq, jk, jv, jnp.asarray(lens),
                                   softcap=softcap, block_k=16,
                                   interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(jref.decode_attention_ref(
        jq, jk, jv, jnp.asarray(lens), softcap=softcap)), **TOL)


def _paged(rng, B, T, K, D, ps, garbage):
    """A shuffled page pool holding B contiguous caches; with
    ``garbage`` the unused tail of each table holds out-of-range ids."""
    n_max = -(-T // ps)
    P = B * n_max + 1
    perm = rng.permutation(P - 1) + 1
    tables = perm[:B * n_max].reshape(B, n_max).astype(np.int32)
    kp = _rand(rng, P, ps, K, D)
    vp = _rand(rng, P, ps, K, D)
    if garbage:
        tables[:, n_max // 2:] = rng.integers(-9, P + 9,
                                              (B, n_max - n_max // 2))
    return kp, vp, tables


@pytest.mark.parametrize("B,H,K,D,T,ps,softcap,garbage", [
    (2, 4, 2, 16, 64, 16, 0.0, False),    # GQA 2:1
    (1, 8, 1, 16, 48, 8, 0.0, False),     # MQA, ragged last page
    (2, 4, 4, 32, 64, 16, 30.0, False),   # MHA + logit softcap
    (4, 14, 2, 16, 64, 16, 0.0, True),    # G = 7, garbage table tails
])
def test_paged_plain_matches_pallas_and_ref(B, H, K, D, T, ps, softcap,
                                            garbage):
    rng = np.random.default_rng(B * 100 + H)
    kp, vp, tables = _paged(rng, B, T, K, D, ps, garbage)
    q = _rand(rng, B, H, D)
    # with garbage tails, lengths stay inside the real pages
    hi = (T // ps // 2) * ps if garbage else T
    lens = rng.integers(0, hi + 1, B).astype(np.int32)
    (jq, jkp, jvp), (tq, tkp, tvp) = _both(q, kp, vp)
    out = ops.paged_decode_attention(
        tq, tkp, tvp, torch.from_numpy(tables), torch.from_numpy(lens),
        softcap=softcap).numpy()
    pallas = jops.paged_decode_attention(
        jq, jkp, jvp, jnp.asarray(tables), jnp.asarray(lens),
        softcap=softcap, interpret=True)
    np.testing.assert_allclose(out, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(out, np.asarray(jref.paged_decode_attention_ref(
        jq, jkp, jvp, jnp.asarray(tables), jnp.asarray(lens),
        softcap=softcap)), **TOL)


def test_paged_plain_reads_past_length_garbage_as_masked():
    """Keys past a row's length — including whole pages named by
    out-of-range table entries — do not change the output."""
    rng = np.random.default_rng(9)
    kp, vp, tables = _paged(rng, 2, 64, 2, 16, 16, garbage=False)
    q = torch.from_numpy(_rand(rng, 2, 4, 16))
    lens = torch.tensor([20, 33], dtype=torch.int32)
    base = ref.paged_decode_attention_ref(
        q, torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(tables), lens)
    t2 = tables.copy()
    t2[:, 3] = [10_000, -3]
    kp2 = kp.copy()
    kp2[tables[:, 3]] = 1e6
    moved = ref.paged_decode_attention_ref(
        q, torch.from_numpy(kp2), torch.from_numpy(vp),
        torch.from_numpy(t2), lens)
    torch.testing.assert_close(moved, base, rtol=0, atol=0)


def test_wrappers_take_plain_version_on_cpu_without_counting():
    rng = np.random.default_rng(3)
    q = torch.from_numpy(_rand(rng, 1, 8, 4, 16))
    k = torch.from_numpy(_rand(rng, 1, 8, 2, 16))
    before = dict(ops.LAUNCHES)
    shapes = {name: dict(c) for name, c in ops.SHAPE_LAUNCHES.items()}
    out = ops.flash_attention(q, k, k)
    torch.testing.assert_close(out, ref.flash_attention_ref(q, k, k),
                               rtol=0, atol=0)
    assert ops.LAUNCHES == before
    assert ops.SHAPE_LAUNCHES == shapes


@pytest.mark.parametrize("bad", ["dtype", "lengths", "heads", "device"])
def test_wrappers_reject_bad_inputs(bad):
    q = torch.zeros(2, 4, 16)
    k = torch.zeros(2, 8, 2, 16)
    lens = torch.ones(2, dtype=torch.int32)
    if bad == "dtype":
        args = (q.double(), k.double(), k.double(), lens)
    elif bad == "lengths":
        args = (q, k, k, lens.long())
    elif bad == "heads":
        args = (torch.zeros(2, 5, 16), k, k, lens)
    else:
        args = (q.to("meta"), k, k, lens)
    with pytest.raises((ValueError, TypeError)):
        ops.decode_attention(*args)


@pytest.mark.parametrize("kw", [dict(), dict(window=50, softcap=30.0),
                                dict(causal=False)],
                         ids=["causal", "window-softcap", "full"])
def test_flash_float64_reference_and_bf16_flips(kw):
    """``ref.flash_attention_ref(..., dtype=torch.float64)`` is the exact
    attention that ``chip_smoke.py`` reads a bfloat16 flash output's flips
    against (``ref.flips``: outputs that differ from it rounded to bf16):
    on float32 inputs it is the reference's function (2e-4).  At
    internvl2-1b's prefill (S = 267, H = 14, K = 2, D = 64) the bf16
    wrapper's CPU path, the plain version's float32 math, flips few
    outputs (under 0.1 %), and a single bf16 P, which the kernel must
    not keep, flips more than ``FLIPS_MULTIPLE`` = 3 times as many: the
    limit tells the two apart."""
    rng = np.random.default_rng(27)
    (jq, jk, jv), (tq, tk, tv) = _both(_rand(rng, 1, 40, 4, 16),
                                       _rand(rng, 1, 40, 2, 16),
                                       _rand(rng, 1, 40, 2, 16))
    exact32 = ref.flash_attention_ref(tq, tk, tv, dtype=torch.float64, **kw)
    assert exact32.dtype == torch.float32
    np.testing.assert_allclose(exact32.numpy(), np.asarray(
        jref.flash_attention_ref(jq, jk, jv, **kw)), **TOL)

    S, H, K, D = 267, 14, 2, 64
    q, k, v = (torch.from_numpy(_rand(rng, 1, S, n, D)).bfloat16()
               for n in (H, K, K))
    exact = ref.flash_attention_ref(q, k, v, dtype=torch.float64, **kw)
    plain = ref.flips(ops.flash_attention(q, k, v, **kw), exact)
    assert 0.0 < plain < 1e-3
    # P rounded to bf16 before P.V, the rest in float32
    kk, vv = (x.float().repeat_interleave(H // K, dim=2) for x in (k, v))
    s = torch.einsum("bshd,bthd->bhst", q.float(), kk) / D ** 0.5
    if kw.get("softcap"):
        s = kw["softcap"] * torch.tanh(s / kw["softcap"])
    i, j = torch.arange(S)[:, None], torch.arange(S)[None]
    hidden = (j > i) if kw.get("causal", True) else torch.zeros(S, S, dtype=torch.bool)
    if kw.get("window"):
        hidden |= j <= i - kw["window"]
    p = torch.softmax(s.masked_fill(hidden, float("-inf")), -1)
    narrow = torch.einsum("bhst,bthd->bshd", p.bfloat16().float(), vv)
    assert ref.flips(narrow.bfloat16(), exact) > 3 * plain
