"""The port's recurrent kernels and layers held to the JAX package.

On the CPU the wrappers ``ops.ssd_intra_chunk`` / ``ops.ssd_chunked`` /
``ops.slstm_scan`` take their plain versions, so these tests hold the
plain versions against the Pallas kernels in interpret mode, and the
port's Mamba2, mLSTM and sLSTM layers against the JAX layers (prefill
with a ragged tail, then three decode steps from the prefill's state).
Inputs come from numpy with a seed.  Tolerance: float32 rtol = atol =
2e-4 (``tests/test_kernels.py``'s TOLS; the two sides sum in another
order).  The CUDA kernels themselves run only on a card: their tests
are in ``tests/test_torch_cuda.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import get_config as ref_get_config
from repro.kernels import ops as jops
from repro.kernels.slstm_scan import slstm_scan as jslstm_scan
from repro.kernels.ssd_scan import ssd_intra_chunk as jssd_intra
from repro.layers import mamba2 as jm2
from repro.layers import xlstm as jxl
from repro.layers.initializers import init_tree as jinit_tree
from repro_torch.common.bridge import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.layers import mamba2 as m2
from repro_torch.layers import xlstm as xl

TOL = dict(rtol=2e-4, atol=2e-4)


def _close(t, j, **tol):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), **(tol or TOL))


def _ssd_inputs(rng, B, nc, L, H, P, N):
    f = np.float32
    x = rng.standard_normal((B, nc, L, H, P)).astype(f)
    Bm = (0.5 * rng.standard_normal((B, nc, L, N))).astype(f)
    Cm = (0.5 * rng.standard_normal((B, nc, L, N))).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((B, nc, L, H)))).astype(f)
    A_log = (0.5 * rng.standard_normal(H)).astype(f)
    return x, Bm, Cm, dt, A_log


@pytest.mark.parametrize("B,nc,L,H,P,N", [(2, 2, 8, 4, 16, 16),
                                          (1, 3, 16, 3, 8, 4)])
def test_ssd_intra_chunk_plain_matches_pallas(B, nc, L, H, P, N):
    args = _ssd_inputs(np.random.default_rng(L + H), B, nc, L, H, P, N)
    want = jssd_intra(*map(jnp.asarray, args), interpret=True)
    got = ops.ssd_intra_chunk(*map(torch.from_numpy, args))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w)


@pytest.mark.parametrize("with_state", [False, True])
def test_ssd_chunked_matches_pallas_wrapper(with_state):
    rng = np.random.default_rng(7)
    B, S, H, P, N, chunk = 2, 24, 4, 8, 16, 8
    x, Bm, Cm, dt, A_log = (a.reshape(B, S, *a.shape[3:]) if a.ndim > 1
                            else a for a in _ssd_inputs(rng, B, 1, S, H, P, N))
    init = (rng.standard_normal((B, H, N, P)).astype(np.float32)
            if with_state else None)
    jy, jfin = jops.ssd_chunked(
        *map(jnp.asarray, (x, Bm, Cm, dt, A_log)), chunk=chunk,
        initial_state=None if init is None else jnp.asarray(init),
        interpret=True)
    ty, tfin = ops.ssd_chunked(
        *map(torch.from_numpy, (x, Bm, Cm, dt, A_log)), chunk=chunk,
        initial_state=None if init is None else torch.from_numpy(init))
    _close(ty, jy)
    _close(tfin, jfin)


def test_ssd_chunked_rejects_unpadded_sequence():
    x = torch.zeros(1, 10, 2, 4)
    with pytest.raises(ValueError, match="multiple of the chunk"):
        ops.ssd_chunked(x, torch.zeros(1, 10, 3), torch.zeros(1, 10, 3),
                        torch.zeros(1, 10, 2), torch.zeros(2), chunk=4)


def _slstm_inputs(rng, B, S, H, hd):
    pre = rng.standard_normal((B, S, 4, H * hd)).astype(np.float32)
    R = (0.3 * rng.standard_normal((4, H, hd, hd))).astype(np.float32)
    return pre, R


@pytest.mark.parametrize("B,S,H,hd,block_s", [(2, 16, 4, 8, 8),
                                               (1, 12, 2, 16, 12)])
def test_slstm_scan_plain_matches_pallas(B, S, H, hd, block_s):
    pre, R = _slstm_inputs(np.random.default_rng(S * H), B, S, H, hd)
    want = jslstm_scan(jnp.asarray(pre), jnp.asarray(R), block_s=block_s,
                       interpret=True)
    y, state = ops.slstm_scan(torch.from_numpy(pre), torch.from_numpy(R))
    _close(y, want)
    assert [tuple(t.shape) for t in state] == [(B, H * hd)] * 4


def _slstm_cfg():
    return ref_get_config("xlstm-1.3b", smoke=True)


def _layer_params(specs, seed, **random_leaves):
    """JAX-initialized weights as numpy, with the named (zero/one-
    initialized) leaves replaced by seeded normals so they matter."""
    jp = jax.tree.map(np.asarray, jinit_tree(jax.random.PRNGKey(seed), specs))
    rng = np.random.default_rng(seed)
    for name, scale in random_leaves.items():
        jp[name] = (scale * rng.standard_normal(jp[name].shape)).astype(
            np.float32)
    return jp, params_from_numpy(jp, "cpu")


def test_slstm_scan_state_in_and_out_match_reference_layer():
    """The wrapper's final state after a prefill, and after a continuation
    from that state, equal the reference layer's scan state."""
    cfg = _slstm_cfg()
    jp, tp = _layer_params(jxl.slstm_specs(cfg), 3, b_i=0.5, b_f=0.5)
    rng = np.random.default_rng(3)
    x1 = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    x2 = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    apply = jax.jit(lambda x, s: jxl.slstm_apply(jp, x, cfg, state=s))
    _, jst = apply(jnp.asarray(x1), None)
    _, jst2 = apply(jnp.asarray(x2), jst)

    def pre_of(x):
        xn = xl.apply_norm(tp["ln"], torch.from_numpy(x), cfg.norm,
                           cfg.norm_eps)
        return torch.stack([xn @ tp[f"w_{g}"] + tp[f"b_{g}"]
                            for g in xl.GATES], dim=2)

    R = torch.stack([tp[f"r_{g}"] for g in xl.GATES])
    _, st = ops.slstm_scan(pre_of(x1), R)
    for t, j in zip(st, jst):
        _close(t, j)
    _, st2 = ops.slstm_scan(pre_of(x2), R, state=st)
    for t, j in zip(st2, jst2):
        _close(t, j)


def _prefill_then_decode(jfn, tfn, x, n_decode=3):
    """Prefill x[:, :-n_decode] (fresh state) then decode the last
    n_decode tokens one at a time from the carried state, both sides;
    every output and the final state are compared."""
    S = x.shape[1] - n_decode
    jfn = jax.jit(jfn)  # two compiles (prefill, decode), not one per op
    jy, jst = jfn(jnp.asarray(x[:, :S]), None)
    ty, tst = tfn(torch.from_numpy(x[:, :S]), None)
    _close(ty, jy)
    for t in range(S, x.shape[1]):
        jy, jst = jfn(jnp.asarray(x[:, t:t + 1]), jst)
        ty, tst = tfn(torch.from_numpy(x[:, t:t + 1]), tst)
        _close(ty, jy)

    def leaves(st):  # a mamba state dict, or an (x)LSTM state tuple
        return [st[k] for k in sorted(st)] if isinstance(st, dict) else st

    for t, j in zip(leaves(tst), leaves(jst), strict=True):
        _close(t, j)


def test_mamba2_layer_matches_reference():
    cfg = ref_get_config("zamba2-7b", smoke=True)
    d_in, H, N = jm2.mamba2_dims(cfg)
    jp, tp = _layer_params(jm2.mamba2_specs(cfg), 4, A_log=0.5, dt_bias=0.5,
                           D_skip=1.0)
    # 13 prefill tokens: one full chunk of 8 and a ragged tail of 5
    x = np.random.default_rng(4).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    _prefill_then_decode(
        lambda a, s: jm2.mamba2_apply(jp, a, cfg, state=s),
        lambda a, s: m2.mamba2_apply(tp, a, cfg, state=s), x)


def test_mamba2_chunked_matches_recurrent_in_port():
    """The kernel path (chunked, padded tail) against the port's own
    per-step oracle, with an initial state."""
    rng = np.random.default_rng(5)
    B, S, H, P, N = 2, 21, 3, 8, 4
    x = torch.from_numpy(rng.standard_normal((B, S, H, P)).astype(np.float32))
    Bm, Cm = (torch.from_numpy((0.5 * rng.standard_normal((B, S, N))
                                ).astype(np.float32)) for _ in range(2))
    dt = torch.nn.functional.softplus(torch.from_numpy(
        rng.standard_normal((B, S, H)).astype(np.float32)))
    A_log, D = torch.linspace(-1.0, 0.5, H), torch.ones(H)
    s0 = torch.from_numpy(rng.standard_normal((B, H, N, P)).astype(np.float32))
    y_c, s_c = m2._ssd_chunked(x, Bm, Cm, dt, A_log, D, 8, initial_state=s0)
    y_r, s_r = m2.ssd_recurrent_ref(x, Bm, Cm, dt, A_log, D, initial_state=s0)
    _close(y_c, y_r)
    _close(s_c, s_r)


def test_mlstm_layer_matches_reference():
    cfg = _slstm_cfg()
    jp, tp = _layer_params(jxl.mlstm_specs(cfg), 5, b_i=0.5, b_f=1.0)
    x = np.random.default_rng(6).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    _prefill_then_decode(
        lambda a, s: jxl.mlstm_apply(jp, a, cfg, state=s),
        lambda a, s: xl.mlstm_apply(tp, a, cfg, state=s), x)


def test_slstm_layer_matches_reference():
    cfg = _slstm_cfg()
    jp, tp = _layer_params(jxl.slstm_specs(cfg), 6, b_i=0.5, b_f=0.5)
    x = np.random.default_rng(7).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32)
    _prefill_then_decode(
        lambda a, s: jxl.slstm_apply(jp, a, cfg, state=s),
        lambda a, s: xl.slstm_apply(tp, a, cfg, state=s), x)


def test_slstm_plain_version_is_the_reference_cell():
    """``ref.slstm_scan_ref`` from a given state equals a hand-stepped
    reference cell (``repro.kernels.ref.slstm_cell_ref``'s equations)."""
    from repro.kernels.ref import slstm_cell_ref

    pre, R = _slstm_inputs(np.random.default_rng(8), 2, 9, 2, 8)
    y, _ = ref.slstm_scan_ref(torch.from_numpy(pre), torch.from_numpy(R))
    _close(y, slstm_cell_ref(jnp.asarray(pre), jnp.asarray(R)))
