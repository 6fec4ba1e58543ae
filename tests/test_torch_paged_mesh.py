"""Paged decode under a mesh: ``build_model(cfg, mesh=, rules=)``'s
``paged_decode_step`` and ``init_paged_cache`` and
``serving.kvcache.insert_pages`` into the sharded pool, held to the JAX
package's sharded paged step.

The pool is laid out as the reference lays it out (pages over
"cache_batch", each page's slots over "cache_seq", kv heads whole); the
port attends without moving it, with the paged kernel's tile mode on each
rank's tile and the ranks' partial softmaxes combined.  The cases
(``torch_mesh_ref.paged_scenario``): smoke tinyllama-1.1b, gemma2-9b
(window 8, softcap 50) and internvl2-1b (its image prefix) at meshes
(1, 2), (2, 2) and (1, 4) on gloo ranks, pages of 16, four rows (one dead
on the dummy page 0, one crossing a page boundary during the steps, rows
straddling both data halves of the pool, a window that leaves a model
rank no live key of a row); and pages of 6, which a model axis of 4 does
not divide (the reference's ``spec_for`` then keeps the slots whole).
Each case: the live rows prefilled alone and copied into the pool, then 4
paged steps; every logit within 2e-4 of the reference's, greedy tokens
equal, and the pool gathered after each step equal to the reference's
(atol 2e-6: float32 rounding of the projections).  granite-moe-3b-a800m's paged step (a port-only path: the
reference pages dense and vlm only) is held to the port's own unsharded
paged step, at the capacity factor that drops no token.

Also on the CPU: the tile mode's plain version cut into tiles by pages
and by slots and combined equals the untiled one (1e-6), a tile with no
live key gives (0, -inf), the tile wrapper's checks, and
``init_paged_cache`` under a mesh returns DTensors.
"""

import math

import numpy as np
import pytest
import torch

import torch_mesh_ref as mref
import torch_mesh_workers as mw
from torch_mesh_workers import world1  # noqa: F401  (a fixture)
from repro_torch.common import sharding
from repro_torch.common.config import get_config
from repro_torch.kernels import ops, ref
from repro_torch.models.api import build_model

TOL = dict(rtol=2e-4, atol=2e-4)
# the pools hold the k/v projections, which XLA's and torch's float32
# products round apart by up to 1.5e-6 at these sizes (a misplaced write
# is O(1) off)
POOL_TOL = dict(rtol=1e-6, atol=2e-6)
SERVING = {"embed": None}
MESHES = ((1, 2), (2, 2), (1, 4))
ARCHS = ("tinyllama-1.1b", "gemma2-9b", "internvl2-1b")
GRANITE = "granite-moe-3b-a800m"
CASES = [dict(arch=a, mesh=list(m), ps=16, n_pages=12, rules=SERVING)
         for a in ARCHS for m in MESHES]
CASES += [dict(arch=a, mesh=[1, 4], ps=6, n_pages=16, rules=SERVING)
          for a in ("tinyllama-1.1b", "gemma2-9b")]
_NO_DROP = 6 / 2        # the smoke granite's padded experts over top-k
GRANITE_CASES = [dict(arch=GRANITE, mesh=list(m), ps=16, n_pages=12,
                      rules=SERVING, unsharded=True,
                      opts={"moe_capacity_factor": _NO_DROP})
                 for m in ((1, 2), (2, 2))]


def _case_id(c):
    return (f"{c['arch'].split('-')[0]}-{c['mesh'][0]}x{c['mesh'][1]}-"
            f"ps{c['ps']}")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("paged_mesh")
    params = {a: mref.model_params(a) for a in (*ARCHS, GRANITE)}
    ref_out, port = mw.run_cases("paged", mw.paged_worker, CASES, tmp, params)
    # granite has no reference paged step: the port's ranks only
    for shape in sorted({tuple(c["mesh"]) for c in GRANITE_CASES}):
        mine = [(len(CASES) + i, c) for i, c in enumerate(GRANITE_CASES)
                if tuple(c["mesh"]) == shape]
        out = tmp / f"port_granite_{shape[0]}x{shape[1]}.npz"
        mw.spawn(mw.paged_worker, math.prod(shape), tmp, shape, mine, params,
                 str(out))
        port.update(np.load(out))
    return ref_out, port


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_paged_step_on_a_mesh_matches_reference(outputs, i):
    ref_out, port = outputs
    got, want = port[f"{i}/logits"], ref_out[f"{i}/logits"]
    assert got.shape == want.shape == (mref.PAGED_STEPS + 1, 4,
                                       want.shape[-1])
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_pool_after_each_step_matches_reference(outputs, i):
    """The sharded pool gathered after each step equals the reference's:
    the port's tile-local writes (the prefix copy and each step's token)
    land where the reference's scatter puts them, dead rows' on page 0."""
    ref_out, port = outputs
    keys = [k for k in ref_out if k.startswith(f"{i}/pool")]
    assert len(keys) >= mref.PAGED_STEPS * 2
    assert {k for k in port if k.startswith(f"{i}/pool")} == set(keys)
    for k in keys:
        np.testing.assert_allclose(port[k], ref_out[k], err_msg=k,
                                   **POOL_TOL)


@pytest.mark.parametrize("j", range(len(GRANITE_CASES)),
                         ids=[_case_id(c) for c in GRANITE_CASES])
def test_granite_paged_step_on_a_mesh_matches_unsharded(outputs, j):
    _, port = outputs
    i = len(CASES) + j
    got, want = port[f"{i}/logits"], port[f"{i}/plain/logits"]
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    for k in [k for k in port if k.startswith(f"{i}/pool")]:
        np.testing.assert_allclose(
            port[k], port[k.replace(f"{i}/", f"{i}/plain/", 1)], err_msg=k,
            **POOL_TOL)


# ---- the tile mode's plain version ---------------------------------------

def _pool(B=5, H=4, K=2, D=16, P=12, ps=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, H, D, generator=g)
    kp = torch.randn(P, ps, K, D, generator=g)
    vp = torch.randn(P, ps, K, D, generator=g)
    tables = torch.tensor([[1, 5, 7], [2, 3, 11], [0, 0, 0], [6, 8, 9],
                           [10, 4, 0]], dtype=torch.int32)[:B]
    lengths = torch.tensor([20, 37, 0, 48, 24], dtype=torch.int32)[:B]
    return q, kp, vp, tables, lengths


def _combine(parts):
    o = torch.stack([p[0] for p in parts])
    lse = torch.stack([p[1] for p in parts])
    m = lse.amax(0)
    w = torch.exp(lse - torch.where(torch.isfinite(m), m, torch.zeros_like(m)))
    return (w[..., None] * o).sum(0) / w.sum(0).clamp_min(1e-30)[..., None]


@pytest.mark.parametrize("n_page_tiles,n_slot_tiles",
                         [(1, 2), (2, 2), (1, 4), (3, 4), (2, 1)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (8, 50.0)])
def test_tiles_combine_to_the_untiled_plain_version(n_page_tiles,
                                                    n_slot_tiles, window,
                                                    softcap):
    q, kp, vp, tables, lengths = _pool()
    P, ps = kp.shape[:2]
    Pl, sl = P // n_page_tiles, ps // n_slot_tiles
    parts = []
    for i in range(n_page_tiles):
        for j in range(n_slot_tiles):
            tile = (i * Pl, P, j * sl, ps)
            kt = kp[i * Pl:(i + 1) * Pl, j * sl:(j + 1) * sl].contiguous()
            vt = vp[i * Pl:(i + 1) * Pl, j * sl:(j + 1) * sl].contiguous()
            parts.append(ops.paged_decode_attention(
                q, kt, vt, tables, lengths, window=window, softcap=softcap,
                tile=tile))
    want = ref.paged_decode_attention_ref(q, kp, vp, tables, lengths,
                                          window=window, softcap=softcap)
    np.testing.assert_allclose(_combine(parts).numpy(), want.numpy(),
                               rtol=1e-6, atol=1e-6)


def test_whole_pool_tile_is_the_paged_function_with_its_lse():
    q, kp, vp, tables, lengths = _pool()
    o, lse = ops.paged_decode_attention(q, kp, vp, tables, lengths,
                                        tile=(0, 12, 0, 16))
    want = ref.paged_decode_attention_ref(q, kp, vp, tables, lengths)
    np.testing.assert_allclose(o.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    assert lse.dtype == torch.float32 and lse.shape == (5, 4)
    # the dead row (length 0) has no key; the others' lse is the log of
    # their softmax denominator
    assert torch.isinf(lse[2]).all() and (lse[2] < 0).all()
    assert torch.isfinite(lse[[0, 1, 3, 4]]).all()


def test_tile_with_no_live_key_gives_zero_and_minus_inf():
    """Row 3 lives on pages 6, 8 and 9 only; a tile of pages 0-5 holds
    none of its keys, and slots 8-15 hold none of row 4's first 8 (its
    window of 8 at length 24 covers slots 0-7 of its second page)."""
    q, kp, vp, tables, lengths = _pool()
    o, lse = ops.paged_decode_attention(
        q, kp[:6].contiguous(), vp[:6].contiguous(), tables, lengths,
        tile=(0, 12, 0, 16))
    assert torch.isneginf(lse[3]).all() and (o[3] == 0).all()
    assert torch.isfinite(lse[0]).all()
    o, lse = ops.paged_decode_attention(
        q, kp[:, 8:].contiguous(), vp[:, 8:].contiguous(), tables, lengths,
        window=8, tile=(0, 12, 8, 16))
    assert torch.isneginf(lse[4]).all() and (o[4] == 0).all()


@pytest.mark.parametrize("tile", [(0, 12, 12, 16), (-1, 12, 0, 16),
                                  (8, 12, 0, 16), (0, 12, -4, 16)],
                         ids=["slots-past-page", "negative-page",
                              "pages-past-pool", "negative-slot"])
def test_tile_outside_its_pool_raises_tile_error(tile):
    q, kp, vp, tables, lengths = _pool()
    kt, vt = kp[:6, :8].contiguous(), vp[:6, :8].contiguous()
    for dev in ("cpu", "meta"):
        args = [t.to(dev) for t in (q, kt, vt, tables, lengths)]
        with pytest.raises(ops.TileError):
            ops.paged_decode_attention(*args, tile=tile)


def test_tile_mode_on_meta_gives_o_and_lse():
    q, kp, vp, tables, lengths = (t.to("meta") for t in _pool())
    o, lse = ops.paged_decode_attention(
        q, kp[:, :8].contiguous(), vp[:, :8].contiguous(), tables, lengths,
        tile=(0, 12, 8, 16))
    assert o.shape == q.shape and o.dtype == q.dtype
    assert lse.shape == (5, 4) and lse.dtype == torch.float32


# ---- the bundle under a (1, 1) mesh ---------------------------------------

def test_init_paged_cache_under_a_mesh_holds_dtensors(world1):
    for arch in ("gemma2-9b", GRANITE):
        b = build_model(get_config(arch, smoke=True), mesh=world1,
                        rules=SERVING, compute_dtype=torch.float32)
        pool = b.init_paged_cache(8, 16, device="cpu", dtype=torch.float32)
        leaves = [t for _, t in mref.leaf_paths(pool)]
        assert leaves and all(sharding.is_dtensor(t) for t in leaves)
        assert all(t.shape[1:3] == (8, 16) for t in leaves)
