"""The recurrent families under a mesh held to the JAX package's sharded
model: smoke zamba2-7b (hybrid: Mamba2 blocks and a weight-shared
attention block) and xlstm-1.3b (ssm: mLSTM and sLSTM blocks), prefill +
4 greedy decode steps through ``build_model(cfg, mesh=..., rules=...)``.

* At meshes (1, 2), (2, 2) and (1, 4) on gloo ranks
  (``tests/torch_mesh_workers.model_worker``) under the default rules,
  the serving rules (``{"embed": None}``) and, for xlstm, the
  ``slstm32shard`` variant's rules (``{"slstm_rec": "model"}``) and, at
  (1, 2), the production layout of xlstm-1.3b's four sLSTM heads on a
  model axis of 16, heads whole and R's output dim sharded
  (``{"ssm_heads": None, "slstm_rec": "model"}``, where the mLSTM runs
  every head on every rank and keeps its share of d_in), and once with
  an sLSTM FFN whose hidden dim splits over "model" (88, not the smoke
  config's 85): logits against the reference's sharded
  ones (a child with four CPU devices, ``tests/torch_mesh_ref.py``) at
  float32 rtol = atol = 2e-4, greedy tokens exact.  Each block runs on
  its rank's heads (the SSD on H / m heads, the sLSTM kernel's plain
  version on the rank's heads).
* ``shard_tree``'s local shapes equal the reference's first
  addressable shard's (default rules).
* A (1, 1) mesh in this process equals no mesh, which equals the
  reference's unsharded model; the state caches are DTensors.
"""

import numpy as np
import pytest
import torch

import torch_mesh_ref as mref
import torch_mesh_workers as mw
from torch_mesh_workers import world1  # noqa: F401  (a fixture)
from repro_torch.common import sharding
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import get_config
from repro_torch.common.pytree import tree_leaves
from repro_torch.models.api import build_model

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("zamba2-7b", "xlstm-1.3b")
MESHES = ((1, 2), (2, 2), (1, 4))
FFN88 = {"slstm_proj_factor": 1.375}
RULES = {"default": None, "serving": {"embed": None},
         "slstm32shard": {"slstm_rec": "model"},
         "headswhole": {"ssm_heads": None, "slstm_rec": "model"}}
CASES = [dict(arch=a, mesh=list(m), T=16, steps=4, rules=RULES[r], name=r,
              local_shapes=r == "default")
         for a in ARCHS for m in MESHES
         for r in (("default", "serving") if a == "zamba2-7b" else RULES)
         if r != "headswhole" or m == (1, 2)] + [
    # an sLSTM FFN whose hidden dim (88) splits over "model": the FFN runs
    # tensor-parallel, after the output is gathered over the heads
    dict(arch="xlstm-1.3b", mesh=[1, 2], T=16, steps=4, rules=RULES["serving"],
         name="ffn88", cfg=FFN88, params="xlstm-ffn88", local_shapes=False)]


def _case_id(c):
    return f"{c['arch'].split('-')[0]}-{c['mesh'][0]}x{c['mesh'][1]}-{c['name']}"


@pytest.fixture(scope="module")
def params():
    return {**{a: mref.model_params(a) for a in ARCHS},
            "xlstm-ffn88": mref.model_params("xlstm-1.3b", FFN88)}


@pytest.fixture(scope="module")
def outputs(params, tmp_path_factory):
    """The reference's sharded outputs from one child per arch (side by
    side), the port's from one gloo spawn per mesh shape."""
    import math

    tmp = tmp_path_factory.mktemp("recurrent_mesh")
    parts = [[i for i, c in enumerate(CASES) if c["arch"] == a]
             for a in ARCHS]
    children = [(part, *mref.start("model", [CASES[i] for i in part],
                                   tmp_path_factory.mktemp("ref")))
                for part in parts]
    try:
        port = {}
        for shape in MESHES:
            mine = [(i, c) for i, c in enumerate(CASES)
                    if tuple(c["mesh"]) == shape]
            out = tmp / f"port_{shape[0]}x{shape[1]}.npz"
            mw.spawn(mw.model_worker, math.prod(shape), tmp, shape, mine,
                     params, str(out))
            port.update(np.load(out))
    except BaseException:
        for _, proc, _ in children:
            proc.kill()
        raise
    ref = {}
    for part, proc, npz in children:
        for k, v in mref.finish(proc, npz).items():
            j, name = k.split("/", 1)
            ref[f"{part[int(j)]}/{name}"] = v
    return ref, port


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_recurrent_mesh_matches_reference(outputs, i):
    ref, port = outputs
    got, want = port[f"{i}/logits"], ref[f"{i}/logits"]
    assert got.shape == want.shape == (5, 2, want.shape[-1])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


LOCAL = [i for i, c in enumerate(CASES) if c["local_shapes"]]


@pytest.mark.parametrize("i", LOCAL, ids=[_case_id(CASES[i]) for i in LOCAL])
def test_shard_tree_local_shapes_match_reference(outputs, i):
    ref, port = outputs
    want = {k: v for k, v in ref.items() if k.startswith(f"{i}/shape/")}
    got = {k: v for k, v in port.items() if k.startswith(f"{i}/shape/")}
    assert want and set(got) == set(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k


def _port_run(arch, mesh, params, rules=None, T=16, steps=4):
    b = build_model(get_config(arch, smoke=True), mesh=mesh, rules=rules,
                    compute_dtype=torch.float32)
    p = params_from_numpy(params, "cpu")
    if mesh is not None:
        p = sharding.shard_tree(p, b.specs, b.rules, mesh)
    tokens = torch.from_numpy(mref.model_tokens(b.cfg))
    B, S = tokens.shape
    cache = b.init_cache(B, T, device="cpu", dtype=torch.float32)
    full = (lambda t: t.full_tensor()) if mesh is not None else (lambda t: t)
    with torch.no_grad():
        lg, cache = b.prefill(p, {"tokens": tokens}, cache)
        out = [full(lg)]
        lengths = torch.full((B,), S, dtype=torch.int32)
        for _ in range(steps):
            tok = out[-1].argmax(-1)[:, None].to(torch.int32)
            lg, cache = b.decode_step(p, tok, cache, lengths)
            out.append(full(lg))
            lengths = lengths + 1
    return torch.stack(out).numpy(), cache


def _ref_unsharded(arch, params, T=16, steps=4):
    import jax
    import jax.numpy as jnp

    from repro.models.api import build_model as ref_build_model

    b = ref_build_model(mref.model_cfg(arch), compute_dtype=jnp.float32)
    tokens = mref.model_tokens(b.cfg)
    B, S = tokens.shape
    cache = b.init_cache(B, T, jnp.float32)
    p = jax.tree.map(jnp.asarray, params)
    lg, cache = jax.jit(b.prefill)(p, {"tokens": jnp.asarray(tokens)}, cache)
    out = [np.asarray(lg)]
    lengths = jnp.full((B,), S, jnp.int32)
    decode = jax.jit(b.decode_step)
    for _ in range(steps):
        tok = jnp.asarray(out[-1].argmax(-1)[:, None].astype(np.int32))
        lg, cache = decode(p, tok, cache, lengths)
        out.append(np.asarray(lg))
        lengths = lengths + 1
    return np.stack(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_1x1_equals_no_mesh_and_the_reference(world1, params, arch):
    want = _ref_unsharded(arch, params[arch])
    plain, _ = _port_run(arch, None, params[arch])
    got, cache = _port_run(arch, world1, params[arch])
    np.testing.assert_allclose(plain, want, **TOL)
    np.testing.assert_array_equal(got, plain)
    leaves = tree_leaves(cache)
    assert leaves and all(sharding.is_dtensor(t) for t in leaves)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 2e-4, 2e-4), (torch.bfloat16, 1e-3, 2.0**-7)])
def test_cuda_per_rank_kernels_match_plain(cuda_device, dtype, atol, rtol):
    """The kernels at the shapes a rank of zamba2-7b / xlstm-1.3b on a
    (1, 2) mesh gives them: the SSD on 56 of the 112 heads (two chunks of
    128, P = N = 64), the sLSTM prefill and one-step kernels on 2 of the
    4 heads (hd 512), each against its plain version."""
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    B, nc, L, H, P, N = 1, 2, 128, 56, 64, 64
    x = rnd(B, nc, L, H, P).to(dtype)
    Bm, Cm = (0.5 * rnd(B, nc, L, N)).to(dtype), (0.5 * rnd(B, nc, L, N)).to(
        dtype)
    dt = torch.nn.functional.softplus(rnd(B, nc, L, H) - 1.0).to(dtype)
    a_log = 0.5 * rnd(H)
    for got, want in zip(ops.ssd_intra_chunk(x, Bm, Cm, dt, a_log),
                         ref.ssd_intra_chunk_ref(x, Bm, Cm, dt, a_log)):
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    S, H2, hd = 200, 2, 512
    R = 0.02 * rnd(4, H2, hd, hd)
    pre = rnd(1, S, 4, H2 * hd).to(dtype)
    state = (rnd(1, H2 * hd), 1.0 + rnd(1, H2 * hd).abs(),
             rnd(1, H2 * hd).tanh(), rnd(1, H2 * hd))
    for p, st in ((pre, None), (pre[:, :1].contiguous(), state)):
        (y, fin), (y_r, fin_r) = (ops.slstm_scan(p, R, state=st),
                                  ref.slstm_scan_ref(p, R, st))
        torch.testing.assert_close(y.float(), y_r.float(), rtol=rtol,
                                   atol=atol)
        for a, b in zip(fin, fin_r):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)
