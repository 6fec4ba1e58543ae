"""The port's sharded model (``build_model(cfg, mesh=..., rules=...)``,
DTensor weights and caches placed by the logical-axis rules) held to
the JAX package's sharded model: smoke tinyllama-1.1b,
granite-moe-3b-a800m, gemma2-9b (its local/global pairs with the window
and softcaps) and internvl2-1b (its image prefix through the vlm stub),
prefill + 4 greedy decode steps, under the
default rules and the serving rules (``{"embed": None}``), with and
without the reference's ``smattn`` options (``decode_attn="shardmap"``,
``cache_update="shard"``), at meshes (1, 1) in this process and (1, 2),
(2, 2), (1, 4) on gloo ranks.  Logits at float32 rtol = atol = 2e-4,
greedy tokens exact.  Under a mesh granite's MoE runs expert-parallel,
where each data shard has its own capacity, so at (2, 2) its logits are
the reference's sharded ones, not its unsharded ones (0.015 apart).
Also: ``shard_tree``'s local shapes are the reference's first
addressable shard's, and a model with no mesh is the unsharded one.

The reference's sharded outputs come from one child process with four
CPU devices (``tests/torch_mesh_ref.py``), computed while the port's
ranks run (one gloo spawn per mesh shape, ``tests/torch_mesh_workers.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ref as mref
import torch_mesh_workers as mw
from torch_mesh_workers import world1  # noqa: F401  (a fixture)
from repro.common.sharding import local_mesh as ref_local_mesh
from repro.models.api import build_model as ref_build_model
from repro_torch.common import sharding
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import get_config
from repro_torch.models.api import build_model

TOL = dict(rtol=2e-4, atol=2e-4)
ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m", "gemma2-9b",
         "internvl2-1b")
SERVING = {"embed": None}
SMATTN = {"decode_attn": "shardmap", "cache_update": "shard"}
MESHES = ((1, 2), (2, 2), (1, 4))
#: the dense cache's length: the prefill (and a VLM's image prefix) and
#: the 4 steps
T_OF = {"internvl2-1b": 24}
CASES = [dict(arch=a, mesh=list(m), T=T_OF.get(a, 16), steps=4, rules=r,
              opts=o,
              local_shapes=r is None and not o)
         for a in ARCHS for m in MESHES for r in (None, SERVING)
         for o in ({}, SMATTN)]


def _case_id(c):
    return (f"{c['arch'].split('-')[0]}-{c['mesh'][0]}x{c['mesh'][1]}-"
            f"{'serving' if c['rules'] else 'default'}"
            f"{'-smattn' if c['opts'] else ''}")


@pytest.fixture(scope="module")
def outputs(tmp_path_factory):
    params = {a: mref.model_params(a) for a in ARCHS}
    return mw.run_cases("model", mw.model_worker, CASES,
                        tmp_path_factory.mktemp("sharded_model"), params)


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[_case_id(c) for c in CASES])
def test_sharded_model_matches_reference(outputs, i):
    ref, port = outputs
    got, want = port[f"{i}/logits"], ref[f"{i}/logits"]
    assert got.shape == want.shape == (5, 2, want.shape[-1])
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


@pytest.mark.parametrize("i", [i for i, c in enumerate(CASES)
                               if c["local_shapes"]],
                         ids=[_case_id(c) for c in CASES
                              if c["local_shapes"]])
def test_shard_tree_local_shapes_match_reference(outputs, i):
    ref, port = outputs
    want = {k: v for k, v in ref.items() if k.startswith(f"{i}/shape/")}
    got = {k: v for k, v in port.items() if k.startswith(f"{i}/shape/")}
    assert want and set(got) == set(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k


def _ref_run(arch, mesh, rules, opts, steps=4):
    cfg = mref.model_cfg(arch)
    b = ref_build_model(cfg, mesh=mesh, rules=rules,
                        compute_dtype=jnp.float32, **opts)
    params = b.init(jax.random.PRNGKey(0))
    batch, n_img = mref.model_batch(cfg)
    B, S = batch["tokens"].shape
    cache = b.init_cache(B, T_OF.get(arch, 16), jnp.float32)
    prefill, decode = jax.jit(b.prefill), jax.jit(b.decode_step)
    lg, cache = prefill(params, {k: jnp.asarray(v) for k, v in batch.items()},
                        cache)
    out = [np.asarray(lg)]
    lengths = jnp.full((B,), S + n_img, jnp.int32)
    for _ in range(steps):
        tok = jnp.asarray(out[-1].argmax(-1)[:, None].astype(np.int32))
        lg, cache = decode(params, tok, cache, lengths)
        out.append(np.asarray(lg))
        lengths = lengths + 1
    return np.stack(out), jax.tree.map(np.asarray, params)


def _port_run(arch, mesh, rules, opts, params, steps=4):
    cfg = get_config(arch, smoke=True)
    b = build_model(cfg, mesh=mesh, rules=rules, **opts,
                    compute_dtype=torch.float32)
    p = params_from_numpy(params, "cpu")
    if mesh is not None:
        p = sharding.shard_tree(p, b.specs, b.rules, mesh)
    batch, n_img = mref.model_batch(cfg)
    B, S = batch["tokens"].shape
    cache = b.init_cache(B, T_OF.get(arch, 16), device="cpu",
                         dtype=torch.float32)
    full = (lambda t: t.full_tensor()) if mesh is not None else (lambda t: t)
    with torch.no_grad():
        lg, cache = b.prefill(p, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, cache)
        out = [full(lg)]
        lengths = torch.full((B,), S + n_img, dtype=torch.int32)
        for _ in range(steps):
            tok = out[-1].argmax(-1)[:, None].to(torch.int32)
            lg, cache = b.decode_step(p, tok, cache, lengths)
            out.append(full(lg))
            lengths = lengths + 1
    return torch.stack(out).numpy()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rules,opts", [(None, {}), (SERVING, SMATTN)],
                         ids=["default", "serving-smattn"])
def test_mesh_1x1_in_process_matches_reference(world1, arch, rules, opts):
    want, params = _ref_run(arch, ref_local_mesh((1, 1)), rules, opts)
    got = _port_run(arch, world1, rules, opts, params)
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_no_mesh_is_the_unsharded_model(world1):
    """Without a mesh the bundle has none and computes the unsharded
    function (granite's MoE dense, the reference's default there)."""
    arch = "granite-moe-3b-a800m"
    want, params = _ref_run(arch, None, None, {})
    got = _port_run(arch, None, None, {}, params)
    np.testing.assert_allclose(got, want, **TOL)
    b = build_model(get_config(arch, smoke=True), compute_dtype=torch.float32)
    assert b.mesh is None and b.rules == sharding.DEFAULT_RULES


def test_bundle_under_a_mesh_holds_dtensors(world1):
    cfg = get_config("granite-moe-3b-a800m", smoke=True)
    b = build_model(cfg, mesh=world1, rules=SERVING,
                    compute_dtype=torch.float32)
    assert b.mesh is world1 and b.rules["embed"] is None
    params = b.init(torch.Generator().manual_seed(0), device="cpu")
    cache = b.init_cache(1, 8, device="cpu", dtype=torch.float32)
    for leaf in [params["stages"]["moe"]["blocks"]["moe"]["wi_gate"],
                 cache["moe"]["k"]]:
        assert sharding.is_dtensor(leaf)
    # the hybrid family too: its weights and its state caches
    hb = build_model(get_config("zamba2-7b", smoke=True), mesh=world1,
                     compute_dtype=torch.float32)
    hp = hb.init(torch.Generator().manual_seed(0), device="cpu")
    hc = hb.init_cache(1, 8, device="cpu", dtype=torch.float32)
    for leaf in [hp["stages"]["super"]["blocks"]["mamba"]["mamba"]["wz"],
                 hc["super"]["mamba"]["ssm"], hc["super"]["mamba"]["conv_x"],
                 hc["tail"]["ssm"]]:
        assert sharding.is_dtensor(leaf)


def test_whisper_on_a_mesh_matches_reference(world1):
    """The encoder-decoder family under a (1, 1) mesh (every attention
    core per rank, the caches DTensors) against the reference's sharded
    whisper-tiny smoke model: prefill + 2 greedy decode steps."""
    arch = "whisper-tiny"
    cfg_j = mref.model_cfg(arch)
    mesh_j = ref_local_mesh((1, 1))
    bj = ref_build_model(cfg_j, mesh=mesh_j, compute_dtype=jnp.float32)
    jp = bj.init(jax.random.PRNGKey(0))
    tokens = mref.model_tokens(cfg_j, S=4)
    frames = np.random.default_rng(3).standard_normal(
        (2, cfg_j.encoder_seq, cfg_j.d_model)).astype(np.float32)
    B, S = tokens.shape
    cache = bj.init_cache(B, 8, jnp.float32)
    lg, cache = bj.prefill(jp, {"tokens": jnp.asarray(tokens),
                                "audio_frames": jnp.asarray(frames)}, cache)
    want = [np.asarray(lg)]
    for i in range(2):
        tok = jnp.asarray(want[-1].argmax(-1)[:, None].astype(np.int32))
        lg, cache = bj.decode_step(jp, tok, cache,
                                   jnp.full((B,), S + i, jnp.int32))
        want.append(np.asarray(lg))

    b = build_model(get_config(arch, smoke=True), mesh=world1,
                    compute_dtype=torch.float32)
    p = sharding.shard_tree(
        params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"), b.specs,
        b.rules, world1)
    tc = b.init_cache(B, 8, device="cpu", dtype=torch.float32)
    with torch.no_grad():
        lg, tc = b.prefill(p, {"tokens": torch.from_numpy(tokens),
                               "audio_frames": torch.from_numpy(frames)}, tc)
        got = [lg.full_tensor().numpy()]
        for i in range(2):
            tok = torch.from_numpy(got[-1].argmax(-1)[:, None]
                                   .astype(np.int32))
            lg, tc = b.decode_step(p, tok, tc,
                                   torch.full((B,), S + i, dtype=torch.int32))
            got.append(lg.full_tensor().numpy())
    np.testing.assert_allclose(np.stack(got), np.stack(want), **TOL)
    assert b.mesh is world1
