"""The port's dry run (``repro_torch.launch.dryrun``) on small meshes.

* Against the reference's: smoke tinyllama-1.1b and granite-moe-3b-a800m
  at (2, 2) for a train, a prefill and a decode cell, and tinyllama's
  train cell at (2, 2, 2), each laid out here on meta tensors over a
  fake process group (``lay_out``) and lowered and compiled by the
  reference in a child with eight CPU devices and ``jax.sharding.Mesh``
  (``tests/torch_mesh_ref.py``'s "dryrun" kind).  Argument bytes and
  dot FLOPs per device equal (the FLOPs of every product, forward and
  backward, as the reference's HLO dots count them); both packages'
  collective totals are written in the assertion message (their layouts
  differ: GSPMD's against DTensor's).
* Against real ranks: the same cells laid out on a fake group of two
  equal two gloo ranks on the CPU running the same steps on real
  tensors (``tests/torch_mesh_workers.dryrun_worker``) in FLOPs,
  collectives by kind (count and bytes) and argument bytes.
* Every ``VARIANTS`` name lays out at (2, 2) for tinyllama, on the shape
  kind it changes; hybrid and ssm cells come out skipped with the
  stated reason, and the reference's skipped shapes keep its reason.
* The dry run's helpers: ``batch_specs`` and ``spec_param_bytes`` equal
  the reference's, ``abstract_params`` has the local shapes
  ``shard_tree`` gives, and the ``common/pytree.py`` helpers agree with
  the reference's.
"""

import json

import numpy as np
import pytest

import torch_mesh_ref as mref
import torch_mesh_workers as mw
from repro_torch.common.config import ShapeConfig, get_config
from repro_torch.common.sharding import local_mesh
from repro_torch.launch import dryrun

SHAPES = {"train": ("t", "train", 32, 8), "prefill": ("p", "prefill", 32, 4),
          "decode": ("d", "decode", 32, 4)}
ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m")
REF_CELLS = [dict(arch=a, mesh=[2, 2], shape=list(SHAPES[k]))
             for a in ARCHS for k in SHAPES] + [
    dict(arch="tinyllama-1.1b", mesh=[2, 2, 2], shape=list(SHAPES["train"]))]
# phase 12 (b)'s rules and options on the chip: granite's serving cells
REAL_CELLS = [dict(arch="tinyllama-1.1b", kind=k) for k in SHAPES] + [
    dict(arch="granite-moe-3b-a800m", kind=k, variant="attnrep")
    for k in ("prefill", "decode")]


def _id(c):
    return (f"{c['arch'].split('-')[0]}-{c.get('kind') or c['shape'][1]}-"
            f"{'x'.join(map(str, c.get('mesh', [1, 2])))}")


def _lay_out(arch, shape, mesh_shape, variant="baseline"):
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    with dryrun.fake_group(int(np.prod(mesh_shape))):
        mesh = local_mesh(tuple(mesh_shape), axes, device="cpu")
        return dryrun.lay_out(get_config(arch, smoke=True),
                              ShapeConfig(*shape), mesh, variant)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's child, started here and read by the first test
    that needs it (it compiles while the port lays its cells out)."""
    proc, npz = mref.start("dryrun", REF_CELLS,
                           tmp_path_factory.mktemp("dryrun_ref"), devices=8)
    held: dict = {}

    def outputs():
        if not held:
            held.update(mref.finish(proc, npz))
        return held

    yield outputs
    if proc.poll() is None:
        proc.kill()
        proc.communicate()


@pytest.mark.parametrize("i", range(len(REF_CELLS)),
                         ids=[_id(c) for c in REF_CELLS])
def test_dryrun_matches_reference(reference, i):
    c = REF_CELLS[i]
    got = _lay_out(c["arch"], c["shape"], c["mesh"])
    ref = reference()
    want_arg = int(ref[f"{i}/argument"])
    want_flops = float(ref[f"{i}/flops"])
    msg = (f"collective bytes per device: port "
           f"{got['collectives']['total_bytes']:.0f} "
           f"{got['collectives']['count_by_op']}, reference "
           f"{float(ref[f'{i}/collective_bytes']):.0f}; FLOPs port "
           f"{got['cost']['flops']:.0f}, reference {want_flops:.0f}")
    assert got["memory"]["argument_size_in_bytes"] == want_arg, msg
    assert got["cost"]["flops"] == want_flops, msg
    assert got["collectives"]["total_bytes"] > 0, msg
    assert got["model_flops"] > 0 and got["roofline"]["roofline_s"] > 0


@pytest.fixture(scope="module")
def real_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_real")
    cells = [(i, dict(c, shape=list(SHAPES[c["kind"]])))
             for i, c in enumerate(REAL_CELLS)]
    out = tmp / "real.json"
    mw.spawn(mw.dryrun_worker, 2, tmp, (1, 2), cells, str(out))
    return json.loads(out.read_text())


@pytest.mark.parametrize("i", range(len(REAL_CELLS)),
                         ids=[_id(c) for c in REAL_CELLS])
def test_fake_group_equals_real_gloo_ranks(real_ranks, i):
    c = REAL_CELLS[i]
    got = _lay_out(c["arch"], SHAPES[c["kind"]], (1, 2),
                   c.get("variant", "baseline"))
    real = real_ranks[str(i)]
    assert got["cost"]["flops"] == real["flops"]
    assert got["collectives"]["count_by_op"] == real["count_by_op"]
    assert got["collectives"]["bytes_by_op"] == real["bytes_by_op"]
    assert got["memory"]["argument_size_in_bytes"] == real["argument"]


def _variant_kind(name, v):
    opts = v.get("opts", {})
    if "cache_update" in opts or "decode_attn" in opts or name == "actrep":
        return "decode"
    if v.get("tcfg") or "remat" in opts or "cfg" in v or name == "baseline":
        return "train"
    return "prefill"


@pytest.fixture(scope="module")
def variant_records():
    out = {}
    with dryrun.fake_group(4):
        mesh = local_mesh((2, 2), device="cpu")
        cfg = get_config("tinyllama-1.1b", smoke=True)
        for name, v in dryrun.VARIANTS.items():
            shape = ShapeConfig(*SHAPES[_variant_kind(name, v)])
            out[name] = dryrun.lay_out(cfg, shape, mesh, name)
    return out


@pytest.mark.parametrize("name", sorted(dryrun.VARIANTS))
def test_every_variant_lays_out(variant_records, name):
    rec = variant_records[name]
    assert rec["cost"]["flops"] > 0 and rec["memory"]["total_bytes"] > 0


@pytest.mark.parametrize("arch,shape,reason", [
    ("zamba2-7b", "train_4k", "no mesh path in the port for family 'hybrid'"),
    ("xlstm-1.3b", "decode_32k", "no mesh path in the port for family 'ssm'"),
    ("tinyllama-1.1b", "long_500k", get_config("tinyllama-1.1b").skip_reason),
])
def test_skipped_cells(tmp_path, monkeypatch, arch, shape, reason):
    monkeypatch.setattr(dryrun, "OUT_DIR", tmp_path)
    args = type("Args", (), dict(arch=arch, shape=shape, multi_pod=False,
                                 perf_variant="baseline"))
    dryrun._cell_main(args)
    rec = json.loads((tmp_path / f"{arch}__{shape}__pod16x16.json")
                     .read_text())
    assert rec["skipped"] == reason and reason
    assert rec["n_chips"] == 256 and rec["mesh"] == "pod16x16"


def _dt_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "internvl2-1b",
                                  "whisper-tiny"])
@pytest.mark.parametrize("kind", sorted(SHAPES))
def test_batch_specs_and_param_bytes_match_reference(arch, kind):
    import jax.numpy as jnp

    from repro.common.config import ShapeConfig as RefShape
    from repro.layers.initializers import spec_param_bytes as ref_bytes
    from repro.models.api import build_model as ref_build
    from repro_torch.layers.initializers import spec_param_bytes
    from repro_torch.models.api import build_model

    ref = ref_build(mref.model_cfg(arch))
    got = build_model(get_config(arch, smoke=True))
    want = ref.batch_specs(RefShape(*SHAPES[kind]))
    mine = got.batch_specs(ShapeConfig(*SHAPES[kind]))
    assert sorted(mine) == sorted(want)
    for k in want:
        assert mine[k].shape == want[k].shape and \
            mine[k].axes == want[k].axes, k
        assert _dt_name(mine[k].dtype) == jnp.dtype(want[k].dtype).name, k
    assert spec_param_bytes(got.specs) == ref_bytes(ref.specs)


def test_abstract_params_local_shapes_are_shard_trees():
    import torch

    from repro_torch.common.pytree import tree_leaves
    from repro_torch.common.sharding import shard_tree
    from repro_torch.layers.initializers import init_tree
    from repro_torch.models.api import build_model

    with dryrun.fake_group(4):
        mesh = local_mesh((2, 2), device="cpu")
        b = build_model(get_config("granite-moe-3b-a800m", smoke=True),
                        mesh=mesh)
        meta = b.abstract_params(torch.float32)
        full = shard_tree(init_tree(b.specs, torch.Generator(), device="cpu"),
                          b.specs, b.rules, mesh)
        pairs = list(zip(tree_leaves(meta), tree_leaves(full)))
        assert pairs and all(
            m.to_local().device.type == "meta"
            and m.to_local().shape == f.to_local().shape
            and m.shape == f.shape and m.placements == f.placements
            for m, f in pairs)


def test_pytree_helpers_match_reference():
    import torch

    from repro.common import pytree as ref
    from repro_torch.common import pytree

    tree = {"a": [np.arange(6, dtype=np.float32).reshape(2, 3),
                  np.ones(4, np.int32)], "b": {"c": np.zeros(5, np.float32)}}
    mine = pytree.tree_map(torch.from_numpy, tree)
    assert pytree.param_count(mine) == ref.param_count(tree) == 15
    assert pytree.param_bytes(mine) == ref.param_bytes(tree) == 60
    assert sorted(pytree.tree_paths(mine)) == sorted(ref.tree_paths(tree))
    cast = pytree.cast_tree(mine, torch.bfloat16)
    assert cast["a"][0].dtype == torch.bfloat16
    assert cast["a"][1].dtype == torch.int32
    assert pytree.tree_allclose(mine, cast, rtol=1e-2, atol=1e-2)
    assert not pytree.tree_allclose(mine, {"a": mine["a"]})


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4), ("bfloat16", 3e-2)])
def test_softmax_dtype_matches_reference(dtype, tol):
    """``gqa_scores``'s masked softmax in ``softmax_dtype`` (the
    ``bf16sm`` variant's option), causal GQA with a window, against the
    reference's at the tolerances of ``tests/test_kernels.py``."""
    import jax.numpy as jnp
    import torch

    from repro.layers.attention import gqa_scores as ref_scores
    from repro_torch.layers.attention import gqa_scores

    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 6, 4, 8)).astype(np.float32)
    k, v = (rng.standard_normal((2, 6, 2, 8)).astype(np.float32)
            for _ in range(2))
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6))
    want = np.asarray(ref_scores(q, k, v, q_positions=pos, kv_positions=pos,
                                 window=4, softmax_dtype=getattr(jnp, dtype)))
    t = torch.from_numpy
    got = gqa_scores(t(q), t(k), t(v), q_positions=t(pos.copy()),
                     kv_positions=t(pos.copy()), window=4,
                     softmax_dtype=getattr(torch, dtype))
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
