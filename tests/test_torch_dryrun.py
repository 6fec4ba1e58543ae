"""The port's dry run (``repro_torch.launch.dryrun``) on small meshes.

* Against the reference's: smoke tinyllama-1.1b, granite-moe-3b-a800m,
  zamba2-7b and xlstm-1.3b at (2, 2) for a train, a prefill and a
  decode cell, tinyllama's train cell at (2, 2, 2), and the recurrent
  families' train cells again at S 64, B 4, each laid out
  here on meta tensors over a fake process group (``lay_out``) and
  lowered and compiled by the reference in a child with eight CPU
  devices and ``jax.sharding.Mesh`` (``tests/torch_mesh_ref.py``'s
  "dryrun" kind, which keeps the arguments a step never reads).
  Argument bytes and dot FLOPs per device equal (the FLOPs of every
  product, forward and backward, as the reference's HLO dots count
  them); both packages' collective totals are written in the assertion
  message (their layouts differ: GSPMD's against DTensor's).  In the
  recurrent families' train cells the products differ by shape in five
  named ways (``train_residue``); there the port's products minus the
  reference's dots, by (output, contracted elements), equal those terms
  exactly, and the FLOPs equal the reference's once they are taken
  out.
* Against real ranks: the same cells laid out on a fake group of two
  equal two gloo ranks on the CPU running the same steps on real
  tensors (``tests/torch_mesh_workers.dryrun_worker``) in FLOPs,
  collectives by kind (count and bytes) and argument bytes; for the
  recurrent families' serving cells the SSD and sLSTM wrappers' reported
  work on meta tensors equals their plain versions' counted ops on the
  CPU.
* Every ``VARIANTS`` name lays out at (2, 2) for tinyllama, on the shape
  kind it changes, and the ``slstm*`` variants for xlstm; zamba2-7b's
  train_4k and xlstm-1.3b's decode_32k production cells lay out; the
  reference's skipped shapes keep its reason; a Mamba2 block whose
  "ssm_inner" and "ssm_heads" resolve to different axes raises.
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
ARCHS = ("tinyllama-1.1b", "granite-moe-3b-a800m", "zamba2-7b", "xlstm-1.3b")
RECURRENT = ("zamba2-7b", "xlstm-1.3b")
REF_CELLS = [dict(arch=a, mesh=[2, 2], shape=list(SHAPES[k]))
             for a in ARCHS for k in SHAPES] + [
    dict(arch="tinyllama-1.1b", mesh=[2, 2, 2], shape=list(SHAPES["train"]))
] + [dict(arch=a, mesh=[2, 2], shape=["t64", "train", 64, 4])
     for a in RECURRENT]
# phase 12 (b)'s rules and options on the chip: granite's serving cells
REAL_CELLS = [dict(arch="tinyllama-1.1b", kind=k) for k in SHAPES] + [
    dict(arch="granite-moe-3b-a800m", kind=k, variant="attnrep")
    for k in ("prefill", "decode")] + [
    dict(arch=a, kind=k) for a in RECURRENT for k in ("prefill", "decode")]


def _id(c):
    seq = c.get("shape", SHAPES["train"])[2]
    return (f"{c['arch'].split('-')[0]}-{c.get('kind') or c['shape'][1]}-"
            f"{'x'.join(map(str, c.get('mesh', [1, 2])))}"
            f"{'' if seq == 32 else f'-s{seq}'}")


def _lay_out(arch, shape, mesh_shape, variant="baseline"):
    axes = ("pod", "data", "model")[-len(mesh_shape):]
    with dryrun.fake_group(int(np.prod(mesh_shape))):
        mesh = local_mesh(tuple(mesh_shape), axes, device="cpu")
        return dryrun.lay_out(get_config(arch, smoke=True),
                              ShapeConfig(*shape), mesh, variant)


def _add(res, key, n):
    res[key] = res.get(key, 0) + n


def train_residue(arch, shape, mesh) -> dict:
    """The port's products minus the reference's HLO dots in a recurrent
    family's smoke train cell, by (output elements, contracted
    elements): {key: port's count - reference's}, from the config and
    the cell (``shape`` the ``SHAPES`` row, ``mesh`` (data, model)).

    (a) The reference's ``lax.scan`` differentiates its whole carry: the
        products that take a gradient into the zero initial state, or
        out of the final state the loss never reads, run there and not
        in the port.  mLSTM, a block: the last chunk's C update (d k,
        d v) and n update (d weights, d k), the first chunk's d C and
        d n; sLSTM: the first step's d h.
    (b) GSPMD splits the weight gradient of Mamba2's model-replicated
        ``wB`` and ``wC`` over "model": d_model / m x N a rank there,
        d_model x N in the port.
    (c) XLA computes the gradient of a three-operand einsum's broadcast
        factor as a dot, torch's autograd as a product and a sum: the
        SSD's two (y from the carried state, the chunk's state), the
        mLSTM's two a chunk (q C, the C update).
    (d) torch's einsum backward runs an outer product as a bmm that
        contracts one element, XLA as a broadcast product: the mLSTM's
        d q of q n and d k of the n update, and two in the intra-chunk
        denominator's, a chunk.
    (e) The port runs the sLSTM's four gate products as one (4 hd
        outputs), the reference as four (equal FLOPs): the recurrence
        twice (the forward and its recomputation), d h and d R a step.
    """
    cfg = get_config(arch, smoke=True)
    S, B = shape[2], shape[3]
    data, m = mesh[-2], mesh[-1]
    Bl = B // data
    res: dict = {}
    if cfg.family == "hybrid":
        n, d, N = cfg.n_layers, cfg.d_model, cfg.ssm_state
        P, L = cfg.mamba_head_dim, cfg.mamba_chunk
        rows = Bl * (S // L) * L * (cfg.mamba_expand * d // P // m)
        _add(res, (d * N, Bl * S), 2 * n)                         # (b)
        _add(res, (d // m * N, Bl * S), -2 * n)
        _add(res, (rows, P), -n)                                  # (c)
        _add(res, (rows, N), -n)
        return res
    groups = cfg.n_layers // (cfg.mlstm_to_slstm + 1)
    n = groups * cfg.mlstm_to_slstm
    H = cfg.n_heads
    hd = int(cfg.mlstm_proj_factor * cfg.d_model) // H
    L = cfg.xlstm_chunk
    nc, bh = S // L, Bl * H // m
    _add(res, (bh * L * hd, hd), -2 * n)                          # (a)
    _add(res, (bh * L, hd), -n)
    _add(res, (bh * L * hd, 1), -n)
    _add(res, (bh * hd * hd, L), -n)
    _add(res, (bh * hd, L), -n)
    _add(res, (bh * L, hd), -2 * nc * n)                          # (c)
    _add(res, (bh * L * hd, 1), 2 * nc * n)                       # (d)
    _add(res, (bh * L * L, 1), 2 * nc * n)
    hs = cfg.d_model // H                                         # (e)
    rows = Bl * H // m * hs
    _add(res, (4 * rows, hs), 2 * S * groups)
    _add(res, (rows, hs), -4 * 2 * S * groups)
    _add(res, (rows, 4 * hs), (S - 1) * groups)                   # (a)
    _add(res, (rows, hs), -4 * S * groups)
    _add(res, (H // m * hs * 4 * hs, Bl), S * groups)
    _add(res, (H // m * hs * hs, Bl), -4 * S * groups)
    return {k: v for k, v in res.items() if v}


def dots_residue(port_rows, ref_rows) -> dict:
    """{(output, contracted elements): port's count - reference's} over
    the keys whose counts differ; each side as [output, contracted,
    times run] rows."""
    got = {(int(a), int(b)): int(n) for a, b, n in port_rows}
    want = {(int(a), int(b)): int(n) for a, b, n in ref_rows}
    return {k: got.get(k, 0) - want.get(k, 0) for k in {*got, *want}
            if got.get(k, 0) != want.get(k, 0)}


def dot_flops(res: dict) -> int:
    return sum(2 * a * b * n for (a, b), n in res.items())


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's children, started here and read by the first test
    that needs them (they compile while the port lays its cells out):
    the attention families' cells and the recurrent ones, side by side,
    each under its cells' indices in ``REF_CELLS``."""
    parts = [[i for i, c in enumerate(REF_CELLS) if
              (c["arch"] in RECURRENT) == rec] for rec in (False, True)]
    procs = [(part, *mref.start(
        "dryrun", [REF_CELLS[i] for i in part],
        tmp_path_factory.mktemp("dryrun_ref"), devices=8)) for part in parts]
    held: dict = {}

    def outputs():
        if not held:
            for part, proc, npz in procs:
                for k, v in mref.finish(proc, npz).items():
                    j, name = k.split("/", 1)
                    held[f"{part[int(j)]}/{name}"] = v
        return held

    yield outputs
    for _, proc, _ in procs:
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
    named = {}
    if c["arch"] in RECURRENT and c["shape"][1] == "train":
        named = train_residue(c["arch"], c["shape"], c["mesh"])
        assert dots_residue(got["cost"]["dots_by_shape"],
                            ref[f"{i}/dots"]) == named, msg
    assert got["cost"]["flops"] - dot_flops(named) == want_flops, msg
    assert got["collectives"]["total_bytes"] > 0, msg
    assert got["model_flops"] > 0 and got["roofline"]["roofline_s"] > 0
    # the cell is built at the reference's default compute, bfloat16, and
    # its roofline charges that dtype's peak
    assert got["roofline"]["peak_dtype"] == "bfloat16"


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


PRODUCTION = (("zamba2-7b", "train_4k"), ("xlstm-1.3b", "decode_32k"))


@pytest.fixture(scope="module")
def production_cells():
    """``PRODUCTION``'s cells at their published sizes on 256 fake ranks,
    each in a child process, both started by the first test that reads
    one (they lay out side by side); a cell's record is read from the
    child's last line."""
    import os
    import pathlib
    import subprocess
    import sys

    src = str(pathlib.Path(__file__).resolve().parents[1] / "src")
    code = ("import json, sys; from repro_torch.launch.dryrun import "
            "run_cell; print(json.dumps(run_cell(sys.argv[1], sys.argv[2], "
            "False)))")
    procs = {cell: subprocess.Popen(
        [sys.executable, "-c", code, *cell], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True,
        env={**os.environ, "PYTHONPATH": src}) for cell in PRODUCTION}
    yield procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.mark.parametrize("arch,shape", PRODUCTION,
                         ids=[f"{a}-{s}" for a, s in PRODUCTION])
def test_recurrent_production_cells_lay_out(production_cells, arch, shape):
    """The recurrent families' cells, written as skipped before their
    mesh path existed, lay out with FLOPs and collective bytes."""
    out, err = production_cells[(arch, shape)].communicate(timeout=300)
    assert production_cells[(arch, shape)].returncode == 0, err[-3000:]
    rec = json.loads(out.strip().splitlines()[-1])
    assert "skipped" not in rec and rec["n_chips"] == 256
    assert rec["cost"]["flops"] > 0 and rec["collectives"]["total_bytes"] > 0
    assert rec["hbm_per_device_gib"] > 0


SLSTM_VARIANTS = sorted(v for v in dryrun.VARIANTS if v.startswith("slstm"))


@pytest.fixture(scope="module")
def slstm_records():
    """The ``slstm*`` variants laid out on smoke xlstm at (2, 2), with the
    cells they should equal: the unroll variants' prefill beside the
    baseline's, ``slstm32dots``'s train cell beside ``dots``'s."""
    out = {}
    with dryrun.fake_group(4):
        mesh = local_mesh((2, 2), device="cpu")
        cfg = get_config("xlstm-1.3b", smoke=True)
        for name in (*SLSTM_VARIANTS, "baseline", "dots"):
            kind = "train" if "dots" in name else "prefill"
            out[name] = dryrun.lay_out(cfg, ShapeConfig(*SHAPES[kind]), mesh,
                                       name)
    return out


@pytest.mark.parametrize("name", SLSTM_VARIANTS)
def test_slstm_variants_lay_out_on_xlstm(slstm_records, name):
    """Each ``slstm*`` variant lays out on xlstm and counts what the cell
    without its unroll counts (the record says the unroll changes
    nothing); ``slstm32shard``'s rules lay R out by "slstm_rec"."""
    rec = slstm_records[name]
    base = slstm_records["dots" if "dots" in name else "baseline"]
    assert rec["cost"]["flops"] == base["cost"]["flops"] > 0
    unroll = dryrun.VARIANTS[name]["cfg"]["slstm_unroll"]
    assert f"slstm_unroll {unroll} " in rec["note"]


def test_mamba2_raises_on_misaligned_inner_and_head_splits():
    """"ssm_inner" split over "model" with "ssm_heads" whole: a rank's
    d_in columns would not be whole heads, so the block raises."""
    import torch

    from repro_torch.models.api import build_model

    with dryrun.fake_group(2):
        mesh = local_mesh((1, 2), device="cpu")
        b = build_model(get_config("zamba2-7b", smoke=True), mesh=mesh,
                        rules={"embed": None, "ssm_heads": None}, compute_dtype=torch.float32)
        params = b.abstract_params(torch.float32)
        cache = b.abstract(b.cache_specs(1, 8, torch.float32), torch.float32)
        with torch.no_grad(), pytest.raises(ValueError, match="same mesh"):
            b.prefill(params, {"tokens": torch.empty(
                (1, 8), dtype=torch.int32, device="meta")}, cache)


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
                        mesh=mesh, compute_dtype=torch.float32)
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
