"""The port's logical-axis rules (``repro_torch.common.sharding``) held
to the JAX package's, case by case as ``tests/test_sharding.py`` checks
the reference (and with its hypothesis strategy): every spec equals the
reference's ``PartitionSpec`` entry for entry on the same mesh axis
sizes.  Also the DTensor placements of a spec, the row-major index over
a tuple of axes, and the mesh helpers of ``launch/mesh.py``, which
resolve with no process group up or raise naming how to start one.
"""

from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch.distributed as dist
from jax.sharding import Mesh
from torch.distributed.tensor import Replicate, Shard

try:                                  # property tests need hypothesis
    import hypothesis.strategies as st
    from hypothesis import given, settings
except ModuleNotFoundError:           # pragma: no cover - minimal install
    st = None

from repro.common import sharding as ref
from repro.launch import mesh as ref_mesh
from repro_torch.common import sharding
from repro_torch.launch import mesh as port_mesh
from repro_torch.layers.initializers import WSpec

SIZES = {"data": 2, "model": 2}
RULES = sharding.merge_rules(None)


def _ref_mesh(shape=(2, 2), axes=("data", "model")):
    # spec resolution reads mesh.shape only: a repeated-device mesh
    devs = np.asarray([jax.devices()[0]] * int(np.prod(shape)))
    return Mesh(devs.reshape(shape), axes)


def _ref_spec(shape, axes, rules=None, mesh=None):
    spec = ref.spec_for(shape, axes, rules or ref.merge_rules(None),
                        mesh or _ref_mesh())
    return tuple(spec)


def _stand_in(shape, axes, ranks=None):
    """What ``placements_for`` and ``axis_index`` read of a DeviceMesh."""
    ranks = ranks or {}
    return SimpleNamespace(mesh_dim_names=axes, shape=tuple(shape),
                           get_local_rank=lambda a: ranks.get(a, 0))


def test_default_rules_are_the_references():
    assert sharding.DEFAULT_RULES == ref.DEFAULT_RULES


def test_basic_resolution():
    assert sharding.spec_for((8, 16), ("embed", "mlp"), RULES, SIZES) == \
        ("data", "model") == _ref_spec((8, 16), ("embed", "mlp"))


def test_indivisible_dim_demoted():
    assert sharding.spec_for((7, 16), ("embed", "mlp"), RULES, SIZES) == \
        (None, "model") == _ref_spec((7, 16), ("embed", "mlp"))


def test_axis_never_used_twice():
    spec = sharding.spec_for((8, 8), ("mlp", "heads"), RULES, SIZES)
    assert [s for s in spec if s is not None].count("model") <= 1
    assert spec == _ref_spec((8, 8), ("mlp", "heads"))


def test_missing_pod_axis_dropped():
    assert sharding.spec_for((8,), ("batch",), RULES, SIZES) == ("data",) \
        == _ref_spec((8,), ("batch",))


def test_merge_rules_override():
    rules = sharding.merge_rules({"embed": None})
    assert sharding.spec_for((8, 16), ("embed", "mlp"), rules, SIZES) == \
        (None, "model") == _ref_spec((8, 16), ("embed", "mlp"),
                                     ref.merge_rules({"embed": None}))
    assert sharding.DEFAULT_RULES["embed"] == ("pod", "data")


def test_tree_pspecs_over_wspec_tree():
    tree = {"w": WSpec((8, 16), ("embed", "mlp")),
            "b": WSpec((16,), ("norm",))}
    specs = sharding.tree_pspecs(tree, RULES, SIZES)
    assert specs["w"] == ("data", "model")
    assert specs["b"] == (None,)


def test_pod_axes_resolve_as_a_tuple_entry():
    sizes = {"pod": 2, "data": 2, "model": 2}
    mesh = _ref_mesh((2, 2, 2), ("pod", "data", "model"))
    for shape, axes in [((8, 16), ("embed", "mlp")), ((4, 6), ("batch", None)),
                        ((2, 16), ("batch", "vocab"))]:
        assert sharding.spec_for(shape, axes, RULES, sizes) == \
            _ref_spec(shape, axes, mesh=mesh)
    assert sharding.spec_for((8, 16), ("embed", "mlp"), RULES, sizes) == \
        (("pod", "data"), "model")


def test_placements_for_a_spec():
    m = _stand_in((2, 2), ("data", "model"))
    assert sharding.placements_for(("data", "model"), m) == (Shard(0),
                                                            Shard(1))
    assert sharding.placements_for((None, "model"), m) == (Replicate(),
                                                          Shard(1))
    # a tuple entry shards one tensor dim over two mesh dims, pod-major
    m3 = _stand_in((2, 2, 2), ("pod", "data", "model"))
    assert sharding.placements_for((("pod", "data"), "model"), m3) == \
        (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="order"):
        sharding.placements_for((("data", "pod"), None), m3)
    # a mesh dim of one rank never shards
    m1 = _stand_in((1, 2), ("data", "model"))
    assert sharding.placements_for(("data", "model"), m1) == (Replicate(),
                                                             Shard(1))


def test_axis_index_is_row_major_over_a_tuple():
    m = _stand_in((2, 3, 2), ("pod", "data", "model"),
                  ranks={"pod": 1, "data": 2, "model": 1})
    assert sharding.axis_index(m, ("pod", "data")) == 1 * 3 + 2
    assert sharding.axis_index(m, "model") == 1
    assert sharding.axis_index(m, None) == 0
    assert sharding.axis_size(m, ("pod", "data")) == 6


def test_mesh_tags_are_the_references():
    for multi in (False, True):
        assert port_mesh.mesh_tag(multi) == ref_mesh.mesh_tag(multi)


def test_meshes_need_a_process_group():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="torch.distributed.run"):
        sharding.local_mesh((1, 2), device="cpu")
    with pytest.raises(RuntimeError, match="process group"):
        port_mesh.make_production_mesh()
    with pytest.raises(RuntimeError, match="WORLD_SIZE"):
        port_mesh.require_devices(512)
    port_mesh.require_devices(1)


def test_local_mesh_checks_the_world_size(tmp_path):
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="needs 4 ranks"):
            sharding.local_mesh((2, 2), device="cpu")
        mesh = sharding.local_mesh((1, 1), device="cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert sharding.mesh_shape(mesh) == {"data": 1, "model": 1}
    finally:
        dist.destroy_process_group()


if st is not None:
    @settings(max_examples=80, deadline=None)
    @given(
        dims=st.lists(st.integers(1, 64), min_size=1, max_size=4),
        axes=st.lists(st.sampled_from(
            [None, "embed", "mlp", "heads", "batch", "vocab", "experts"]),
            min_size=1, max_size=4),
    )
    def test_spec_always_valid_and_the_references(dims, axes):
        n = min(len(dims), len(axes))
        dims, axes = dims[:n], axes[:n]
        spec = sharding.spec_for(dims, axes, RULES, SIZES)
        assert spec == _ref_spec(dims, axes)
        used = []
        for dim, entry in zip(dims, spec):
            if entry is None:
                continue
            names = entry if isinstance(entry, tuple) else (entry,)
            prod = 1
            for a in names:
                assert a in SIZES
                assert a not in used
                used.append(a)
                prod *= SIZES[a]
            assert dim % prod == 0        # shardability invariant
else:
    @pytest.mark.skip(reason="hypothesis not installed")
    def test_spec_always_valid_and_the_references():
        pass
