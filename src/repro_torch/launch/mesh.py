"""Production mesh definitions on ``torch.distributed``.

Defined as functions (never module-level constants) so importing this
module never touches a process group or a device.  Each rank of a
``torch.distributed.run`` launch (``WORLD_SIZE`` ranks, one card each)
builds the same mesh.
"""

from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False):
    """16x16 = 256 ranks per pod; multi_pod adds a leading 2-pod axis.
    CUDA, over the process group that is up."""
    from repro_torch.common.sharding import local_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return local_mesh(shape, axes)


def mesh_tag(multi_pod: bool) -> str:
    return "multipod2x16x16" if multi_pod else "pod16x16"


def require_devices(n: int):
    import torch.distributed as dist

    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < n:
        raise RuntimeError(
            f"need {n} ranks but the process group has {have}; launch "
            f"{n} processes (torch.distributed.run --nproc_per_node ..., "
            f"WORLD_SIZE={n}) and init the process group before building "
            "the mesh")
