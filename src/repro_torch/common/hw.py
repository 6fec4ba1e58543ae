"""The NVIDIA H100 SXM's figures that the port's planners and bounds use.

These are published figures, not measurements: NVIDIA's H100 datasheet
(dense peaks; the sparse tensor-core peaks are twice the dense), the
CUDA programming guide's limits for compute capability 9.0, and NVIDIA's
DGX H100 datasheet for the node (eight GPUs on NVLink, one 400 Gb/s
ConnectX-7 InfiniBand port a GPU for the cluster network).  The
kernels' planners (``kernels.ops``) size their tiles against the
shared-memory and register figures; ``analysis.kernel_check`` and
``chip_smoke.py`` compute each kernel's bound from the peaks.  The
simulator's edge devices carry their own figures (``core.profiles``).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_f32: float      # FLOP/s, dense, the FMA units (no TF32)
    peak_flops_bf16: float     # FLOP/s, dense, the tensor cores
    hbm_bandwidth: float       # bytes/s
    hbm_bytes: float           # device memory
    sms: int                   # streaming multiprocessors
    smem_block: int            # dynamic shared memory a block may opt in to
    smem_sm: int               # shared memory an SM holds
    smem_reserved: int         # of it, reserved by the system a block
    registers_sm: int          # 32-bit registers an SM
    max_cluster: int           # blocks a cluster (non-portable size)
    max_grid: tuple            # grid extents x, y, z
    link_bandwidth: float      # bytes/s a link (NVLink 4, one direction)
    links: int                 # NVLink links a card
    gpus_per_node: int         # cards a node joins by NVLink
    nic_bandwidth: float       # bytes/s of the network a card, one direction


H100_SXM = ChipSpec(
    name="h100_sxm",
    peak_flops_f32=67e12,
    peak_flops_bf16=989e12,
    hbm_bandwidth=3.35e12,
    hbm_bytes=80e9,
    sms=132,
    smem_block=232_448,        # 227 KiB
    smem_sm=233_472,           # 228 KiB
    smem_reserved=1_024,
    registers_sm=65_536,
    max_cluster=16,
    max_grid=(2**31 - 1, 65_535, 65_535),
    link_bandwidth=25e9,       # 18 links, 450 GB/s a direction in all
    links=18,
    gpus_per_node=8,           # a DGX H100 / HGX H100 8-GPU node
    nic_bandwidth=50e9,        # one 400 Gb/s NDR InfiniBand NIC a GPU
)

#: the card the pod model (``core.pod``) assumes
DEFAULT_CHIP = H100_SXM

#: peak FLOP/s by the inputs' dtype name: bf16 counts at the tensor-core
#: rate, float32 at the FMA rate (the kernels hold f32 to 2e-4, which
#: TF32 products do not meet)
PEAK_FLOPS = {"float32": H100_SXM.peak_flops_f32,
              "bfloat16": H100_SXM.peak_flops_bf16}


def bound_s(nbytes: float, flops: float,
            dtype: str = "float32") -> tuple[float, str]:
    """The least time the card could take for work that moves ``nbytes``
    (each input read once, each output written once) and does ``flops``
    on ``dtype`` inputs: the larger of the two times, and which one
    (``"bytes"`` or ``"operations"``) sets it."""
    t_bytes = nbytes / H100_SXM.hbm_bandwidth
    t_ops = flops / PEAK_FLOPS[dtype]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def roofline_terms(flops: float, nbytes: float, collective_bytes: float,
                   dtype: str = "bfloat16", *,
                   inter_node_bytes: float = 0.0) -> dict:
    """The three roofline terms in seconds of one card's share of the
    work, compute at ``dtype``'s peak (recorded as ``peak_dtype``).  Of
    the ``collective_bytes``, the ``inter_node_bytes`` (collectives over
    a group that spans more than one node) are charged against the
    card's InfiniBand NIC, the rest against its aggregate NVLink
    bandwidth (all links, one direction): conservative for
    ring-scheduled collectives."""
    t_comp = flops / PEAK_FLOPS[dtype]
    t_mem = nbytes / H100_SXM.hbm_bandwidth
    t_coll = ((collective_bytes - inter_node_bytes)
              / (H100_SXM.link_bandwidth * H100_SXM.links)
              + inter_node_bytes / H100_SXM.nic_bandwidth)
    dominant = max(
        (("compute", t_comp), ("memory", t_mem), ("collective", t_coll)),
        key=lambda kv: kv[1],
    )[0]
    bound = max(t_comp, t_mem, t_coll)
    return {
        "t_compute_s": t_comp,
        "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "roofline_s": bound,
        "compute_fraction": (t_comp / bound) if bound > 0 else 0.0,
        "peak_dtype": dtype,
    }
