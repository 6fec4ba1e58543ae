"""llama3-405b — GQA, 128k vocab [arXiv:2407.21783]."""

from repro_torch.common.config import ArchConfig, register_arch
from repro_torch.configs.tinyllama_1_1b import QUAD_REASON, QUAD_SKIP


def full() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b", family="dense",
        n_layers=126, d_model=16384, n_heads=128, n_kv_heads=8,
        d_ff=53248, vocab_size=128256, head_dim=128,
        rope_theta=500000.0, act_fn="silu",
        skip_shapes=QUAD_SKIP, skip_reason=QUAD_REASON,
        # 810 GB of bf16 weights cannot replicate over the data axes at
        # serving time: keep FSDP (per-layer all-gather) for all shapes.
        sharding_overrides={
            "prefill": {"embed": ("pod", "data")},
            "decode": {"embed": ("pod", "data")},
        },
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama3-405b", family="dense",
        n_layers=3, d_model=64, n_heads=8, n_kv_heads=2,
        d_ff=192, vocab_size=256, head_dim=8, rope_theta=500000.0,
    )


register_arch("llama3-405b", full, smoke)
