"""llama3-8b — GQA, 128k vocab [arXiv:2407.21783]."""

from repro_torch.common.config import ArchConfig, register_arch
from repro_torch.configs.tinyllama_1_1b import QUAD_REASON, QUAD_SKIP


def full() -> ArchConfig:
    return ArchConfig(
        name="llama3-8b", family="dense",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab_size=128256, head_dim=128,
        rope_theta=500000.0, act_fn="silu",
        skip_shapes=QUAD_SKIP, skip_reason=QUAD_REASON,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="llama3-8b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=160, vocab_size=256, head_dim=16, rope_theta=500000.0,
    )


register_arch("llama3-8b", full, smoke)
