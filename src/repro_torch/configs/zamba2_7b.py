"""zamba2-7b — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

81 mamba blocks; one *weight-shared* attention+MLP block is invoked
after every 6 mamba blocks (13 invocations + 3 tail mamba blocks).  The
real model's per-invocation LoRA deltas and 2x-width concat input are
simplified away (DESIGN.md §4).  Sub-quadratic at decode: SSM state +
windowless attention reads are linear per token.
"""

from repro_torch.common.config import ArchConfig, register_arch


def full() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
        d_ff=14336, vocab_size=32000, head_dim=112,
        ssm_state=64, mamba_head_dim=64, mamba_expand=2,
        mamba_conv_width=4, mamba_chunk=128,
        n_mamba_per_super=6, shared_attn_d_ff=14336,
        sub_quadratic=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b", family="hybrid",
        n_layers=5, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        ssm_state=16, mamba_head_dim=16, mamba_expand=2,
        mamba_conv_width=4, mamba_chunk=8,
        n_mamba_per_super=2, shared_attn_d_ff=128,
        sub_quadratic=True,
    )


register_arch("zamba2-7b", full, smoke)
