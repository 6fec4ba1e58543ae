"""granite-moe-3b-a800m — 40 experts top-8
[hf:ibm-granite/granite-3.0 family].

EP note: 40 experts do not divide the 16-way model axis; padded to 48
with zero-initialized never-routed experts.
"""

from repro_torch.common.config import ArchConfig, register_arch
from repro_torch.configs.tinyllama_1_1b import QUAD_REASON, QUAD_SKIP


def full() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=512, vocab_size=49155, head_dim=64,
        n_experts=40, experts_top_k=8, moe_d_ff=512, expert_pad_to=48,
        router_aux_loss=0.01, tie_embeddings=True,
        skip_shapes=QUAD_SKIP, skip_reason=QUAD_REASON,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=64, vocab_size=256, head_dim=16,
        n_experts=5, experts_top_k=2, moe_d_ff=64, expert_pad_to=6,
        router_aux_loss=0.01, tie_embeddings=True,
    )


register_arch("granite-moe-3b-a800m", full, smoke)
