"""deepseek-v3-671b — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437]."""

from repro_torch.common.config import ArchConfig, register_arch
from repro_torch.configs.tinyllama_1_1b import QUAD_REASON, QUAD_SKIP


def full() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
        d_ff=2048, vocab_size=129280,
        head_dim=128,
        n_experts=256, experts_top_k=8, n_shared_experts=1,
        moe_d_ff=2048, first_dense_layers=3, dense_d_ff=18432,
        router_aux_loss=0.001,
        use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
        qk_rope_dim=64, qk_nope_dim=128, v_head_dim=128,
        mtp_depth=1,
        skip_shapes=QUAD_SKIP, skip_reason=QUAD_REASON,
        # 1.3 TB of bf16 weights cannot replicate over the data axes at
        # serving time: keep FSDP (per-layer all-gather) for all shapes.
        sharding_overrides={
            "prefill": {"embed": ("pod", "data")},
            "decode": {"embed": ("pod", "data")},
        },
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v3-671b", family="moe",
        n_layers=3, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=96, vocab_size=256, head_dim=16,
        n_experts=8, experts_top_k=2, n_shared_experts=1,
        moe_d_ff=96, first_dense_layers=1, dense_d_ff=128,
        router_aux_loss=0.001,
        use_mla=True, q_lora_rank=32, kv_lora_rank=16,
        qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
        mtp_depth=1,
    )


register_arch("deepseek-v3-671b", full, smoke)
