"""gemma2-9b — local+global alternating attention, logit softcaps
[arXiv:2408.00118]."""

from repro_torch.common.config import ArchConfig, register_arch
from repro_torch.configs.tinyllama_1_1b import QUAD_SKIP


def full() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b", family="dense",
        n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
        d_ff=14336, vocab_size=256000, head_dim=256,
        attn_pattern=("local", "global"), sliding_window=4096,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_norm=True, act_fn="gelu_tanh", tie_embeddings=True,
        embed_scale_by_dim=True, rope_theta=10000.0,
        skip_shapes=QUAD_SKIP,
        skip_reason="global layers are full attention: 524k is quadratic",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="gemma2-9b", family="dense",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        attn_pattern=("local", "global"), sliding_window=8,
        attn_logit_softcap=50.0, final_logit_softcap=30.0,
        post_norm=True, act_fn="gelu_tanh", tie_embeddings=True,
        embed_scale_by_dim=True,
    )


register_arch("gemma2-9b", full, smoke)
