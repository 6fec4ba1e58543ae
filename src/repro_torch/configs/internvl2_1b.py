"""internvl2-1b — InternViT + InternLM2/Qwen2-0.5B backbone
[arXiv:2404.16821].

The vision frontend is a STUB per the assignment: ``input_specs``
provides precomputed patch embeddings.  S2M3 view: vision-encoder module
(stub+projector) + LLM head module — the flagship split/share arch.
"""

from repro_torch.common.config import ArchConfig, register_arch

QUAD_SKIP = ("long_500k",)
QUAD_REASON = "pure full-attention stack: 524k context is quadratic"


def full() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b", family="vlm",
        n_layers=24, d_model=896, n_heads=14, n_kv_heads=2,
        d_ff=4864, vocab_size=151655, head_dim=64,
        rope_theta=1e6, tie_embeddings=True,
        has_vision_stub=True, n_image_tokens=256,
        skip_shapes=QUAD_SKIP, skip_reason=QUAD_REASON,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="internvl2-1b", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
        rope_theta=1e6, tie_embeddings=True,
        has_vision_stub=True, n_image_tokens=8,
    )


register_arch("internvl2-1b", full, smoke)
