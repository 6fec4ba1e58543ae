"""tinyllama-1.1b — llama2-arch small [arXiv:2401.02385; hf].

S2M3 note: TinyLlama-1.1B is literally the task-head LLM of the paper's
Flint-v0.5-1B VQA model (Table II) — it is the sharing-demo arch.
"""

from repro_torch.common.config import ArchConfig, register_arch

QUAD_SKIP = ("long_500k",)
QUAD_REASON = "pure full-attention stack: 524k context is quadratic"


def full() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b", family="dense",
        n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
        d_ff=5632, vocab_size=32000, head_dim=64,
        rope_theta=10000.0, act_fn="silu",
        skip_shapes=QUAD_SKIP, skip_reason=QUAD_REASON,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="tinyllama-1.1b", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab_size=256, head_dim=16,
    )


register_arch("tinyllama-1.1b", full, smoke)
