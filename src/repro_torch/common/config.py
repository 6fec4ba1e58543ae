"""Architecture / shape / run configuration.

``ArchConfig`` is pure data covering all assigned families (dense, MoE,
MLA+MoE, VLM, audio enc-dec, Mamba2 hybrid, xLSTM).  ``models/api.py``
interprets it into concrete stage lists.  Config files in
``repro_torch/configs/`` register instances under their ``--arch`` id.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping


@dataclass(frozen=True)
class Yarn:
    """YaRN's rotary settings, under the names of DeepSeek-V3's published
    ``rope_scaling`` (``layers.rope``)."""
    factor: float
    original_max_position_embeddings: int
    beta_fast: float
    beta_slow: float
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | vlm | audio | hybrid | ssm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // n_heads

    # --- MoE ---
    n_experts: int = 0
    experts_top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (d_ff used if 0)
    first_dense_layers: int = 0      # leading dense blocks (deepseek: 3)
    expert_pad_to: int = 0           # pad expert count for EP divisibility
    router_aux_loss: float = 0.0

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_rope_dim: int = 0
    qk_nope_dim: int = 0
    v_head_dim: int = 0

    # --- DeepSeek-V3's published serving path.  The port's own: the JAX
    # package computes none of it, and the defaults keep its behaviour
    # (the softmax router, every expert held, plain rotary angles) ---
    moe_router: str = "softmax"      # softmax | noaux_tc (sigmoid, groups)
    n_group: int = 0                 # noaux_tc: groups of experts
    topk_group: int = 0              # noaux_tc: groups a token keeps
    routed_scaling_factor: float = 1.0  # noaux_tc: the gates' scale
    experts_held: int = 0            # experts this rank holds (0: all) ...
    experts_offset: int = 0          # ... from this global expert id on
    rope_yarn: Yarn | None = None    # YaRN's rotary angles (layers.rope)

    # --- attention variants ---
    sliding_window: int = 0          # window size for "local" layers
    attn_pattern: tuple[str, ...] = ()   # e.g. ("local", "global") alternation
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    rope_theta: float = 10000.0
    use_rope: bool = True
    sub_quadratic: bool = False      # eligible for long_500k
    dense_d_ff: int = 0              # dense-layer FFN width when != d_ff (deepseek)

    # --- SSM / hybrid ---
    ssm_state: int = 0
    mamba_head_dim: int = 64
    mamba_expand: int = 2
    mamba_conv_width: int = 4
    mamba_chunk: int = 128
    n_mamba_per_super: int = 0       # zamba2: mamba blocks per shared-attn call
    shared_attn_d_ff: int = 0        # zamba2 shared block MLP width

    # --- xLSTM ---
    mlstm_to_slstm: int = 0          # e.g. 7 => groups of 7 mLSTM + 1 sLSTM
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 1.3334
    xlstm_chunk: int = 128
    # unrolling the sLSTM time scan lets XLA CSE the recurrent-weight reads
    # across steps: HBM traffic of R drops by the unroll factor (§Perf)
    slstm_unroll: int = 1

    # --- encoder-decoder (whisper) ---
    is_encoder_decoder: bool = False
    n_encoder_layers: int = 0
    encoder_seq: int = 1500          # precomputed audio frames (frontend stub)

    # --- VLM ---
    has_vision_stub: bool = False
    n_image_tokens: int = 256        # precomputed patch embeddings (stub)
    image_proj: bool = True          # the prefix through img_proj (d x d)

    # --- misc ---
    act_fn: str = "silu"             # silu | gelu | gelu_tanh
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    embed_scale_by_dim: bool = False  # gemma: embeds *= sqrt(d_model)
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    post_norm: bool = False          # gemma2 uses pre+post norms
    mtp_depth: int = 0               # deepseek multi-token-prediction heads

    # --- sharding: per-shape-kind logical rule overrides ---
    sharding_overrides: Mapping[str, Mapping[str, Any]] = field(default_factory=dict)

    # shapes to skip entirely (e.g. long_500k for quadratic attention)
    skip_shapes: tuple[str, ...] = ()
    skip_reason: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    def with_overrides(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    @property
    def q_per_kv(self) -> int:
        return max(1, self.n_heads // max(1, self.n_kv_heads))


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    moment_dtype: str = "float32"    # "bfloat16" for the 405B/671B fit
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    remat: str = "full"              # none | full | dots
    microbatches: int = 1
    z_loss: float = 0.0
    grad_compression: str = "none"   # none | int8
    seed: int = 0


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}
_SMOKE: dict[str, Callable[[], ArchConfig]] = {}


def register_arch(name: str, full: Callable[[], ArchConfig], smoke: Callable[[], ArchConfig]):
    _REGISTRY[name] = full
    _SMOKE[name] = smoke


def get_config(name: str, *, smoke: bool = False) -> ArchConfig:
    import repro_torch.configs  # noqa: F401  (triggers registration)

    table = _SMOKE if smoke else _REGISTRY
    if name not in table:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(table)}")
    return table[name]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
