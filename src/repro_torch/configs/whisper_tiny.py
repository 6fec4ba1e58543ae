"""whisper-tiny — enc-dec, conv frontend stubbed [arXiv:2212.04356].

``n_layers`` counts decoder blocks; the encoder has its own 4.  Decode
shapes use the assignment's 32k sequence mechanically even though the
real model caps at 448 positions (documented, not silently changed).
S2M3 view: audio-encoder module + text-decoder head module.
"""

from repro_torch.common.config import ArchConfig, register_arch


def full() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny", family="audio",
        n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
        d_ff=1536, vocab_size=51865, head_dim=64,
        is_encoder_decoder=True, n_encoder_layers=4, encoder_seq=1500,
        norm="layernorm", act_fn="gelu", use_rope=False,
        tie_embeddings=True,
        skip_shapes=("long_500k",),
        skip_reason="full-attention decoder: 524k context is quadratic",
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="whisper-tiny", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab_size=256, head_dim=16,
        is_encoder_decoder=True, n_encoder_layers=2, encoder_seq=16,
        norm="layernorm", act_fn="gelu", use_rope=False,
        tie_embeddings=True,
    )


register_arch("whisper-tiny", full, smoke)
