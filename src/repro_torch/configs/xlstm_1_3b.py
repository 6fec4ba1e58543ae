"""xlstm-1.3b — sLSTM + mLSTM blocks, 7:1 ratio [arXiv:2405.04517].

48 blocks = 6 groups of (7 mLSTM + 1 sLSTM).  mLSTM runs chunkwise-
parallel; sLSTM (memory mixing) is a lax.scan over time.  Fully
recurrent state at decode -> runs long_500k.
"""

from repro_torch.common.config import ArchConfig, register_arch


def full() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=50304, head_dim=512,
        mlstm_to_slstm=7, mlstm_proj_factor=2.0, slstm_proj_factor=1.3334,
        xlstm_chunk=128, sub_quadratic=True,
    )


def smoke() -> ArchConfig:
    return ArchConfig(
        name="xlstm-1.3b", family="ssm",
        n_layers=6, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=0, vocab_size=256, head_dim=16,
        mlstm_to_slstm=2, mlstm_proj_factor=2.0, slstm_proj_factor=1.3334,
        xlstm_chunk=8, sub_quadratic=True,
    )


register_arch("xlstm-1.3b", full, smoke)
