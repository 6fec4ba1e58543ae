"""Architecture config registry: importing this package registers all
archs the port serves (full and smoke): deepseek-v3-671b, gemma2-9b,
granite-moe-3b-a800m, internvl2-1b, llama3-405b, llama3-8b,
tinyllama-1.1b, whisper-tiny, xlstm-1.3b and zamba2-7b."""

from repro_torch.configs import (  # noqa: F401
    deepseek_v3_671b,
    gemma2_9b,
    granite_moe_3b_a800m,
    internvl2_1b,
    llama3_405b,
    llama3_8b,
    tinyllama_1_1b,
    whisper_tiny,
    xlstm_1_3b,
    zamba2_7b,
)
