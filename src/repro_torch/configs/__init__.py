"""Architecture config registry: importing this package registers all
archs the port serves (full and smoke): internvl2-1b, tinyllama-1.1b,
whisper-tiny, xlstm-1.3b and zamba2-7b."""

from repro_torch.configs import (  # noqa: F401
    internvl2_1b,
    tinyllama_1_1b,
    whisper_tiny,
    xlstm_1_3b,
    zamba2_7b,
)
