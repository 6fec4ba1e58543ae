"""Architecture config registry: importing this package registers all
archs the port serves (full and smoke): internvl2-1b, xlstm-1.3b and
zamba2-7b."""

from repro_torch.configs import internvl2_1b, xlstm_1_3b, zamba2_7b  # noqa: F401
