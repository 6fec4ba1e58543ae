"""Architecture config registry: importing this package registers all
archs the port serves (internvl2-1b, full and smoke)."""

from repro_torch.configs import internvl2_1b  # noqa: F401
