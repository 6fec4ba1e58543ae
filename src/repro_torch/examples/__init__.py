"""Runnable scenarios of the port, each ``python -m repro_torch.examples.<name>``."""
