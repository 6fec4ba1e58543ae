"""The benchmark of the port (``src/repro_torch``): see ``run.py``."""
