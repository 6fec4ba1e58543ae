"""S2M3 core: split-and-share module model, placement, routing.

This package is the paper's contribution:
  module.py    — functional-level modules & model decomposition (§IV-A)
  registry.py  — cross-task module sharing / dedup (§IV-B)
  cluster.py   — device pool + link model (testbed or TPU sub-meshes)
  placement.py — greedy Algorithm 1, brute-force Upper, baselines (§V-B)
  routing.py   — per-request parallel routing + event simulator (§V)
  zoo.py       — the paper's zoo as ModelSpecs, per-task request work,
                 assigned archs as ModelSpecs (``arch_model_spec``)
  profiles.py  — the paper testbed's calibrated devices and speeds
"""

from repro_torch.core.module import ModelSpec, ModuleSpec  # noqa: F401
from repro_torch.core.registry import ModuleRegistry  # noqa: F401
