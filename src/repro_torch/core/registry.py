"""Module sharing registry (paper §IV-B).

Tracks which modules are deployed and which models reference them; adding
a task only materializes modules not already present.  Total cost drops
from O(|M|·r) (dedicated copies) to O(c·r) with c distinct modules.

At TPU scale the same registry keys the HBM parameter store
(serving/engine.py): one buffer per signature, many models.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.core.module import ModelSpec, ModuleSpec


@dataclass
class _Entry:
    module: ModuleSpec
    refs: set[str] = field(default_factory=set)


class ModuleRegistry:
    def __init__(self):
        self._entries: dict[str, _Entry] = {}
        self._models: dict[str, ModelSpec] = {}

    # -- mutation -----------------------------------------------------------
    def add_model(self, model: ModelSpec) -> list[ModuleSpec]:
        """Register a model; returns the modules that are newly required."""
        if model.name in self._models:
            return []
        self._models[model.name] = model
        new = []
        for m in model.modules:
            e = self._entries.get(m.name)
            if e is None:
                e = self._entries[m.name] = _Entry(m)
                new.append(m)
            elif e.module != m:
                raise ValueError(f"signature collision on {m.name}")
            e.refs.add(model.name)
        return new

    def remove_model(self, name: str) -> list[ModuleSpec]:
        """Deregister; returns modules that became garbage (refcount 0)."""
        model = self._models.pop(name, None)
        if model is None:
            return []
        freed = []
        for m in model.modules:
            e = self._entries[m.name]
            e.refs.discard(name)
            if not e.refs:
                freed.append(m)
                del self._entries[m.name]
        return freed

    # -- queries ------------------------------------------------------------
    @property
    def models(self) -> dict[str, ModelSpec]:
        return dict(self._models)

    @property
    def modules(self) -> dict[str, ModuleSpec]:
        return {k: e.module for k, e in self._entries.items()}

    def refcount(self, module_name: str) -> int:
        e = self._entries.get(module_name)
        return len(e.refs) if e else 0

    def shared_bytes(self) -> int:
        """Deployment cost WITH sharing: one copy per distinct module."""
        return sum(e.module.mem_bytes for e in self._entries.values())

    def dedicated_bytes(self) -> int:
        """Deployment cost WITHOUT sharing: a copy per (model, module)."""
        return sum(m.total_bytes for m in self._models.values())

    def sharing_savings(self) -> float:
        d = self.dedicated_bytes()
        return 0.0 if d == 0 else 1.0 - self.shared_bytes() / d
