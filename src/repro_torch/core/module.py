"""Functional-level modules and model decomposition (paper §IV-A).

A multi-modal model M_k = M_k^enc ∪ {h_k}: a set of modality-wise
encoder modules plus one task head.  ``ModuleSpec.name`` is the sharing
signature: two models containing a module with the same name share one
deployment (same architecture AND parameters — paper Insight 4).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ModuleSpec:
    name: str                     # sharing signature
    kind: str                     # "encoder" | "head"
    modality: str                 # vision | text | audio | task
    n_params: int
    bytes_per_param: float = 2.0  # fp16 deployment
    flops_per_query: float = 0.0  # fallback compute model: flops/speed
    input_bytes: int = 600_000    # request payload routed to this module
    output_bytes: int = 4_096     # embedding forwarded to the head
    # generative (decoder) heads: requests stream tokens through the
    # paged-KV decode substrate instead of a single head call
    generative: bool = False
    # per-token KV-cache footprint summed over layers (bytes); feeds the
    # plan_check page-budget ledger for generative heads
    kv_bytes_per_token: int = 0

    @property
    def mem_bytes(self) -> int:
        return int(self.n_params * self.bytes_per_param)

    def __str__(self) -> str:
        return f"{self.name}[{self.kind}/{self.modality}]"


@dataclass(frozen=True)
class ModelSpec:
    name: str
    task: str
    encoders: tuple[ModuleSpec, ...]
    head: ModuleSpec

    @property
    def modules(self) -> tuple[ModuleSpec, ...]:
        return (*self.encoders, self.head)

    @property
    def n_params(self) -> int:
        return sum(m.n_params for m in self.modules)

    @property
    def max_module_bytes(self) -> int:
        """Worst single-device deployment cost under the split architecture."""
        return max(m.mem_bytes for m in self.modules)

    @property
    def total_bytes(self) -> int:
        """Deployment cost without splitting (centralized)."""
        return sum(m.mem_bytes for m in self.modules)

    @property
    def parallel_degree(self) -> int:
        """Number of encoders that can run concurrently (Insight 2)."""
        return len(self.encoders)


def distinct_modules(models) -> dict[str, ModuleSpec]:
    """The entire module set M = ∪_k M_k, deduplicated by signature."""
    out: dict[str, ModuleSpec] = {}
    for mdl in models:
        for m in mdl.modules:
            prev = out.setdefault(m.name, m)
            if prev != m:
                raise ValueError(
                    f"signature collision: {m.name} declared with different specs")
    return out
