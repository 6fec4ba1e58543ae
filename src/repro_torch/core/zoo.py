"""Per-task request work multiplicities of the paper's zoo.

Only ``TASK_WORK`` lives here for now: ``core.placement.expected_work``
reads it.  The zoo's ModelSpecs and the assigned-arch adapters arrive
with the CLIP slice of the port.
"""

from __future__ import annotations

# per-task request work multiplicity (retrieval = zero-shot
# classification over ~100 candidate prompts)
TASK_WORK: dict[str, tuple[tuple[str, float], ...]] = {
    "retrieval": (("text", 100.0),),
    "classification": (),
    "vqa-enc": (),
    "vqa-dec": (),
    "alignment": (),
    "captioning": (),
}
