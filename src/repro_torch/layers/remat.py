"""Per-layer rematerialisation for the loss, the reference's
``remat_policy`` (``layers/stack.py``) in torch.

``"none"`` keeps every activation for the backward; ``"full"``
recomputes the whole layer in the backward (``torch.utils.checkpoint``,
non-reentrant); ``"dots"`` recomputes it too but keeps the outputs of
its matrix products without batch dimensions (``aten.mm``/``addmm``), as
``dots_with_no_batch_dims_saveable`` keeps XLA's.  The policy changes
memory and time, never the numbers.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts,
)

REMATS = ("none", "full", "dots")

_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_call(remat: str, fn, *args):
    """``fn(*args)`` under the policy ``remat``; without grad mode there
    is nothing to save and it is a plain call."""
    if remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    if remat == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=partial(
                              create_selective_checkpoint_contexts,
                              _dots_policy))
    return checkpoint(fn, *args, use_reentrant=False)
