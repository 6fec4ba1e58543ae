"""Where the port runs: the CUDA device unless the caller names another.

``models/`` and ``serving/`` both resolve their default device here, so
a model built with no device lands on the card or raises — it never
drops to the CPU by itself.  The CPU tests pass ``"cpu"`` explicitly.

Resolving a CUDA device also turns off cuBLAS's reduced-precision
reduction for bfloat16 GEMMs (``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction``, on by default), so a bfloat16
product accumulates in float32 throughout, as XLA's bfloat16 dots do in
the reference.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device the port runs on: CUDA unless the caller names another
    (the CPU tests pass ``"cpu"``).  With no CUDA device and no explicit
    choice this raises — the port never drops to the CPU by itself."""
    if device is None and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU")
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    return dev
