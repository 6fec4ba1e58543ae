"""Weight bridge from the JAX package's parameter trees to the port's.

The port keeps the JAX layouts (``wq`` is ``(d, H, hd)``, stacked layer
weights lead with ``n_layers``), so crossing over is a leafwise
numpy -> torch conversion with the nesting unchanged.  Callers hand in
the reference tree already converted to numpy
(``jax.tree.map(np.asarray, params)``); this module never imports jax.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common.pytree import tree_map


def _leaf(x, device, dtype):
    a = np.array(x)      # an owned, writable copy torch may share
    if a.dtype.name == "bfloat16":
        # numpy has no bf16 torch accepts: reinterpret the bits
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device)


def params_from_numpy(tree, device, dtype=None):
    """Same nesting as ``tree`` with every numpy leaf as a torch tensor
    on ``device``; floating leaves are cast to ``dtype`` when given."""
    return tree_map(lambda x: _leaf(x, device, dtype), tree)
