"""Weights drawn from the seed on the device, in a few large calls.

A configuration declares its weights as a layout: one entry a leaf,
``(path, shape, std)`` where ``std`` is a float (a normal draw scaled by
it), ``"ones"`` or ``"zeros"``.  ``draw`` fills every normal leaf from
one ``torch.randn`` over their total size, made by a ``torch.Generator``
on ``device`` seeded from the run's seed, and hands out views of that
buffer.  The same (layout, seed) gives the same values on every call:
the program is built from one draw, and the reference, once the
program's state is freed, from another.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of draws of a run's ``seed``
    (any whole number, negative or above 2**32 too)."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF,
             1 if int(seed) < 0 else 0] + [ord(c) for c in stream]
    state = np.random.SeedSequence(words).generate_state(2, np.uint32)
    return int(state[0]) << 31 | int(state[1]) >> 1


def draw(layout, seed: int, device, dtype=torch.float32) -> dict:
    """{path: tensor} for every leaf of ``layout``, in ``dtype``."""
    n_normal = sum(math.prod(shape) for _, shape, std in layout
                   if not isinstance(std, str))
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    flat = torch.randn(n_normal, generator=gen, device=device, dtype=dtype)
    out, at = {}, 0
    for path, shape, std in layout:
        if std == "ones":
            out[path] = torch.ones(shape, device=device, dtype=dtype)
        elif std == "zeros":
            out[path] = torch.zeros(shape, device=device, dtype=dtype)
        else:
            n = math.prod(shape)
            out[path] = flat[at:at + n].view(shape).mul_(float(std))
            at += n
    return out


def nest(flat: dict) -> dict:
    """{("a", "b"): t} -> {"a": {"b": t}}."""
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t
    return tree


def n_params(layout) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout)
