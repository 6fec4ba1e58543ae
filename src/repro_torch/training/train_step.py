"""Train step builder: loss and gradients, microbatching, AdamW.

The gradients are ``torch.autograd.grad`` of ``bundle.loss_fn`` over
detached aliases of the parameter leaves (the state's own tensors never
require grad, so serving from them needs no ``torch.no_grad()``).  With
``microbatches = k`` the batch splits into k equal slices along its
first dim; the gradients accumulate as ``g / k`` in float32 and the loss
as ``loss / k``, in the reference's order.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import sharding
from repro_torch.common.config import TrainConfig
from repro_torch.common.pytree import tree_leaves, tree_map, tree_unflatten
from repro_torch.training.optimizer import adamw_update

F32 = torch.float32


def batch_to_tensors(batch, device) -> dict:
    """A numpy batch (``training.data.TokenStream``) as tensors on
    ``device``."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def loss_and_grads(bundle, params, batch):
    """(loss, metrics, grads): the loss and metrics detached, grads a
    tree of the params' structure (zeros for a leaf the loss does not
    read)."""
    leaves = [p.detach().requires_grad_(p.is_floating_point())
              for p in tree_leaves(params)]
    # the backward meets the plain tensors the forward saved (masks,
    # positions) as the forward did: replicated under the bundle's mesh
    with torch.enable_grad(), sharding.mesh_scope(bundle.mesh):
        loss, metrics = bundle.loss_fn(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    metrics = {k: torch.as_tensor(v).detach() for k, v in metrics.items()}
    return loss.detach(), metrics, tree_unflatten(params, list(grads))


def microbatch_grads(bundle, params, batch, k: int):
    """(loss, metrics, grads) of ``batch`` split into ``k`` equal slices
    along its first dim: each slice's gradients accumulate as ``g / k``
    in float32 and its loss as ``loss / k`` (the metrics are then the
    loss alone, as in the reference); ``k = 1`` is ``loss_and_grads``."""
    if k == 1:
        return loss_and_grads(bundle, params, batch)
    b = next(iter(batch.values())).shape[0]
    if b % k:
        raise ValueError(f"batch of {b} rows does not split into {k} "
                         "microbatches")
    # zeros laid out as each leaf is (a DTensor leaf's accumulator too)
    grads = tree_map(lambda p: torch.zeros_like(p, dtype=F32), params)
    loss = 0.0
    for i in range(k):
        mb = {n: x[i * (b // k):(i + 1) * (b // k)] for n, x in batch.items()}
        l_i, _, g = loss_and_grads(bundle, params, mb)
        for a, gi in zip(tree_leaves(grads), tree_leaves(g)):
            a.add_(gi.to(F32) / k)
        loss = loss + l_i / k
    return loss, {"loss": loss}, grads


def make_train_step(bundle, tcfg: TrainConfig):
    """Returns ``train_step(state, batch) -> (state', metrics)``; the
    state is updated in place (``training.optimizer.adamw_update``)."""

    def train_step(state, batch):
        _, metrics, grads = microbatch_grads(bundle, state["params"], batch,
                                             tcfg.microbatches)
        state, opt_metrics = adamw_update(state, grads, tcfg)
        return state, {**metrics, **opt_metrics}

    return train_step
