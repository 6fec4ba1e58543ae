"""Token embedding and LM output head.  The embedding comes out in the
caller's compute dtype (bfloat16 by default, as the reference's); the
head computes in its input's dtype and returns float32 logits."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common import sharding
from repro_torch.layers.initializers import WSpec


def embed_specs(vocab: int, d_model: int):
    return {"table": WSpec((vocab, d_model), ("vocab", "embed"), init="embed",
                           scale=0.02)}


def embed_apply(params, ids, *, scale: float = 1.0, dtype=torch.bfloat16):
    """The rows of ``ids`` in ``dtype``, times ``scale`` rounded to
    ``dtype`` (the reference's ``jnp.asarray(scale, dtype)``).  A row
    gather; a vocabulary-sharded table gathers its rows on each rank's
    own slice (``_vocab_sharded_rows``)."""
    table = params["table"]
    if sharding.is_dtensor(table) and sharding.spec_of(table)[0] is not None:
        out = _vocab_sharded_rows(table, ids, dtype)
    else:
        out = F.embedding(ids.long(), table).to(dtype)
    if scale != 1.0:
        out = out * torch.tensor(scale, dtype=dtype).item()
    return out


def _vocab_sharded_rows(table, ids, dtype):
    """``table[ids]`` in ``dtype`` for a table whose rows are sharded:
    each rank takes the rows of its own slice (zeros for ids outside it)
    and an all_reduce over the vocabulary axes sums them, as GSPMD does.  A
    masked gather written by hand: DTensor's own (a ``_MaskPartial``) has
    no backward from a partial-sum gradient.  The table is gathered over
    its embed (FSDP) axes and the ids' rows are sharded over them, as
    the batch is (both are ("pod", "data") in the rules): the rows come
    out laid out as the residual stream wants them, where keeping the
    embed dim sharded made every rank hold every row (an all-to-all of
    the whole batch's activations after)."""
    mesh = table.device_mesh
    vocab, emb = sharding.spec_of(table)
    rows = emb if emb and ids.shape[0] % sharding.axis_size(mesh, emb) == 0 \
        else None

    def f(t, i):
        n = t.shape[0]
        rel = i.long() - sharding.axis_index(mesh, vocab) * n
        hit = ((rel >= 0) & (rel < n))[..., None].to(t.dtype)
        out = F.embedding(rel.clamp(0, n - 1), t) * hit
        return sharding.all_reduce(out, mesh, vocab).to(dtype)

    lead = (rows,) + (None,) * (ids.ndim - 1)
    return sharding.shard_map(f, mesh, ((vocab, None), lead),
                              (*lead, None))(table, ids)


def head_specs(d_model: int, vocab: int):
    return {"w": WSpec((d_model, vocab), ("embed", "vocab"), init="small")}


def head_apply(params, x, *, softcap: float = 0.0, tied_table=None):
    w = tied_table.t() if tied_table is not None else params["w"]
    if sharding.is_dtensor(w):
        logits = _head_sharded(x, w)
    else:
        logits = x @ w.to(x.dtype)
    logits = logits.float()
    if softcap and softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits


def _head_sharded(x, w):
    """``x @ w`` for a sharded head ``w`` (d, vocab) on each rank's local
    tensors, as GSPMD lays it out: x keeps its batch and sequence
    sharding with d whole, ``w`` is gathered over its d (FSDP) axes and
    keeps its vocabulary sharding, so the logits are sharded as the
    vocabulary is.  DTensor's own product may instead gather the
    logits' gradient whole (every row and every vocabulary entry: 125
    GiB a rank for tinyllama-1.1b's train_4k on 16 x 16)."""
    x, lead = sharding.lead_spec(x)
    vocab = sharding.unless_used(sharding.spec_of(w)[1], lead)
    return sharding.shard_map(lambda xl, wl: xl @ wl.to(xl.dtype),
                              w.device_mesh, ((*lead, None), (None, vocab)),
                              (*lead, vocab))(x, w)
