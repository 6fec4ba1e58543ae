"""Token embedding and LM output head, both computed in float32."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.common.sharding import settle
from repro_torch.layers.initializers import WSpec


def embed_specs(vocab: int, d_model: int):
    return {"table": WSpec((vocab, d_model), ("vocab", "embed"), init="embed",
                           scale=0.02)}


def embed_apply(params, ids, *, scale: float = 1.0):
    # a row gather (``F.embedding``: a sharded table gathers as a DTensor,
    # its masked partial rows summed before anything reshapes them)
    out = settle(F.embedding(ids.long(), params["table"])).float()
    if scale != 1.0:
        out = out * scale
    return out


def head_specs(d_model: int, vocab: int):
    return {"w": WSpec((d_model, vocab), ("embed", "vocab"), init="small")}


def head_apply(params, x, *, softcap: float = 0.0, tied_table=None):
    if tied_table is not None:
        logits = x @ tied_table.to(x.dtype).t()
    else:
        logits = x @ params["w"].to(x.dtype)
    logits = logits.float()
    if softcap and softcap > 0.0:
        logits = softcap * torch.tanh(logits / softcap)
    return logits
