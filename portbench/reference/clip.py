"""CLIP ViT-B/16's two towers and the three task heads, plain PyTorch.

The port's tower (``repro_torch.models.clip``), as its configuration
file states it: pre-norm blocks of LayerNorm, multi-head attention
without biases (non-causal in the vision tower, causal in the text
tower) and a gated MLP (GELU, tanh form, times a linear branch); the
image's stub patch embeddings through one linear map and learned
positions, pooled by the mean over tokens; the text's last token; each
projected to the shared space and scaled to unit length.  Weights are
read by the port's parameter names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.numerics import attention, mm


def _block(p, i, h, heads, causal, eps, precision):
    B, S, d = h.shape
    hd = d // heads

    def w(*path):
        t = p
        for key in path:
            t = t[key]
        return t[i]

    x = F.layer_norm(h, (d,), w("ln1", "scale"), w("ln1", "bias"), eps)
    q = mm(x, w("attn", "wq").reshape(d, d), precision).view(B, S, heads, hd)
    k = mm(x, w("attn", "wk").reshape(d, d), precision).view(B, S, heads, hd)
    v = mm(x, w("attn", "wv").reshape(d, d), precision).view(B, S, heads, hd)
    o = attention(q, k, v, causal=causal, precision=precision)
    h = h + mm(o.reshape(B, S, d), w("attn", "wo").reshape(d, d), precision)
    x = F.layer_norm(h, (d,), w("ln2", "scale"), w("ln2", "bias"), eps)
    g = F.gelu(mm(x, w("mlp", "wi_gate"), precision), approximate="tanh")
    u = mm(x, w("mlp", "wi_up"), precision)
    return h + mm(g * u, w("mlp", "wo"), precision)


def _tower(blocks, h, heads, causal, eps, precision):
    for i in range(blocks["ln1"]["scale"].shape[0]):
        h = _block(blocks, i, h, heads, causal, eps, precision)
    return h


def _unit(z):
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


def encode_image(p, patches, heads, eps, precision="float32"):
    """p: the vision tower's weights; patches (B, n_tokens, width)."""
    h = mm(patches, p["patch_proj"], precision) + p["pos"][None]
    h = _tower(p["blocks"], h, heads, False, eps, precision)
    d = h.shape[-1]
    h = F.layer_norm(h.mean(dim=1), (d,), p["ln_post"]["scale"],
                     p["ln_post"]["bias"], eps)
    return _unit(mm(h, p["proj"], precision))


def encode_text(p, ids, heads, eps, precision="float32"):
    """p: the text tower's weights; ids (B, S) int."""
    S = ids.shape[1]
    h = p["embed"]["table"][ids.long()] + p["pos"][None, :S]
    h = _tower(p["blocks"], h, heads, True, eps, precision)
    d = h.shape[-1]
    h = F.layer_norm(h[:, -1], (d,), p["ln_final"]["scale"],
                     p["ln_final"]["bias"], eps)
    return _unit(mm(h, p["proj"], precision))


def retrieval(z_img, z_txt, logit_scale, precision="float32"):
    """The cosine head: exp(logit_scale) * z_img . z_txt, a row each."""
    return torch.exp(logit_scale) * mm(z_img[:, None], z_txt[:, :, None],
                                       precision)[:, 0]


def linear(x, w, precision="float32"):
    return mm(x, w, precision)
