"""InternVL2-1B's shared projector and its Qwen2-style decoder, plain
PyTorch.

The projector is InternVL2's published ``mlp1``: LayerNorm over the
4,096 features of a pixel-shuffled InternViT token, a 4,096 -> 896
linear map, GELU (erf), an 896 -> 896 linear map.  The decoder is the
port's ``vlm`` family (``repro_torch.models.lm``), as the configuration
file states it: the image tokens through one more d x d map in front of
the prompt's embeddings, then pre-norm blocks of RMSNorm, grouped-query
attention without biases (rotary angles in half-rotation layout),
RMSNorm and a SwiGLU MLP, a final RMSNorm and the tied embedding as the
output head.  Weights are read by the port's parameter names.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference.numerics import attention, mm


def projector(p, x, eps=1e-5, precision="float32"):
    """x (B, n, 4096) -> (B, n, d)."""
    h = F.layer_norm(x, (x.shape[-1],), p["ln"]["scale"], p["ln"]["bias"],
                     eps)
    h = F.gelu(mm(h, p["w1"], precision) + p["b1"])
    return mm(h, p["w2"], precision) + p["b2"]


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, positions, theta):
    dim = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                       device=x.device) / dim)
    ang = positions[:, None].float() * inv
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def logits_at(p, c, image_embeds, tokens, rows, precision="float32"):
    """The decoder's logits at positions ``rows`` of one sequence: the
    image tokens (n_img, d), then ``tokens``; (len(rows), vocab)."""
    d, H, K, hd = c["d"], c["H"], c["K"], c["hd"]
    eps, theta = c["eps"], c["theta"]
    img = mm(image_embeds, p["img_proj"]["w"], precision)
    h = torch.cat([img, p["embed"]["table"][tokens.long()]], dim=0)
    S = h.shape[0]
    pos = torch.arange(S, device=h.device)
    blocks = p["stages"]["blocks"]["blocks"]
    for i in range(blocks["ln_attn"]["scale"].shape[0]):
        a = blocks["attn"]
        x = _rms(h, blocks["ln_attn"]["scale"][i], eps)
        q = mm(x, a["wq"][i].reshape(d, H * hd), precision).view(S, H, hd)
        k = mm(x, a["wk"][i].reshape(d, K * hd), precision).view(S, K, hd)
        v = mm(x, a["wv"][i].reshape(d, K * hd), precision).view(S, K, hd)
        q, k = _rope(q, pos, theta), _rope(k, pos, theta)
        o = attention(q[None], k[None], v[None], causal=True,
                      precision=precision)[0]
        h = h + mm(o.reshape(S, H * hd), a["wo"][i].reshape(H * hd, d),
                   precision)
        m = blocks["mlp"]
        x = _rms(h, blocks["ln_mlp"]["scale"][i], eps)
        g = F.silu(mm(x, m["wi_gate"][i], precision))
        h = h + mm(g * mm(x, m["wi_up"][i], precision), m["wo"][i],
                   precision)
    h = _rms(h[rows], p["final_norm"]["scale"], eps)
    return mm(h, p["embed"]["table"].t(), precision)
