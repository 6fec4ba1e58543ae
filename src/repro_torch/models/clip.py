"""CLIP-style dual encoder (the paper's own testbed model family).

Vision encoder (over stub patch embeddings) + text encoder + cosine-
similarity head — exactly the three S2M3 functional modules of the
paper's image-text-retrieval task (Fig. 1a).  Used by the sharing-
equivalence tests and the distributed serving engine demo: the split
model's outputs must equal the monolithic one's (paper Q3).

Where the JAX package scans a tower's stacked layers, the port loops
over the layer index; each layer's attention goes through the flash
kernel (``layers.attention.attention_apply``): non-causal in the vision
tower, causal in the text tower.  The towers take ``impl``: "kernel"
(serving) or "xla", plain torch that differentiates, which
``contrastive_loss`` runs as the reference's towers run its XLA path.
The encoders and ``clip_forward`` take the reference's ``dtype`` (float32
by default): the stub embeddings, the token embedding and every weight
are cast to it at use; ``init_clip`` draws its weights in it.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from repro_torch.common.device import resolve_device
from repro_torch.common.pytree import tree_map
from repro_torch.layers import attention as attn_lib
from repro_torch.layers.embedding import embed_apply, embed_specs
from repro_torch.layers.initializers import WSpec, init_tree, stack_specs
from repro_torch.layers.mlp import mlp_apply, mlp_specs
from repro_torch.layers.norms import apply_norm, norm_specs


@dataclass(frozen=True)
class ClipConfig:
    name: str
    vision_layers: int
    vision_width: int
    vision_heads: int
    text_layers: int
    text_width: int
    text_heads: int
    vocab_size: int
    embed_dim: int           # shared contrastive space
    n_image_tokens: int = 16
    norm_eps: float = 1e-5


@dataclass(frozen=True)
class _TowerCfg:
    """Adapter so we can reuse repro_torch.layers.attention."""
    rope_theta: float = 10000.0
    use_rope: bool = False
    sliding_window: int = 0
    attn_logit_softcap: float = 0.0


def _tower_specs(width: int, heads: int, layers: int):
    block = {
        "ln1": norm_specs(width, "layernorm"),
        "attn": attn_lib.attention_specs(width, heads, heads, width // heads),
        "ln2": norm_specs(width, "layernorm"),
        "mlp": mlp_specs(width, 4 * width),
    }
    return stack_specs(block, layers)


def _tower_apply(params, h, *, causal: bool, eps: float, impl: str):
    B, S = h.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=h.device).expand(B, S)
    tc = _TowerCfg()
    for i in range(params["ln1"]["scale"].shape[0]):
        lp = tree_map(lambda t, i=i: t[i], params)
        x = apply_norm(lp["ln1"], h, "layernorm", eps)
        y, _ = attn_lib.attention_apply(lp["attn"], x, positions=positions,
                                        cfg=tc, causal=causal, impl=impl)
        h = h + y
        x = apply_norm(lp["ln2"], h, "layernorm", eps)
        h = h + mlp_apply(lp["mlp"], x, "gelu")
    return h


def clip_specs(cfg: ClipConfig):
    return {
        "vision": {
            "patch_proj": WSpec((cfg.vision_width, cfg.vision_width),
                                (None, "embed")),
            "pos": WSpec((cfg.n_image_tokens, cfg.vision_width), (None, "embed"),
                         init="small"),
            "blocks": _tower_specs(cfg.vision_width, cfg.vision_heads,
                                   cfg.vision_layers),
            "ln_post": norm_specs(cfg.vision_width, "layernorm"),
            "proj": WSpec((cfg.vision_width, cfg.embed_dim), ("embed", None)),
        },
        "text": {
            "embed": embed_specs(cfg.vocab_size, cfg.text_width),
            "pos": WSpec((512, cfg.text_width), (None, "embed"), init="small"),
            "blocks": _tower_specs(cfg.text_width, cfg.text_heads,
                                   cfg.text_layers),
            "ln_final": norm_specs(cfg.text_width, "layernorm"),
            "proj": WSpec((cfg.text_width, cfg.embed_dim), ("embed", None)),
        },
        "logit_scale": WSpec((), (), init="zeros"),
    }


def encode_image(params, patches, cfg: ClipConfig, impl: str = "kernel",
                 dtype=torch.float32):
    """patches: (B, n_image_tokens, vision_width) stub embeddings."""
    h = patches.to(dtype) @ params["patch_proj"].to(dtype)
    h = h + params["pos"].to(dtype)[None]
    h = _tower_apply(params["blocks"], h, causal=False, eps=cfg.norm_eps,
                     impl=impl)
    h = apply_norm(params["ln_post"], h.mean(dim=1, keepdim=True),
                   "layernorm", cfg.norm_eps)[:, 0]
    z = h @ params["proj"].to(dtype)
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


def encode_text(params, ids, cfg: ClipConfig, impl: str = "kernel",
                dtype=torch.float32):
    """ids: (B, S) int32; EOT = last token."""
    h = embed_apply(params["embed"], ids, dtype=dtype)
    S = ids.shape[1]
    h = h + params["pos"].to(dtype)[None, :S]
    h = _tower_apply(params["blocks"], h, causal=True, eps=cfg.norm_eps,
                     impl=impl)
    h = apply_norm(params["ln_final"], h, "layernorm", cfg.norm_eps)
    z = h[:, -1] @ params["proj"].to(dtype)
    return z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)


def retrieval_logits(img_z, txt_z, logit_scale):
    """Cosine-similarity task head (the paper's retrieval head)."""
    return torch.exp(logit_scale) * img_z @ txt_z.T


def clip_forward(params, patches, ids, cfg: ClipConfig, impl: str = "kernel",
                 dtype=torch.float32):
    """Monolithic forward — the oracle the split execution must match."""
    zi = encode_image(params["vision"], patches, cfg, impl, dtype)
    zt = encode_text(params["text"], ids, cfg, impl, dtype)
    return retrieval_logits(zi, zt, params["logit_scale"])


def contrastive_loss(params, patches, ids, cfg: ClipConfig,
                     impl: str = "xla"):
    """The symmetric InfoNCE loss over a batch of matching (image, text)
    pairs: the mean of the image->text and text->image cross entropies
    of ``clip_forward``'s logits, pair i's label being i."""
    logits = clip_forward(params, patches, ids, cfg, impl)
    n = logits.shape[0]
    idx = torch.arange(n, device=logits.device)
    li = -F.log_softmax(logits, dim=1)[idx, idx].mean()
    lt = -F.log_softmax(logits, dim=0)[idx, idx].mean()
    return 0.5 * (li + lt)


def init_clip(generator: torch.Generator, cfg: ClipConfig, device=None,
               dtype=torch.float32):
    """The weights of ``cfg`` in ``dtype`` (float32 by default, as the
    reference's) drawn from ``generator`` on ``device`` (the card unless
    the caller names another; ``common.device.resolve_device``)."""
    return init_tree(clip_specs(cfg), generator, dtype,
                     resolve_device(device))
