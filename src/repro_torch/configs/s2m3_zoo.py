"""The paper's own 14-model testbed zoo (Tables II & V).

Two granularities:
* ``ZOO`` — ModelSpec-level data (module names + param counts from
  Table V / Table VI) consumed by the placement/routing simulator to
  reproduce the paper's tables at full scale.
* ``CLIP_CONFIGS`` — small *runnable* CLIP configs used by the serving
  engine demo and the split-vs-monolithic equivalence tests.
"""

from __future__ import annotations

from repro_torch.models.clip import ClipConfig

M = 1_000_000
B = 1_000_000_000

# module name -> parameter count (Table V; text sizes back-derived from
# Table VI totals where the paper gives a range)
MODULE_PARAMS: dict[str, int] = {
    # vision encoders
    "resnet-50": 38 * M,
    "resnet-101": 56 * M,
    "resnet-50x4": 87 * M,
    "resnet-50x16": 168 * M,
    "resnet-50x64": 421 * M,
    "vit-b/32": 88 * M,
    "vit-b/16": 86 * M,
    "vit-l/14": 304 * M,
    "vit-l/14@336": 304 * M,
    "openclip-vit-h/14": 630 * M,
    # text encoders
    "clip-trf-38m": 38 * M,
    "clip-trf-59m": 59 * M,
    "clip-trf-85m": 85 * M,
    "clip-trf-151m": 151 * M,
    "openclip-trf": 302 * M,
    # audio encoder
    "audio-vit-b": 85 * M,
    # language models (task heads)
    "vicuna-7b": 7 * B,
    "vicuna-13b": 13 * B,
    "phi-3-mini": int(3.8 * B),
    "tinyllama-1.1b": int(1.1 * B),
    "gpt2": 124 * M,
    # parameter-free heads
    "cosine-similarity": 0,
    "infonce": 0,
    "classifier": 1 * M,
}

# model -> (task, encoder modules, head module)   [Table II]
ZOO: dict[str, tuple[str, tuple[str, ...], str]] = {
    # image-text retrieval (9 CLIP variants)
    "clip-resnet-50": ("retrieval", ("resnet-50", "clip-trf-38m"), "cosine-similarity"),
    "clip-resnet-101": ("retrieval", ("resnet-101", "clip-trf-38m"), "cosine-similarity"),
    "clip-resnet-50x4": ("retrieval", ("resnet-50x4", "clip-trf-59m"), "cosine-similarity"),
    "clip-resnet-50x16": ("retrieval", ("resnet-50x16", "clip-trf-85m"), "cosine-similarity"),
    "clip-resnet-50x64": ("retrieval", ("resnet-50x64", "clip-trf-151m"), "cosine-similarity"),
    "clip-vit-b/32": ("retrieval", ("vit-b/32", "clip-trf-38m"), "cosine-similarity"),
    "clip-vit-b/16": ("retrieval", ("vit-b/16", "clip-trf-38m"), "cosine-similarity"),
    "clip-vit-l/14": ("retrieval", ("vit-l/14", "clip-trf-85m"), "cosine-similarity"),
    "clip-vit-l/14@336": ("retrieval", ("vit-l/14@336", "clip-trf-85m"), "cosine-similarity"),
    # VQA
    "encoder-only-vqa-s": ("vqa-enc", ("vit-b/16", "clip-trf-38m"), "classifier"),
    "encoder-only-vqa-l": ("vqa-enc", ("vit-l/14@336", "clip-trf-85m"), "classifier"),
    "llava-v1.5-7b": ("vqa-dec", ("vit-l/14@336",), "vicuna-7b"),
    "llava-next-7b": ("vqa-dec", ("vit-l/14@336",), "vicuna-7b"),
    "llava-v1.5-13b": ("vqa-dec", ("vit-l/14@336",), "vicuna-13b"),
    "llava-next-13b": ("vqa-dec", ("vit-l/14@336",), "vicuna-13b"),
    "xtuner-phi-3-mini": ("vqa-dec", ("vit-l/14@336",), "phi-3-mini"),
    "flint-v0.5-1b": ("vqa-dec", ("vit-l/14@336",), "tinyllama-1.1b"),
    "llava-v1.5-7b-s": ("vqa-dec", ("vit-b/16",), "vicuna-7b"),
    "flint-v0.5-1b-s": ("vqa-dec", ("vit-b/16",), "tinyllama-1.1b"),
    # cross-modal alignment
    "imagebind": ("alignment", ("openclip-vit-h/14", "openclip-trf", "audio-vit-b"),
                  "infonce"),
    # Table X multi-task variant: alignment built from the *shared* CLIP
    # modules plus an audio encoder (Insight 3 interchangeability)
    "alignment-vit-b": ("alignment", ("vit-b/16", "clip-trf-38m", "audio-vit-b"),
                        "infonce"),
    # image captioning
    "nlp-connect": ("captioning", ("vit-b/16",), "gpt2"),
    # image classification
    "clip-cls-vit-b/16": ("classification", ("vit-b/16",), "classifier"),
}

# small runnable CLIP configs for engine demos / equivalence tests
CLIP_CONFIGS: dict[str, ClipConfig] = {
    "mini-clip": ClipConfig(
        name="mini-clip", vision_layers=2, vision_width=64, vision_heads=4,
        text_layers=2, text_width=64, text_heads=4, vocab_size=256,
        embed_dim=32, n_image_tokens=16,
    ),
    "mini-clip-l": ClipConfig(
        name="mini-clip-l", vision_layers=4, vision_width=96, vision_heads=6,
        text_layers=2, text_width=64, text_heads=4, vocab_size=256,
        embed_dim=32, n_image_tokens=16,
    ),
}


def get_clip_config(name: str) -> ClipConfig:
    return CLIP_CONFIGS[name]
