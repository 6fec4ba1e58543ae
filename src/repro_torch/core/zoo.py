"""ModelSpecs for the paper's 14-model zoo and the 10 assigned archs.

The zoo feeds the placement/routing simulator (exact published param
counts); ``arch_model_spec`` adapts an assigned ``ArchConfig`` into the
same ModelSpec language so the assigned architectures participate in
S2M3 placement/sharing.  Notably tinyllama-1.1b carries the *same
signature* as the paper's Flint-v0.5-1B head, so cross-registry sharing
actually triggers.
"""

from __future__ import annotations

from repro_torch.common.config import ArchConfig
from repro_torch.configs.s2m3_zoo import MODULE_PARAMS, ZOO
from repro_torch.core.module import ModelSpec, ModuleSpec
from repro_torch.core.profiles import TOKENS_PER_QUERY


def _modality(module_name: str) -> str:
    n = module_name
    if n.startswith(("resnet", "vit", "openclip-vit")):
        return "vision"
    if "trf" in n:
        return "text"
    if n.startswith("audio"):
        return "audio"
    return "task"


def _module(name: str, kind: str) -> ModuleSpec:
    modality = _modality(name) if kind == "encoder" else "task"
    n_params = MODULE_PARAMS[name]
    tokens = TOKENS_PER_QUERY[modality]
    input_bytes = {"vision": 600_000, "text": 1_000, "audio": 960_000,
                   "task": 8_192}[modality]
    return ModuleSpec(
        name=name, kind=kind, modality=modality, n_params=n_params,
        bytes_per_param=4.0,   # the paper deploys fp32 checkpoints
        flops_per_query=2.0 * n_params * tokens,
        input_bytes=input_bytes,
        output_bytes=4_096,
    )


# per-task request work multiplicity (retrieval = zero-shot
# classification over ~100 candidate prompts; see core.profiles)
TASK_WORK: dict[str, tuple[tuple[str, float], ...]] = {
    "retrieval": (("text", 100.0),),
    "classification": (),
    "vqa-enc": (),
    "vqa-dec": (),
    "alignment": (),
    "captioning": (),
}


def request_for(model: ModelSpec, rid: int, source: str, arrival: float = 0.0,
                batch: int = 1):
    from repro_torch.core.routing import Request

    return Request(rid, model.name, source, arrival, batch,
                   work=TASK_WORK.get(model.task, ()))


def paper_zoo() -> dict[str, ModelSpec]:
    out = {}
    for mdl_name, (task, encoders, head) in ZOO.items():
        out[mdl_name] = ModelSpec(
            name=mdl_name, task=task,
            encoders=tuple(_module(e, "encoder") for e in encoders),
            head=_module(head, "head"),
        )
    return out


def arch_model_spec(cfg: ArchConfig) -> ModelSpec:
    """Assigned architecture -> S2M3 ModelSpec.

    Multi-modal archs split into encoder+head; pure text LMs are
    head-only models (the paper's own characterization of decoder-only
    VQA: no parallel-routing benefit, full sharing benefit).
    """
    from repro_torch.models.api import build_model

    n_total = build_model(cfg).param_count()

    def lm_head(n) -> ModuleSpec:
        # sharing requires identical signatures: when the arch is also a
        # zoo module (tinyllama-1.1b == the Flint VQA head), reuse the
        # zoo's canonical spec so the registry dedups
        if cfg.name in MODULE_PARAMS:
            return _module(cfg.name, "head")
        return ModuleSpec(
            name=cfg.name, kind="head", modality="task", n_params=n,
            bytes_per_param=4.0,
            flops_per_query=2.0 * n * TOKENS_PER_QUERY["task"],
            input_bytes=8_192,
        )

    if cfg.has_vision_stub:
        n_enc = max(1, n_total // 10)   # stub frontend + projector share
        enc = ModuleSpec(
            name=f"{cfg.name}-vision-stub", kind="encoder", modality="vision",
            n_params=n_enc, flops_per_query=2.0 * n_enc * TOKENS_PER_QUERY["vision"],
            input_bytes=600_000,
        )
        return ModelSpec(cfg.name, "vqa-dec", (enc,), lm_head(n_total - n_enc))
    if cfg.is_encoder_decoder:
        # real split: encoder tower params vs decoder params
        from repro_torch.layers.initializers import spec_param_count as spc
        from repro_torch.models.encdec import _enc_block_specs

        n_enc = spc(_enc_block_specs(cfg)) * cfg.n_encoder_layers \
            + cfg.d_model * cfg.d_model
        enc = ModuleSpec(
            name=f"{cfg.name}-audio-encoder", kind="encoder", modality="audio",
            n_params=n_enc, flops_per_query=2.0 * n_enc * TOKENS_PER_QUERY["audio"],
            input_bytes=960_000,
        )
        return ModelSpec(cfg.name, "asr", (enc,), lm_head(n_total - n_enc))
    return ModelSpec(cfg.name, "text-gen", (), lm_head(n_total))
