"""dots-vlm1-mt: dots.vlm1's split and share, served by the port.

Two tasks, ``ocr`` and ``caption``, share the vision stage (the patch
merger, over stub NaViT patch features) as their encoder and one
generative head: DeepSeek-V3's language model at its published widths
(``repro_torch.models.api.build_model``, float32 compute), cut to one
card of its deployment: 12 of 61 layers and 8 of each MoE layer's 256
routed experts (the configuration file's ``reduced`` and
``deployment``).  The head runs the port's DeepSeek-V3 path: MLA's
latent cache paged and decoded in the absorbed form, the noaux_tc router
over the held experts, YaRN; the scheduler's paged decode stream serves
it, the tick one CUDA graph replay.  The merger is written here, as a
deployment's builders are.

On the CPU, which only the tests drive (``run.py`` exits without a
card), the configuration runs at ``SMOKE``'s widths.  A card runs it as
the file states it, and refuses a mix whose ``max_seq_len`` cannot hold
the 1,024-token image prefix, but for the tests' cut copies of the
mixes (``portbench/tests/conftest.py``), which it runs at ``SMOKE``'s
widths too, and says so.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench import mla_work, work
from portbench.bench import BaseBench, same_shapes
from portbench.harness import log
from portbench.reference import dsv3 as ref
from portbench.traffic import Spec, quantiles
from portbench.weights import draw, n_params, nest, sub_seed

ENC, HEAD = "dots-merger", "dsv3-head"
GENERATIVE = ("ocr", "caption")
TOKEN_POOL = 1 << 16
WARM_RID = 1_000_000_000
#: std of the drawn e_score_correction_bias (``assumed``)
BIAS_STD = 0.05
#: widths of the tests' cut copies (kv_lora_rank and qk_rope_dim as
#: published, the kernel's; heads a multiple of its 16)
SMOKE = dict(hidden_size=64, intermediate_size=96, moe_intermediate_size=32,
             num_attention_heads=16, q_lora_rank=32, qk_nope_head_dim=16,
             v_head_dim=16, num_hidden_layers=3, first_k_dense_replace=1,
             vocab_size=256, router_experts=32, n_routed_experts=8,
             experts_offset=8, vision=dict(patches=16, patch_dim=16,
                                           spatial_merge_size=2))


def dims(sizes: dict) -> dict:
    v = sizes["vision"]
    merge = v["spatial_merge_size"] ** 2
    return {"L": sizes["num_hidden_layers"],
            "L_dense": sizes["first_k_dense_replace"],
            "d": sizes["hidden_size"], "H": sizes["num_attention_heads"],
            "q_rank": sizes["q_lora_rank"], "kv_rank": sizes["kv_lora_rank"],
            "nope": sizes["qk_nope_head_dim"], "rope": sizes["qk_rope_head_dim"],
            "v": sizes["v_head_dim"], "ff": sizes["intermediate_size"],
            "f": sizes["moe_intermediate_size"],
            "E": sizes["router_experts"], "held": sizes["n_routed_experts"],
            "e0": sizes["experts_offset"], "top_k": sizes["num_experts_per_tok"],
            "shared": sizes["n_shared_experts"], "n_group": sizes["n_group"],
            "topk_group": sizes["topk_group"],
            "routed_scale": sizes["routed_scaling_factor"],
            "V": sizes["vocab_size"], "theta": sizes["rope_theta"],
            "eps": sizes["rms_norm_eps"],
            "patches": v["patches"], "patch_dim": v["patch_dim"],
            "f_img": v["patch_dim"] * merge, "n_img": v["patches"] // merge,
            "merger_eps": sizes["merger_eps"]}


def ref_config(d: dict, sizes: dict) -> dict:
    """The plain reference's view of the sizes."""
    return {"H": d["H"], "nope": d["nope"], "rope": d["rope"], "v": d["v"],
            "eps": d["eps"], "theta": d["theta"],
            "yarn": dict(sizes["rope_scaling"]), "n_group": d["n_group"],
            "topk_group": d["topk_group"], "top_k": d["top_k"],
            "routed_scale": d["routed_scale"], "e0": d["e0"],
            "merger_eps": d["merger_eps"]}


def _attn(prefix, n, d):
    m, H = d["d"], d["H"]
    return [
        (prefix + ("ln_attn", "scale"), (n, m), "ones"),
        (prefix + ("attn", "w_dq"), (n, m, d["q_rank"]), m ** -0.5),
        (prefix + ("attn", "q_norm", "scale"), (n, d["q_rank"]), "ones"),
        (prefix + ("attn", "w_uq"), (n, d["q_rank"], H, d["nope"] + d["rope"]),
         d["q_rank"] ** -0.5),
        (prefix + ("attn", "w_dkv"), (n, m, d["kv_rank"]), m ** -0.5),
        (prefix + ("attn", "kv_norm", "scale"), (n, d["kv_rank"]), "ones"),
        (prefix + ("attn", "w_kr"), (n, m, d["rope"]), m ** -0.5),
        (prefix + ("attn", "w_uk"), (n, d["kv_rank"], H, d["nope"]),
         d["kv_rank"] ** -0.5),
        (prefix + ("attn", "w_uv"), (n, d["kv_rank"], H, d["v"]),
         d["kv_rank"] ** -0.5),
        (prefix + ("attn", "w_o"), (n, H, d["v"], m), (H * d["v"]) ** -0.5),
        (prefix + ("ln_mlp", "scale"), (n, m), "ones"),
    ]


def layout(sizes: dict) -> list:
    """Every weight, by the port's names: (path, shape, std)."""
    d = dims(sizes)
    m, f, fs = d["d"], d["f"], d["f"] * d["shared"]
    nd, nm = d["L_dense"], d["L"] - d["L_dense"]
    dense = ("lm", "stages", "dense", "blocks")
    moe = ("lm", "stages", "moe", "blocks")
    return [
        (("lm", "embed", "table"), (d["V"], m), 0.02),
        *_attn(dense, nd, d),
        (dense + ("mlp", "wi_gate"), (nd, m, d["ff"]), m ** -0.5),
        (dense + ("mlp", "wi_up"), (nd, m, d["ff"]), m ** -0.5),
        (dense + ("mlp", "wo"), (nd, d["ff"], m), d["ff"] ** -0.5),
        *_attn(moe, nm, d),
        (moe + ("moe", "router"), (nm, m, d["E"]), m ** -0.5),
        (moe + ("moe", "e_score_correction_bias"), (nm, d["E"]), BIAS_STD),
        (moe + ("moe", "wi_gate"), (nm, d["held"], m, f), m ** -0.5),
        (moe + ("moe", "wi_up"), (nm, d["held"], m, f), m ** -0.5),
        (moe + ("moe", "wo"), (nm, d["held"], f, m), f ** -0.5),
        (moe + ("moe", "shared", "wi_gate"), (nm, m, fs), m ** -0.5),
        (moe + ("moe", "shared", "wi_up"), (nm, m, fs), m ** -0.5),
        (moe + ("moe", "shared", "wo"), (nm, fs, m), fs ** -0.5),
        (("lm", "final_norm", "scale"), (m,), "ones"),
        (("lm", "head", "w"), (m, d["V"]), m ** -0.5),
        (("merger", "ln", "scale"), (d["patch_dim"],), "ones"),
        (("merger", "ln", "bias"), (d["patch_dim"],), "zeros"),
        (("merger", "w1"), (d["f_img"], d["f_img"]), d["f_img"] ** -0.5),
        (("merger", "b1"), (d["f_img"],), 0.02),
        (("merger", "w2"), (d["f_img"], m), d["f_img"] ** -0.5),
        (("merger", "b2"), (m,), 0.02),
    ]


def make_merger(eps: float):
    def merger(p, x):
        """The patch merger over (B, n_patches, patch_dim) features ->
        (B, n_patches / 4, d): LayerNorm, each 2 x 2 group of
        neighbouring patches (consecutive rows) concatenated, Linear,
        GELU, Linear."""
        h = F.layer_norm(x, (x.shape[-1],), p["ln"]["scale"], p["ln"]["bias"],
                         eps)
        h = h.reshape(x.shape[0], -1, p["w1"].shape[0])
        return F.gelu(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    return merger


#: the scheduler of the tests' cut copies of the mixes
TEST_CUT = dict(decode_rows=6, page_size=4, max_seq_len=56,
                decode_pages=6 * 14 + 1)


def cut(sizes: dict, mix: dict, device) -> dict:
    """The sizes to run (the module docstring)."""
    if torch.device(device).type == "cpu":
        return {**sizes, **SMOKE}
    sch = mix["scheduler"]
    vis = sizes["vision"]
    n_img = vis["patches"] // vis["spatial_merge_size"] ** 2
    if int(sch["max_seq_len"]) > n_img:
        return sizes
    if all(sch.get(k) == v for k, v in TEST_CUT.items()):
        log("[portbench] dots-vlm1-mt: the tests' cut mix, at SMOKE widths")
        return {**sizes, **SMOKE}
    raise ValueError(f"dots-vlm1-mt: max_seq_len {sch['max_seq_len']} "
                     f"cannot hold the {n_img}-token image prefix")


class Bench(BaseBench):
    def __init__(self, sizes, mix, seed, device):
        sizes = cut(sizes, mix, device)
        super().__init__(sizes, mix, seed, device)
        from repro_torch.common.config import Yarn, get_config
        from repro_torch.core.cluster import ClusterSpec, DeviceSpec
        from repro_torch.core.module import ModelSpec, ModuleSpec
        from repro_torch.models.api import build_model
        from repro_torch.s2m3 import Deployment

        d = self.d = dims(sizes)
        self.cfg = get_config("deepseek-v3-671b").with_overrides(
            n_layers=d["L"], first_dense_layers=d["L_dense"], d_model=d["d"],
            n_heads=d["H"], n_kv_heads=d["H"], head_dim=d["v"],
            vocab_size=d["V"], q_lora_rank=d["q_rank"],
            kv_lora_rank=d["kv_rank"], qk_nope_dim=d["nope"],
            qk_rope_dim=d["rope"], v_head_dim=d["v"], dense_d_ff=d["ff"],
            d_ff=d["f"], moe_d_ff=d["f"], n_experts=d["E"],
            experts_top_k=d["top_k"], n_shared_experts=d["shared"],
            moe_router=sizes["topk_method"], n_group=d["n_group"],
            topk_group=d["topk_group"],
            routed_scaling_factor=d["routed_scale"],
            experts_held=d["held"], experts_offset=d["e0"],
            rope_theta=d["theta"], rope_yarn=Yarn(**{
                k: v for k, v in sizes["rope_scaling"].items()
                if k != "type"}), norm_eps=d["eps"],
            act_fn=sizes["hidden_act"], mtp_depth=0,
            tie_embeddings=sizes["tie_word_embeddings"],
            has_vision_stub=True, n_image_tokens=d["n_img"],
            image_proj=False)
        bundle = build_model(self.cfg, compute_dtype=torch.float32)
        lay = layout(sizes)
        tree = nest(draw(lay, seed, self.device))
        same_shapes(tree["lm"], bundle.specs, "lm")
        n_merger = n_params([x for x in lay if x[0][0] == "merger"])
        enc = ModuleSpec(ENC, "encoder", "vision", n_merger, 4.0,
                         flops_per_query=self._merger_flops(1),
                         input_bytes=d["patches"] * d["patch_dim"] * 4,
                         output_bytes=d["n_img"] * d["d"] * 4)
        head = ModuleSpec(HEAD, "head", "task", bundle.param_count(), 4.0,
                          generative=True,
                          flops_per_query=2.0 * bundle.param_count(),
                          kv_bytes_per_token=bundle.kv_bytes_per_token())
        merger = make_merger(d["merger_eps"])
        builders = {ENC: lambda: (merger, tree["merger"]),
                    HEAD: lambda: (bundle, tree["lm"])}
        cluster = ClusterSpec(devices=[DeviceSpec(
            "h100", int(work.HBM_BYTES), work.PEAK_FLOPS_F32, kind="server")])
        dep = Deployment(cluster)
        dep.add_model(ModelSpec("ocr", "ocr", (enc,), head), builders)
        dep.add_model(ModelSpec("caption", "captioning", (enc,), head))
        self.dep = dep.plan("greedy", routing="queue_aware").materialize(
            device=self.device)
        self.images, self.tokens = self.inputs()
        # the merger's batch sizes, warmed here: no request need run
        top = int(self.mix.get("scheduler", {}).get("max_batch", 8))
        with torch.no_grad():
            for k in range(1, top + 1):
                self.dep.engine.apply_module(ENC, self.images[:1].expand(
                    k, -1, -1).contiguous())

    # -- inputs ---------------------------------------------------------
    def inputs(self):
        """The pool: stub NaViT patch features (on the card) and a pool of
        prompt token ids (on the host, where requests carry them)."""
        d, n = self.d, int(self.mix.get("pool", 16))
        images = torch.randn(n, d["patches"], d["patch_dim"],
                             generator=self.generator("inputs"),
                             device=self.device)
        rng = np.random.default_rng(sub_seed(self.seed, "prompts"))
        tokens = rng.integers(0, d["V"], TOKEN_POOL).tolist()
        return images, tokens

    def _prompt(self, rid: int, n: int) -> tuple:
        at = (rid * 4099) % (TOKEN_POOL - n)
        return tuple(self.tokens[at:at + n])

    def request(self, spec: Spec):
        from repro_torch.s2m3 import Request

        x = self.images[spec.rid % self.images.shape[0]][None]
        return Request(spec.rid, spec.task, "h100",
                       prompt=self._prompt(spec.rid, spec.prompt),
                       max_new_tokens=spec.output, temperature=0.0,
                       eos_id=-1, inputs={"vision": x})

    def warm_groups(self):
        """Prefills over the mix's range of prompts, each with a decode
        tick (the first of which the stream captures as its graph)."""
        lens = set()
        for t in self.mix["tasks"]:
            lens.update(quantiles(t["prompt"], 8))
        return [[self.request(Spec(WARM_RID + i, "ocr", n, 2))]
                for i, n in enumerate(sorted(lens))]

    def keep(self, result):
        """The merger's output, on the host: 29 MB an answer, which the
        card would otherwise hold beside the deployment (and in its
        peak) until the check."""
        return {"merger": result.encoder_outputs["vision"].detach().cpu()}

    # -- work -----------------------------------------------------------
    def _merger_flops(self, k: int) -> float:
        d = self.d
        tok = k * d["n_img"]
        return (work.gemm_flops(tok, d["f_img"], d["f_img"])
                + work.gemm_flops(tok, d["f_img"], d["d"]))

    def _lm_flops(self, tokens: int, attn: float, heads: int,
                  expert_pairs: int) -> float:
        """The head's model FLOPs over ``tokens`` positions: every
        layer's MLA projections, the dense layers' MLPs, the MoE layers'
        router, shared expert and ``expert_pairs`` routed pairs, the
        attention's ``attn`` FLOPs, and ``heads`` rows of logits."""
        d = self.d
        return (d["L"] * mla_work.mla_proj_flops(
                    tokens, d["d"], d["H"], d["q_rank"], d["kv_rank"],
                    d["nope"], d["rope"], d["v"])
                + d["L_dense"] * 3 * work.gemm_flops(tokens, d["d"], d["ff"])
                + (d["L"] - d["L_dense"]) * mla_work.moe_flops(
                    tokens, 0, d["d"], d["f"], d["E"], d["shared"])
                + 3 * work.gemm_flops(expert_pairs, d["d"], d["f"])
                + attn
                + heads * work.gemm_flops(1, d["d"], d["V"]))

    def call_work(self, call) -> list:
        """[(kind, flops, bytes)] of one device call: "model" for its
        FLOPs as a whole, a kernel's name for that kernel's launches."""
        d = self.d
        mod, phase = call["module"], call["phase"]
        pairs_moe = int(call["attrs"].get("expert_pairs", 0))
        if mod == ENC:
            return [("model", self._merger_flops(len(call["rids"])), 0)]
        if phase == "prefill":
            S = int(call["attrs"]["prefix_len"])
            attn = d["L"] * mla_work.mla_pair_flops(
                S * (S + 1) / 2, d["H"], d["nope"], d["rope"], d["v"])
            return [("model", self._lm_flops(S, attn, 1, pairs_moe), 0)]
        if phase == "decode_tick":
            sch = self.mix["scheduler"]
            keys = [d["n_img"] + s.prompt + i + 1
                    for s, i in zip(call["specs"], call["ticks"])]
            b, f = mla_work.paged_mla_work(
                int(sch["decode_rows"]), d["H"], d["kv_rank"], d["rope"],
                int(sch["page_size"]), keys, 4)
            flops = self._lm_flops(len(keys), d["L"] * f, len(keys),
                                   pairs_moe)
            return [("model", flops, 0),
                    ("paged_mla_decode", d["L"] * f, d["L"] * b)]
        return []

    # -- the check ------------------------------------------------------
    def check(self, kept, finished, seed, control=False):
        """merger_err: the merger's widest gap over its largest reference
        output, over the kept answers; token_gap: the widest gap by
        which a served token's logit lies below the reference's best at
        its position (teacher-forced), over a sample of the served
        requests drawn from the seed and the longest of them.  With
        ``control`` the reference at TF32 stands in for the program: its
        merger outputs, and at each position the token it puts first."""
        self.release()
        d = self.d
        c = ref_config(d, self.sizes)
        p = nest(draw(layout(self.sizes), seed, self.device))
        images, tokens = self.inputs()
        self.tokens = tokens
        n_pool = images.shape[0]
        prec = "tf32" if control else "float32"
        gap = top = 0.0
        gaps = []
        with torch.no_grad():
            for r in sorted(kept):
                x = images[r % n_pool]
                want = ref.merger(p["merger"], x, c)
                got = (ref.merger(p["merger"], x, c, prec) if control
                       else kept[r]["merger"][0].to(self.device).float())
                gap = max(gap, float((got - want).abs().max()))
                top = max(top, float(want.abs().max()))
            served = sorted(r for r, rec in finished.items()
                            if rec.tokens is not None and rec.n_tokens)
            rng = np.random.default_rng(sub_seed(seed, "token-sample"))
            n = min(int(self.mix.get("sample_tokens", len(served))),
                    len(served))
            pick = set(rng.choice(served, n, replace=False).tolist()) if n \
                else set()
            if served:
                pick.add(max(served, key=lambda r: finished[r].n_tokens))
            for r in sorted(pick):
                rec = finished[r]
                out = [int(t) for t in rec.tokens]
                prompt = self._prompt(r, rec.spec.prompt)
                seq = torch.tensor(prompt + tuple(out[:-1]),
                                   device=self.device)
                img = ref.merger(p["merger"], images[r % n_pool], c)
                first = d["n_img"] + len(prompt) - 1
                rows = torch.arange(first, first + len(out),
                                    device=self.device)
                lg = ref.logits_at(p["lm"], c, img, seq, rows)
                if control:
                    chosen = ref.logits_at(
                        p["lm"], c, ref.merger(p["merger"], images[r % n_pool],
                                               c, prec),
                        seq, rows, prec).argmax(-1)
                else:
                    chosen = torch.tensor(out, device=self.device)
                best = lg.max(-1).values
                gaps.append(float((best - lg.gather(
                    1, chosen[:, None].long())[:, 0]).max()))
        log(f"[portbench] token gaps by request: "
            f"{', '.join(f'{g:.3g}' for g in gaps)}")
        return {"merger_err": gap / top if top else float("nan"),
                "token_gap": max(gaps) if gaps else float("nan")}
