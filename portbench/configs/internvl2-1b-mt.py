"""internvl2-1b-mt: InternVL2-1B's split and share, served by the port.

Three tasks share the published ``mlp1`` projector as their encoder
stage: ``caption`` and ``ocr`` share the generative head, the port's
``vlm`` decoder at Qwen2-0.5B's published sizes
(``repro_torch.models.api.build_model``, float32 compute), which the
scheduler's paged decode stream serves; ``classify`` puts an 896 ->
1000 linear head on the mean projected token.  The projector and the
classify head are written here, as a deployment's builders are.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench import work
from portbench.bench import BaseBench, same_shapes
from portbench.reference import vlm as ref
from portbench.traffic import Spec, quantiles
from portbench.weights import draw, n_params, nest, sub_seed

ENC, HEAD, CLS = "internvit-mlp1", "qwen2-0.5b-head", "cls-1000"
GENERATIVE = ("caption", "ocr")
TOKEN_POOL = 1 << 16
WARM_RID = 1_000_000_000
#: projector LayerNorm eps (torch's default, as InternVL builds mlp1)
PROJ_EPS = 1e-5


def dims(sizes: dict) -> dict:
    c, v = sizes["llm_config"], sizes["vision_config"]
    side = v["image_size"] // v["patch_size"]
    shuffle = round(1 / sizes["downsample_ratio"])
    return {"L": c["num_hidden_layers"], "d": c["hidden_size"],
            "H": c["num_attention_heads"], "K": c["num_key_value_heads"],
            "hd": c["hidden_size"] // c["num_attention_heads"],
            "ff": c["intermediate_size"], "V": c["vocab_size"],
            "theta": c["rope_theta"], "eps": c["rms_norm_eps"],
            "n_img": (side // shuffle) ** 2,
            "f_img": v["hidden_size"] * shuffle ** 2,
            "classes": sizes["tasks"]["classify"]["classes"]}


def layout(sizes: dict) -> list:
    """Every weight, by the port's names: (path, shape, std)."""
    d = dims(sizes)
    L, m, H, K, hd, ff = d["L"], d["d"], d["H"], d["K"], d["hd"], d["ff"]
    b = ("lm", "stages", "blocks", "blocks")
    return [
        (("lm", "embed", "table"), (d["V"], m), 0.02),
        (b + ("ln_attn", "scale"), (L, m), "ones"),
        (b + ("attn", "wq"), (L, m, H, hd), m ** -0.5),
        (b + ("attn", "wk"), (L, m, K, hd), m ** -0.5),
        (b + ("attn", "wv"), (L, m, K, hd), m ** -0.5),
        (b + ("attn", "wo"), (L, H, hd, m), (H * hd) ** -0.5),
        (b + ("ln_mlp", "scale"), (L, m), "ones"),
        (b + ("mlp", "wi_gate"), (L, m, ff), m ** -0.5),
        (b + ("mlp", "wi_up"), (L, m, ff), m ** -0.5),
        (b + ("mlp", "wo"), (L, ff, m), ff ** -0.5),
        (("lm", "final_norm", "scale"), (m,), "ones"),
        (("lm", "img_proj", "w"), (m, m), m ** -0.5),
        (("proj", "ln", "scale"), (d["f_img"],), "ones"),
        (("proj", "ln", "bias"), (d["f_img"],), "zeros"),
        (("proj", "w1"), (d["f_img"], m), d["f_img"] ** -0.5),
        (("proj", "b1"), (m,), 0.02),
        (("proj", "w2"), (m, m), m ** -0.5),
        (("proj", "b2"), (m,), 0.02),
        (("cls",), (m, d["classes"]), m ** -0.5),
    ]


def mlp1(p, x):
    """InternVL2's projector over (B, n, 4096) pixel-shuffled tokens."""
    h = F.layer_norm(x, (x.shape[-1],), p["ln"]["scale"], p["ln"]["bias"],
                     PROJ_EPS)
    return F.gelu(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


class Bench(BaseBench):
    def __init__(self, sizes, mix, seed, device):
        super().__init__(sizes, mix, seed, device)
        from repro_torch.common.config import get_config
        from repro_torch.core.cluster import ClusterSpec, DeviceSpec
        from repro_torch.core.module import ModelSpec, ModuleSpec
        from repro_torch.models.api import build_model
        from repro_torch.s2m3 import Deployment

        d = self.d = dims(sizes)
        self.cfg = get_config("internvl2-1b").with_overrides(
            n_layers=d["L"], d_model=d["d"], n_heads=d["H"],
            n_kv_heads=d["K"], head_dim=d["hd"], d_ff=d["ff"],
            vocab_size=d["V"], rope_theta=d["theta"], norm_eps=d["eps"],
            n_image_tokens=d["n_img"], act_fn=sizes["llm_config"][
                "hidden_act"])
        bundle = build_model(self.cfg, compute_dtype=torch.float32)
        lay = layout(sizes)
        tree = nest(draw(lay, seed, self.device))
        same_shapes(tree["lm"], bundle.specs, "lm")
        n_proj = n_params([x for x in lay if x[0][0] == "proj"])
        enc = ModuleSpec(ENC, "encoder", "vision", n_proj, 4.0,
                         flops_per_query=self._proj_flops(1),
                         input_bytes=d["n_img"] * d["f_img"] * 4,
                         output_bytes=d["n_img"] * d["d"] * 4)
        head = ModuleSpec(HEAD, "head", "task", bundle.param_count(), 4.0,
                          generative=True,
                          flops_per_query=2.0 * bundle.param_count(),
                          kv_bytes_per_token=bundle.kv_bytes_per_token())
        cls = ModuleSpec(CLS, "head", "task", d["d"] * d["classes"], 4.0,
                         flops_per_query=2.0 * d["d"] * d["classes"])
        builders = {
            ENC: lambda: (mlp1, tree["proj"]),
            HEAD: lambda: (bundle, tree["lm"]),
            CLS: lambda: (lambda w, e: e["vision"].mean(-2) @ w, tree["cls"]),
        }
        cluster = ClusterSpec(devices=[DeviceSpec(
            "h100", int(work.HBM_BYTES), work.PEAK_FLOPS_F32, kind="server")])
        dep = Deployment(cluster)
        dep.add_model(ModelSpec("caption", "captioning", (enc,), head),
                      builders)
        dep.add_model(ModelSpec("ocr", "ocr", (enc,), head))
        dep.add_model(ModelSpec("classify", "classification", (enc,), cls))
        self.dep = dep.plan("greedy", routing="queue_aware").materialize(
            device=self.device)
        self.images, self.tokens = self.inputs()

    # -- inputs ---------------------------------------------------------
    def inputs(self):
        """The pool: stub InternViT features (on the card) and a pool of
        prompt token ids (on the host, where requests carry them)."""
        d, n = self.d, int(self.mix.get("pool", 32))
        images = torch.randn(n, d["n_img"], d["f_img"],
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
        if spec.task not in GENERATIVE:
            return Request(spec.rid, spec.task, "h100", inputs={"vision": x})
        return Request(spec.rid, spec.task, "h100",
                       prompt=self._prompt(spec.rid, spec.prompt),
                       max_new_tokens=spec.output, temperature=0.0,
                       eos_id=-1, inputs={"vision": x})

    def warm_groups(self):
        """Each projector batch size up to ``max_batch``; prefills over
        the mix's range of prompts, each with a decode tick."""
        top = int(self.mix.get("scheduler", {}).get("max_batch", 8))
        rid = WARM_RID
        groups = []
        for k in range(1, top + 1):
            groups.append([self.request(Spec(rid + i, "classify", 0, 0))
                           for i in range(k)])
            rid += k
        lens = set()
        for t in self.mix["tasks"]:
            if t["task"] in GENERATIVE:
                lens.update(quantiles(t["prompt"], 8))
        for n in sorted(lens):
            groups.append([self.request(Spec(rid, "caption", n, 2))])
            rid += 1
        return groups

    def keep(self, result):
        enc = result.encoder_outputs["vision"].detach().clone()
        if result.model in GENERATIVE:
            return {"proj": enc}
        return {"proj": enc, "logits": result.output.detach().clone()}

    # -- work -----------------------------------------------------------
    def _proj_flops(self, k: int) -> float:
        d = self.d
        tok = k * d["n_img"]
        return (work.gemm_flops(tok, d["f_img"], d["d"])
                + work.gemm_flops(tok, d["d"], d["d"]))

    def _lm_flops(self, tokens: int, pairs: float, heads: int) -> float:
        d = self.d
        return (d["L"] * work.attn_block_flops(tokens, d["d"], d["H"], d["K"],
                                               d["hd"], d["ff"], True)
                + d["L"] * work.attn_pair_flops(pairs, d["H"], d["hd"])
                + heads * work.gemm_flops(1, d["d"], d["V"]))

    def call_work(self, call) -> list:
        """[(kind, flops, bytes)] of one device call: "model" for its
        FLOPs as a whole, a kernel's name for that kernel's launches."""
        d = self.d
        mod, phase = call["module"], call["phase"]
        if mod == ENC:
            return [("model", self._proj_flops(len(call["rids"])), 0)]
        if mod == CLS:
            return [("model", work.gemm_flops(1, d["d"], d["classes"]), 0)]
        if phase == "prefill":
            S = int(call["attrs"]["prefix_len"])
            b, f = work.flash_work(1, S, S, d["H"], d["K"], d["hd"], True, 4)
            flops = (work.gemm_flops(d["n_img"], d["d"], d["d"])
                     + self._lm_flops(S, S * (S + 1) / 2, 1))
            return [("model", flops, 0),
                    ("flash_attention", d["L"] * f, d["L"] * b)]
        if phase == "decode_tick":
            sch = self.mix["scheduler"]
            n_max = -(-int(sch["max_seq_len"]) // int(sch["page_size"]))
            keys = [d["n_img"] + s.prompt + i + 1
                    for s, i in zip(call["specs"], call["ticks"])]
            b, f = work.paged_work(int(sch["decode_rows"]), d["H"], d["K"],
                                   d["hd"], int(sch["page_size"]), n_max,
                                   keys, 4)
            flops = self._lm_flops(len(keys), sum(keys), len(keys))
            return [("model", flops, 0),
                    ("paged_decode_attention", d["L"] * f, d["L"] * b)]
        return []

    # -- the check ------------------------------------------------------
    def check(self, kept, finished, seed, control=False):
        """proj_err: the projector's widest gap over its largest
        reference output; cls_err: the same of the classify logits;
        token_gap: the widest gap by which a served token's logit lies
        below the reference's best at its position, over a sample of
        the served requests drawn from the seed, the longest among them.
        With ``control`` the reference at TF32 stands in for the
        program: its projector and logits, and at each position the
        token it puts first."""
        self.release()
        d = self.d
        c = {"d": d["d"], "H": d["H"], "K": d["K"], "hd": d["hd"],
             "eps": d["eps"], "theta": d["theta"]}
        p = nest(draw(layout(self.sizes), seed, self.device))
        images, tokens = self.inputs()
        self.tokens = tokens
        n_pool = images.shape[0]
        prec = "tf32" if control else "float32"
        proj_gap = proj_top = cls_gap = cls_top = 0.0
        gaps = []
        with torch.no_grad():
            for r in sorted(kept):
                x = images[r % n_pool][None]
                want = ref.projector(p["proj"], x, PROJ_EPS)
                got = (ref.projector(p["proj"], x, PROJ_EPS, prec)
                       if control else kept[r]["proj"].float())
                proj_gap = max(proj_gap, float((got - want).abs().max()))
                proj_top = max(proj_top, float(want.abs().max()))
                if "logits" in kept[r]:
                    w_cls = ref.mm(want.mean(-2), p["cls"], "float32")
                    g_cls = (ref.mm(got.mean(-2), p["cls"], prec) if control
                             else kept[r]["logits"].float())
                    cls_gap = max(cls_gap, float((g_cls - w_cls).abs().max()))
                    cls_top = max(cls_top, float(w_cls.abs().max()))
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
                x = ref.projector(p["proj"], images[r % n_pool][None],
                                  PROJ_EPS)[0]
                first = d["n_img"] + len(prompt) - 1
                rows = torch.arange(first, first + len(out),
                                    device=self.device)
                lg = ref.logits_at(p["lm"], c, x, seq, rows)
                if control:
                    lo = ref.logits_at(p["lm"], c, ref.projector(
                        p["proj"], images[r % n_pool][None], PROJ_EPS,
                        prec)[0], seq, rows, prec)
                    chosen = lo.argmax(-1)
                else:
                    chosen = torch.tensor(out, device=self.device)
                best = lg.max(-1).values
                gaps.append(float((best - lg.gather(
                    1, chosen[:, None].long())[:, 0]).max()))
        out = {"proj_err": proj_gap / proj_top if proj_top else float("nan"),
               "token_gap": max(gaps) if gaps else float("nan")}
        if cls_top:
            out["cls_err"] = cls_gap / cls_top
        return out
