"""clip-vit-b16-mt: the S2M3 paper's multi-task scenario on CLIP
ViT-B/16's published widths, served by the port.

Three tasks share both towers (the paper's split and share):
retrieval (image and text, the cosine head), classify (image, a 512 ->
1000 linear head) and vqa (image and question, a 1024 -> 3129 linear
head over the two embeddings).  The towers are ``repro_torch.models.clip``
at the sizes of ``clip-vit-b16-mt.json``; the heads are written here, as
a deployment's builders are.  Every module lives on the one card.
"""

from __future__ import annotations

from functools import partial

import torch

from portbench import work
from portbench.bench import BaseBench, same_shapes
from portbench.reference import clip as ref
from portbench.traffic import Spec
from portbench.weights import draw, n_params, nest

VISION, TEXT = "clip-vit-b16", "clip-text-b16"
HEADS = {"retrieval": "cosine", "classify": "cls-1000", "vqa": "vqa-3129"}
#: the port's text tower holds this many learned positions
TEXT_POSITIONS = 512
WARM_RID = 1_000_000_000


def dims(sizes: dict) -> dict:
    v, t = sizes["vision_config"], sizes["text_config"]
    for c in (v, t):
        if c["intermediate_size"] != 4 * c["hidden_size"]:
            raise ValueError("the port's tower MLP is 4 x its width")
    return {
        "vw": v["hidden_size"], "vh": v["num_attention_heads"],
        "vl": v["num_hidden_layers"],
        "vt": (v["image_size"] // v["patch_size"]) ** 2 + 1,
        "tw": t["hidden_size"], "th": t["num_attention_heads"],
        "tl": t["num_hidden_layers"], "vocab": t["vocab_size"],
        "ctx": t["max_position_embeddings"], "e": sizes["projection_dim"],
        "eps": v["layer_norm_eps"],
        "classes": sizes["tasks"]["classify"]["classes"],
        "answers": sizes["tasks"]["vqa"]["classes"],
    }


def _tower_layout(prefix, L, w, H):
    hd = w // H
    s, s4 = w ** -0.5, (4 * w) ** -0.5
    b = prefix + ("blocks",)
    return [
        (b + ("ln1", "scale"), (L, w), "ones"),
        (b + ("ln1", "bias"), (L, w), "zeros"),
        (b + ("attn", "wq"), (L, w, H, hd), s),
        (b + ("attn", "wk"), (L, w, H, hd), s),
        (b + ("attn", "wv"), (L, w, H, hd), s),
        (b + ("attn", "wo"), (L, H, hd, w), s),
        (b + ("ln2", "scale"), (L, w), "ones"),
        (b + ("ln2", "bias"), (L, w), "zeros"),
        (b + ("mlp", "wi_gate"), (L, w, 4 * w), s),
        (b + ("mlp", "wi_up"), (L, w, 4 * w), s),
        (b + ("mlp", "wo"), (L, 4 * w, w), s4),
    ]


def layout(sizes: dict) -> list:
    """Every weight, by the port's names: (path, shape, std)."""
    d = dims(sizes)
    vw, tw, e = d["vw"], d["tw"], d["e"]
    return [
        (("clip", "vision", "patch_proj"), (vw, vw), vw ** -0.5),
        (("clip", "vision", "pos"), (d["vt"], vw), 0.02),
        *_tower_layout(("clip", "vision"), d["vl"], vw, d["vh"]),
        (("clip", "vision", "ln_post", "scale"), (vw,), "ones"),
        (("clip", "vision", "ln_post", "bias"), (vw,), "zeros"),
        (("clip", "vision", "proj"), (vw, e), vw ** -0.5),
        (("clip", "text", "embed", "table"), (d["vocab"], tw), 0.02),
        (("clip", "text", "pos"), (TEXT_POSITIONS, tw), 0.02),
        *_tower_layout(("clip", "text"), d["tl"], tw, d["th"]),
        (("clip", "text", "ln_final", "scale"), (tw,), "ones"),
        (("clip", "text", "ln_final", "bias"), (tw,), "zeros"),
        (("clip", "text", "proj"), (tw, e), tw ** -0.5),
        (("clip", "logit_scale"), (), "zeros"),
        (("cls",), (e, d["classes"]), e ** -0.5),
        (("vqa",), (2 * e, d["answers"]), (2 * e) ** -0.5),
    ]


class Bench(BaseBench):
    def __init__(self, sizes, mix, seed, device):
        super().__init__(sizes, mix, seed, device)
        from repro_torch.core.cluster import ClusterSpec, DeviceSpec
        from repro_torch.core.module import ModelSpec, ModuleSpec
        from repro_torch.models import clip as C
        from repro_torch.s2m3 import Deployment

        d = self.d = dims(sizes)
        self.ccfg = C.ClipConfig(
            name=sizes["name"], vision_layers=d["vl"], vision_width=d["vw"],
            vision_heads=d["vh"], text_layers=d["tl"], text_width=d["tw"],
            text_heads=d["th"], vocab_size=d["vocab"], embed_dim=d["e"],
            n_image_tokens=d["vt"], norm_eps=d["eps"])
        lay = layout(sizes)
        tree = nest(draw(lay, seed, self.device))
        same_shapes(tree["clip"], C.clip_specs(self.ccfg), "clip")
        p = tree["clip"]
        n_v = n_params([x for x in lay if x[0][1:2] == ("vision",)])
        n_t = n_params([x for x in lay if x[0][1:2] == ("text",)])
        vis = ModuleSpec(VISION, "encoder", "vision", n_v, 4.0,
                         flops_per_query=self._vision_flops(1),
                         input_bytes=d["vt"] * d["vw"] * 4,
                         output_bytes=d["e"] * 4)
        txt = ModuleSpec(TEXT, "encoder", "text", n_t, 4.0,
                         flops_per_query=self._text_flops(1),
                         input_bytes=d["ctx"] * 4, output_bytes=d["e"] * 4)
        heads = {
            "retrieval": ModuleSpec("cosine", "head", "task", 1, 4.0,
                                    flops_per_query=2.0 * d["e"]),
            "classify": ModuleSpec("cls-1000", "head", "task",
                                   d["e"] * d["classes"], 4.0,
                                   flops_per_query=2.0 * d["e"]
                                   * d["classes"]),
            "vqa": ModuleSpec("vqa-3129", "head", "task",
                              2 * d["e"] * d["answers"], 4.0,
                              flops_per_query=4.0 * d["e"] * d["answers"]),
        }
        builders = {
            VISION: lambda: (partial(C.encode_image, cfg=self.ccfg),
                             p["vision"]),
            TEXT: lambda: (partial(C.encode_text, cfg=self.ccfg), p["text"]),
            "cosine": lambda: (lambda ls, enc: C.retrieval_logits(
                enc["vision"], enc["text"], ls), p["logit_scale"]),
            "cls-1000": lambda: (lambda w, enc: enc["vision"] @ w,
                                 tree["cls"]),
            "vqa-3129": lambda: (lambda w, enc: torch.cat(
                [enc["vision"], enc["text"]], -1) @ w, tree["vqa"]),
        }
        cluster = ClusterSpec(devices=[DeviceSpec(
            "h100", int(work.HBM_BYTES), work.PEAK_FLOPS_F32, kind="server")])
        dep = Deployment(cluster)
        for task, head in heads.items():
            encs = (vis, txt) if task != "classify" else (vis,)
            dep.add_model(ModelSpec(task, task, encs, head), builders)
        self.dep = dep.plan("greedy", routing="queue_aware").materialize(
            device=self.device)
        self.images, self.texts = self.inputs()

    # -- inputs ---------------------------------------------------------
    def inputs(self):
        """The pool: stub patch embeddings and 77-token texts."""
        d, n = self.d, int(self.mix.get("pool", 256))
        g = self.generator("inputs")
        images = torch.randn(n, d["vt"], d["vw"], generator=g,
                             device=self.device)
        texts = torch.randint(0, d["vocab"], (n, d["ctx"]), generator=g,
                              device=self.device, dtype=torch.int32)
        return images, texts

    def _items(self, rid: int) -> tuple[int, int]:
        n = self.images.shape[0]
        return rid % n, (rid * 7 + 3) % n

    def request(self, spec: Spec):
        from repro_torch.s2m3 import Request

        i, j = self._items(spec.rid)
        inputs = {"vision": self.images[i:i + 1]}
        if spec.task != "classify":
            inputs["text"] = self.texts[j:j + 1]
        return Request(spec.rid, spec.task, "h100", inputs=inputs)

    def warm_groups(self):
        """Each encoder batch size up to ``max_batch``, each head."""
        top = int(self.mix.get("scheduler", {}).get("max_batch", 8))
        rid = WARM_RID
        groups = []
        for k in range(1, top + 1):
            groups.append([self.request(Spec(rid + i, "retrieval", 0, 0))
                           for i in range(k)])
            rid += k
        for task in ("classify", "vqa"):
            groups.append([self.request(Spec(rid, task, 0, 0))])
            rid += 1
        return groups

    def keep(self, result):
        enc = result.encoder_outputs
        return {k: v.detach().clone() for k, v in
                (("vision", enc["vision"]), ("text", enc.get("text")),
                 ("out", result.output)) if v is not None}

    # -- work -----------------------------------------------------------
    def _vision_flops(self, k: int) -> float:
        d = self.d
        tok = k * d["vt"]
        return (work.gemm_flops(tok, d["vw"], d["vw"])
                + d["vl"] * work.attn_block_flops(
                    tok, d["vw"], d["vh"], d["vh"], d["vw"] // d["vh"],
                    4 * d["vw"], True)
                + d["vl"] * work.attn_pair_flops(k * d["vt"] ** 2, d["vh"],
                                                 d["vw"] // d["vh"])
                + work.gemm_flops(k, d["vw"], d["e"]))

    def _text_flops(self, k: int) -> float:
        d = self.d
        S = d["ctx"]
        return (d["tl"] * work.attn_block_flops(
                    k * S, d["tw"], d["th"], d["th"], d["tw"] // d["th"],
                    4 * d["tw"], True)
                + d["tl"] * work.attn_pair_flops(k * S * (S + 1) / 2, d["th"],
                                                 d["tw"] // d["th"])
                + work.gemm_flops(k, d["tw"], d["e"]))

    def call_work(self, call) -> list:
        """[(kind, flops, bytes)] of one device call: "model" for its
        FLOPs as a whole, a kernel's name for that kernel's launches."""
        d, k = self.d, len(call["rids"])
        if call["module"] == VISION:
            hd = d["vw"] // d["vh"]
            b, f = work.flash_work(k, d["vt"], d["vt"], d["vh"], d["vh"], hd,
                                   False, 4)
            return [("model", self._vision_flops(k), 0),
                    ("flash_attention", d["vl"] * f, d["vl"] * b)]
        if call["module"] == TEXT:
            hd = d["tw"] // d["th"]
            b, f = work.flash_work(k, d["ctx"], d["ctx"], d["th"], d["th"],
                                   hd, True, 4)
            return [("model", self._text_flops(k), 0),
                    ("flash_attention", d["tl"] * f, d["tl"] * b)]
        head = {"cosine": 2.0 * d["e"],
                "cls-1000": work.gemm_flops(1, d["e"], d["classes"]),
                "vqa-3129": work.gemm_flops(1, 2 * d["e"], d["answers"])}
        return [("model", head.get(call["module"], 0.0), 0)]

    # -- the check ------------------------------------------------------
    def reference(self, rids, tasks, seed, precision):
        """The reference's embeddings and head outputs of ``rids``."""
        d = self.d
        p = nest(draw(layout(self.sizes), seed, self.device))
        images, texts = self.inputs()
        out = {}
        with torch.no_grad():
            for a in range(0, len(rids), 16):
                chunk = rids[a:a + 16]
                ij = [self._items(r) for r in chunk]
                zi = ref.encode_image(p["clip"]["vision"],
                                      images[[i for i, _ in ij]], d["vh"],
                                      d["eps"], precision)
                zt = ref.encode_text(p["clip"]["text"],
                                     texts[[j for _, j in ij]], d["th"],
                                     d["eps"], precision)
                for n, r in enumerate(chunk):
                    vi, vt = zi[n:n + 1], zt[n:n + 1]
                    task = tasks[r]
                    if task == "retrieval":
                        o = ref.retrieval(vi, vt, p["clip"]["logit_scale"],
                                          precision)
                    elif task == "classify":
                        o = ref.linear(vi, p["cls"], precision)
                    else:
                        o = ref.linear(torch.cat([vi, vt], -1), p["vqa"],
                                       precision)
                    out[r] = {"vision": vi, "out": o}
                    if task != "classify":
                        out[r]["text"] = vt
        return out

    def check(self, kept, finished, seed, control=False):
        """tower_err: the widest gap of an embedding (unit vectors) from
        the reference's; head_err: each head's widest gap over its
        largest reference output, the worst head.  With ``control`` the
        reference at TF32 stands in for the program."""
        self.release()
        rids = sorted(kept)
        tasks = {r: finished[r].spec.task for r in rids}
        want = self.reference(rids, tasks, seed, "float32")
        got = (self.reference(rids, tasks, seed, "tf32") if control
               else kept)
        tower = 0.0
        per_head: dict = {}
        for r in rids:
            for key in ("vision", "text"):
                if key in want[r]:
                    tower = max(tower, float(
                        (got[r][key].float() - want[r][key]).abs().max()))
            gap, top = per_head.get(tasks[r], (0.0, 0.0))
            per_head[tasks[r]] = (
                max(gap, float((got[r]["out"].float()
                                - want[r]["out"]).abs().max())),
                max(top, float(want[r]["out"].abs().max())))
        head = max((g / t for g, t in per_head.values() if t > 0),
                   default=float("nan"))
        return {"tower_err": tower, "head_err": head}
