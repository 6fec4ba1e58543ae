"""The port's bfloat16 compute held to the reference's: ``build_model(cfg)``
with no options computes in bfloat16 in both packages, and the bundles'
caches default to bfloat16.  For each family at smoke size (tinyllama-1.1b
dense, internvl2-1b vlm with its image prefix, gemma2-9b's window, softcaps
and embed scale, granite-moe-3b-a800m's MoE, deepseek-v3-671b's MLA with
its MTP loss, zamba2-7b hybrid, xlstm-1.3b ssm, whisper-tiny encdec) and
the mini-clip towers at ``dtype=bfloat16``, the same bridged weights
(float32, and bfloat16 for dense and vlm) and the same seeded inputs go
through both packages at their default compute: prefill logits, 3
teacher-forced decode steps on the bundles' default bfloat16 cache, a
paged step where the reference pages, and the loss of tinyllama-1.1b and
deepseek-v3-671b.  Three criteria hold for each output:

* the port is within rtol = atol = 3e-2 of the reference's bfloat16
  (``tests/test_kernels.py``'s bfloat16 ``TOLS``);
* the port rounds where the reference rounds: max |port - ref_f32| is at
  most twice max |ref_bf16 - ref_f32|, plus 1e-3 (ref_f32 the reference
  at ``compute_dtype=float32`` on the same weights);
* the dtype was read: the port's bfloat16 output differs from its own
  float32 one, and its cache leaves have the reference's dtypes,
  bfloat16 among them (xlstm-1.3b's caches are its float32 states
  alone, in both packages).

One tinyllama-1.1b case runs the sharded model at (1, 2) on two gloo
ranks in bfloat16 against the reference's sharded bfloat16 model.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_ref as mref
import torch_mesh_workers as mw
from repro.common.config import ShapeConfig as RefShape
from repro.common.config import get_config as ref_get_config
from repro.configs.s2m3_zoo import CLIP_CONFIGS as REF_CLIP_CONFIGS
from repro.models import clip as JC
from repro.models.api import build_model as ref_build_model
from repro.serving.kvcache import insert_pages as ref_insert_pages
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import ShapeConfig, get_config
from repro_torch.common.pytree import tree_leaves
from repro_torch.configs.s2m3_zoo import get_clip_config
from repro_torch.models import clip as C
from repro_torch.models.api import build_model
from repro_torch.serving.kvcache import insert_pages

TOL = dict(rtol=3e-2, atol=3e-2)
ARCHS = ("tinyllama-1.1b", "internvl2-1b", "gemma2-9b",
         "granite-moe-3b-a800m", "deepseek-v3-671b", "zamba2-7b",
         "xlstm-1.3b", "whisper-tiny")
#: (arch, weight dtype): float32 weights for every family, bfloat16 for
#: dense and vlm
CASES = [(a, "float32") for a in ARCHS] + [
    ("tinyllama-1.1b", "bfloat16"), ("internvl2-1b", "bfloat16")]
LOSS_ARCHS = ("tinyllama-1.1b", "deepseek-v3-671b")
B, S, STEPS = 2, 5, 3


def _case_id(case):
    return f"{case[0].split('-')[0]}-{case[1]}"


def _inputs(cfg):
    """The prefill batch as numpy (image embeddings for a VLM, audio
    frames for whisper), the image prefix's length, the teacher-forced
    decode tokens and a loss batch."""
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    n_prefix = 0
    if cfg.has_vision_stub:
        batch["image_embeds"] = rng.standard_normal(
            (B, cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
        n_prefix = cfg.n_image_tokens
    if cfg.is_encoder_decoder:
        batch["audio_frames"] = (0.1 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    forced = rng.integers(0, cfg.vocab_size, (B, STEPS)).astype(np.int32)
    ids = rng.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    loss = {"tokens": ids[:, :-1], "targets": ids[:, 1:],
            "mask": np.ones((B, S), np.float32)}
    if cfg.has_vision_stub:
        loss["image_embeds"] = batch["image_embeds"]
    return batch, n_prefix, forced, loss


def _paged_scenario(cfg, n_prefix):
    """One live row over shuffled pages with a garbage table tail, one
    dead row on the dummy page 0: (prompt, pages, tables, lengths, the
    step's tokens)."""
    rng = np.random.default_rng(1)
    prompt = rng.integers(0, cfg.vocab_size, (1, 4)).astype(np.int32)
    L = n_prefix + prompt.shape[1]
    return (prompt, [5, 2], np.array([[5, 2, 7, -4], [0, 0, 0, 0]], np.int32),
            np.array([L, 0], np.int32), np.array([[3], [0]], np.int32))


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ref_run(arch, jp, f32: bool) -> dict:
    """The reference's outputs at its default compute (bfloat16, default
    caches), or at ``compute_dtype=float32`` with float32 caches."""
    cfg = ref_get_config(arch, smoke=True)
    jb = ref_build_model(cfg, **({"compute_dtype": jnp.float32} if f32
                                 else {}))
    cdt = (jnp.float32,) if f32 else ()
    prefill, decode = jax.jit(jb.prefill), jax.jit(jb.decode_step)
    batch, n_prefix, forced, loss = _inputs(cfg)
    T = n_prefix + S + STEPS + 1
    jl, jc = prefill(jp, {k: jnp.asarray(v) for k, v in batch.items()},
                     jb.init_cache(B, T, *cdt))
    out = {"prefill": _np(jl)}
    lens = jnp.full((B,), n_prefix + S, jnp.int32)
    for i in range(STEPS):
        jl, jc = decode(jp, jnp.asarray(forced[:, i:i + 1]), jc, lens)
        out[f"decode{i}"] = _np(jl)
        lens = lens + 1
    out["cache_dtypes"] = [jnp.dtype(x.dtype).name
                           for _, x in mref.leaf_paths(jc)]
    if jb.paged_decode_step is not None:
        prompt, pages, tables, plens, tok = _paged_scenario(cfg, n_prefix)
        pb = {"tokens": jnp.asarray(prompt)}
        if cfg.has_vision_stub:
            pb["image_embeds"] = jnp.asarray(batch["image_embeds"][:1])
        span = len(pages) * 8
        _, jd = prefill(jp, pb, jb.init_cache(1, span, *cdt))
        pool = ref_insert_pages(jb.init_paged_cache(9, 8, *cdt), jd, pages,
                                int(plens[0]))
        jl, _ = jax.jit(jb.paged_decode_step)(
            jp, jnp.asarray(tok), pool, jnp.asarray(tables),
            jnp.asarray(plens))
        out["paged"] = _np(jl)[:1]
    if arch in LOSS_ARCHS:
        lv, _ = jax.jit(jb.loss_fn)(jp, {k: jnp.asarray(v)
                                         for k, v in loss.items()})
        out["loss"] = _np(lv)
    return out


def _port_run(arch, tp, f32: bool) -> dict:
    """The port's outputs, as ``_ref_run``'s."""
    cfg = get_config(arch, smoke=True)
    tb = build_model(cfg, **({"compute_dtype": torch.float32} if f32
                             else {}))
    cdt = {"dtype": torch.float32} if f32 else {}
    batch, n_prefix, forced, loss = _inputs(cfg)
    T = n_prefix + S + STEPS + 1
    with torch.no_grad():
        tl, tc = tb.prefill(tp, {k: torch.from_numpy(v)
                                 for k, v in batch.items()},
                            tb.init_cache(B, T, device="cpu", **cdt))
        out = {"prefill": tl.float().numpy()}
        lens = torch.full((B,), n_prefix + S, dtype=torch.int32)
        for i in range(STEPS):
            tl, tc = tb.decode_step(tp, torch.from_numpy(forced[:, i:i + 1]),
                                    tc, lens)
            out[f"decode{i}"] = tl.float().numpy()
            lens = lens + 1
        out["cache_dtypes"] = [str(x.dtype).removeprefix("torch.")
                               for _, x in mref.leaf_paths(tc)]
        if ref_build_model(ref_get_config(arch, smoke=True)) \
                .paged_decode_step is not None:
            prompt, pages, tables, plens, tok = _paged_scenario(cfg, n_prefix)
            pb = {"tokens": torch.from_numpy(prompt)}
            if cfg.has_vision_stub:
                pb["image_embeds"] = torch.from_numpy(
                    batch["image_embeds"][:1])
            span = len(pages) * 8
            _, td = tb.prefill(tp, pb, tb.init_cache(1, span, device="cpu",
                                                     **cdt))
            pool = insert_pages(tb.init_paged_cache(9, 8, device="cpu", **cdt),
                                td, pages, int(plens[0]))
            tl, _ = tb.paged_decode_step(tp, torch.from_numpy(tok), pool,
                                         torch.from_numpy(tables),
                                         torch.from_numpy(plens))
            out["paged"] = tl.float().numpy()[:1]
        if arch in LOSS_ARCHS:
            lv, _ = tb.loss_fn(tp, {k: torch.from_numpy(v)
                                    for k, v in loss.items()})
            out["loss"] = lv.float().numpy()
    return out


_RUNS: dict = {}


def _runs(case):
    """(port bf16, port f32, reference bf16, reference f32) for a case,
    computed once for the module's tests."""
    if case not in _RUNS:
        arch, wdt = case
        cfg = ref_get_config(arch, smoke=True)
        jp = ref_build_model(cfg).init(jax.random.PRNGKey(0))
        if wdt == "bfloat16":
            jp = jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _RUNS[case] = (_port_run(arch, tp, False), _port_run(arch, tp, True),
                       _ref_run(arch, jp, False), _ref_run(arch, jp, True))
    return _RUNS[case]


def _outputs(run):
    return [k for k in run if k != "cache_dtypes"]


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_bf16_matches_reference_bf16(case):
    port, _, ref, _ = _runs(case)
    assert _outputs(port) == _outputs(ref)
    for k in _outputs(ref):
        assert np.isfinite(port[k]).all(), k
        np.testing.assert_allclose(port[k], ref[k], **TOL, err_msg=k)


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_bf16_rounds_where_the_reference_rounds(case):
    port, _, ref, ref32 = _runs(case)
    for k in _outputs(ref):
        ref_err = np.abs(ref[k] - ref32[k]).max()
        assert np.abs(port[k] - ref32[k]).max() <= 2 * ref_err + 1e-3, k


@pytest.mark.parametrize("case", CASES, ids=[_case_id(c) for c in CASES])
def test_compute_and_cache_dtype_were_read(case):
    port, port32, ref, _ = _runs(case)
    assert np.abs(port["prefill"] - port32["prefill"]).max() > 0
    assert port["cache_dtypes"] == ref["cache_dtypes"]
    assert set(port32["cache_dtypes"]) == {"float32"}
    # xlstm-1.3b's caches are its float32 states alone, in both packages
    assert ("bfloat16" in port["cache_dtypes"]) == \
        (case[0] != "xlstm-1.3b")


@pytest.mark.parametrize("arch", ["internvl2-1b", "whisper-tiny"])
def test_build_model_defaults_to_the_references_dtype(arch):
    """With no options both packages compute in bfloat16: the batch's
    float inputs and the cache leaves are bfloat16 in each, the port's
    bundle names it, and "bfloat16" / "float32" are read as names."""
    jb = ref_build_model(ref_get_config(arch, smoke=True))
    cfg = get_config(arch, smoke=True)
    tb = build_model(cfg)
    assert tb.compute_dtype == torch.bfloat16
    assert build_model(cfg, compute_dtype="float32").compute_dtype == \
        torch.float32
    with pytest.raises(ValueError, match="compute_dtype"):
        build_model(cfg, compute_dtype="float16")
    shape = ("p", "prefill", 2, 64)
    want = {k: jnp.dtype(ws.dtype).name
            for k, ws in jb.batch_specs(RefShape(*shape)).items()}
    got = {k: str(ws.dtype).removeprefix("torch.")
           for k, ws in tb.batch_specs(ShapeConfig(*shape)).items()}
    assert got == want and "bfloat16" in got.values()
    assert {str(ws.dtype) for ws in tree_leaves(tb.cache_specs(1, 8))} == \
        {"torch.bfloat16"}
    assert {jnp.dtype(ws.dtype).name for ws in jax.tree.leaves(
        jb.cache_specs(1, 8), is_leaf=lambda x: hasattr(x, "axes"))} == \
        {"bfloat16"}


@pytest.fixture(scope="module")
def clip_runs():
    jcfg = REF_CLIP_CONFIGS["mini-clip"]
    cfg = get_clip_config("mini-clip")
    jp = jax.tree.map(np.asarray, JC.init_clip(jax.random.PRNGKey(0), jcfg))
    jp["logit_scale"] = np.asarray(np.log(1 / 0.07), np.float32)
    tp = params_from_numpy(jp, "cpu")
    rng = np.random.default_rng(3)
    patches = rng.standard_normal(
        (3, cfg.n_image_tokens, cfg.vision_width)).astype(np.float32)
    ids = rng.integers(0, cfg.vocab_size, (3, 12)).astype(np.int32)
    tpatch, tids = torch.from_numpy(patches), torch.from_numpy(ids)

    def port(dt):
        return {"encode_image": C.encode_image(tp["vision"], tpatch, cfg,
                                               dtype=dt),
                "encode_text": C.encode_text(tp["text"], tids, cfg, dtype=dt),
                "clip_forward": C.clip_forward(tp, tpatch, tids, cfg,
                                               dtype=dt)}

    def ref(dt):
        return {"encode_image": JC.encode_image(jp["vision"], patches, jcfg,
                                                dt),
                "encode_text": JC.encode_text(jp["text"], ids, jcfg, dt),
                "clip_forward": JC.clip_forward(jp, patches, ids, jcfg, dt)}

    return ({k: v.float().numpy() for k, v in port(torch.bfloat16).items()},
            {k: v.float().numpy() for k, v in port(torch.float32).items()},
            {k: _np(v) for k, v in ref(jnp.bfloat16).items()},
            {k: _np(v) for k, v in ref(jnp.float32).items()})


@pytest.mark.parametrize("what", ["encode_image", "encode_text",
                                  "clip_forward"])
def test_clip_towers_bf16_match_reference(clip_runs, what):
    port, port32, ref, ref32 = clip_runs
    np.testing.assert_allclose(port[what], ref[what], **TOL)
    ref_err = np.abs(ref[what] - ref32[what]).max()
    assert np.abs(port[what] - ref32[what]).max() <= 2 * ref_err + 1e-3
    assert np.abs(port[what] - port32[what]).max() > 0


def test_init_clip_draws_in_the_asked_dtype():
    p = C.init_clip(torch.Generator().manual_seed(0),
                    get_clip_config("mini-clip"), "cpu", dtype=torch.bfloat16)
    assert {t.dtype for t in tree_leaves(p)} == {torch.bfloat16}


def test_sharded_bf16_matches_reference_sharded_bf16(tmp_path):
    """tinyllama-1.1b at (1, 2) on two gloo ranks, built with the default
    compute and caches (bfloat16) on both sides, prefill and 3
    teacher-forced decode steps."""
    case = dict(arch="tinyllama-1.1b", mesh=[1, 2], T=16, steps=STEPS,
                rules=None, opts={}, bf16=True)
    params = {case["arch"]: mref.model_params(case["arch"])}
    ref, port = mw.run_cases("model", mw.model_worker, [case], tmp_path,
                             params)
    got, want = port["0/logits"], ref["0/logits"]
    assert got.shape == want.shape == (STEPS + 1, B, want.shape[-1])
    np.testing.assert_allclose(got, want, **TOL)
