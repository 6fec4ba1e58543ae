"""The port's encoder-decoder model (whisper-tiny smoke, float32) held
to the JAX package's ``build_encdec`` on bridged weights: prefill
logits, every decode step's logits and the greedy tokens at float32
2e-4; decode equals a fresh prefill within 5e-4; the cross-attention
layer against the reference's; the launcher serves whisper-tiny with
its audio frames; and ``arch_model_spec`` of the full whisper-tiny and
tinyllama-1.1b configs equals the reference's (specs only, no init)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.common.config import get_config as ref_get_config
from repro.layers import attention as jattn
from repro.models.api import build_model as ref_build_model
from repro_torch.common.bridge import params_from_numpy
from repro_torch.common.config import get_config
from repro_torch.common.pytree import tree_leaves
from repro_torch.layers import attention as tattn
from repro_torch.models.api import build_model

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = 5e-4
ARCH = "whisper-tiny"


@pytest.fixture(scope="module")
def models():
    cfg = ref_get_config(ARCH, smoke=True)
    jb = ref_build_model(cfg, compute_dtype=jnp.float32)
    jp = jb.init(jax.random.PRNGKey(0))
    tb = build_model(get_config(ARCH, smoke=True), compute_dtype=torch.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return cfg, jb, jp, tb, tp


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def _frames(cfg, B, seed=0):
    return (0.1 * np.random.default_rng(seed).standard_normal(
        (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)


def test_specs_param_count_and_cache_layout_match_reference(models):
    cfg, jb, jp, tb, tp = models
    assert tb.param_count() == jb.param_count()
    init = tb.init(torch.Generator().manual_seed(0), device="cpu")
    assert sorted(tuple(x.shape) for x in tree_leaves(init)) == \
        sorted(tuple(x.shape) for x in jax.tree.leaves(jp))
    tc = tb.init_cache(2, 24, device="cpu", dtype=torch.float32)
    jc = jb.init_cache(2, 24, jnp.float32)
    for part in ("self", "cross"):
        for kv in ("k", "v"):
            assert tuple(tc[part][kv].shape) == tuple(jc[part][kv].shape)
    assert tuple(tc["cross"]["k"].shape[2:]) == (cfg.encoder_seq,
                                                 cfg.n_kv_heads, cfg.head_dim)
    assert tb.paged_decode_step is None and tb.paged_cache_specs is None
    assert callable(tb.loss_fn)


def test_prefill_then_decode_matches_reference(models):
    """Two rows with ragged prompts (5 and 3 tokens), then four greedy
    decode steps; the caches after prefill too."""
    cfg, jb, jp, tb, tp = models
    frames = _frames(cfg, 2)
    toks = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 5)).astype(np.int32)
    lens = np.array([5, 3], np.int32)
    T = 16
    jc = jb.init_cache(2, T, jnp.float32)
    jl, jc = jb.prefill(jp, {"tokens": jnp.asarray(toks),
                             "lengths": jnp.asarray(lens),
                             "audio_frames": jnp.asarray(frames)}, jc)
    tc = tb.init_cache(2, T, device="cpu", dtype=torch.float32)
    tl, tc = tb.prefill(tp, {"tokens": torch.from_numpy(toks),
                             "lengths": torch.from_numpy(lens),
                             "audio_frames": torch.from_numpy(frames)}, tc)
    _close(tl, jl)
    _close(tc["cross"]["k"], jc["cross"]["k"])
    _close(tc["self"]["v"], jc["self"]["v"])
    nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
    np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt[:, 0])
    for _ in range(4):
        jl, jc = jb.decode_step(jp, jnp.asarray(nxt), jc, jnp.asarray(lens))
        tl, tc = tb.decode_step(tp, torch.from_numpy(nxt), tc,
                                torch.from_numpy(lens))
        _close(tl, jl)
        nxt = np.array(jnp.argmax(jl, -1), np.int32)[:, None]
        np.testing.assert_array_equal(tl.argmax(-1).numpy(), nxt[:, 0])
        lens = lens + 1


def test_decode_equals_fresh_prefill(models):
    cfg, _, _, tb, tp = models
    frames = torch.from_numpy(_frames(cfg, 1, seed=2))
    prompt = [3, 17, 40]
    cache = tb.init_cache(1, 16, device="cpu", dtype=torch.float32)
    logits, cache = tb.prefill(tp, {"tokens": torch.tensor([prompt]),
                                    "audio_frames": frames}, cache)
    toks = list(prompt)
    for _ in range(4):
        toks.append(int(logits[0].argmax()))
        logits, cache = tb.decode_step(
            tp, torch.tensor([[toks[-1]]], dtype=torch.int32), cache,
            torch.tensor([len(toks) - 1], dtype=torch.int32))
        fresh, _ = tb.prefill(tp, {"tokens": torch.tensor([toks]),
                                   "audio_frames": frames},
                              tb.init_cache(1, 16, device="cpu",
                                            dtype=torch.float32))
        assert (logits - fresh).abs().max().item() <= DECODE_TOL


def test_cross_attention_matches_reference():
    """Prefill cross-attention (S queries against T encoder keys, through
    the flash kernel's plain version) and one decode step's (through the
    decode kernel's plain version) against the reference's plain
    ``attention_apply(cross_kv=...)``."""
    cfg = ref_get_config(ARCH, smoke=True)
    rng = np.random.default_rng(5)
    d, H, D = cfg.d_model, cfg.n_heads, cfg.head_dim
    p = {"wq": 0.2 * rng.standard_normal((d, H, D)),
         "wk": 0.2 * rng.standard_normal((d, H, D)),
         "wv": 0.2 * rng.standard_normal((d, H, D)),
         "wo": 0.2 * rng.standard_normal((H, D, d))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    enc = rng.standard_normal((2, cfg.encoder_seq, d)).astype(np.float32)
    tp = params_from_numpy(p, "cpu")
    tk, tv = tattn.cross_kv_project(tp, torch.from_numpy(enc), cfg)
    jk, jv = jattn.cross_kv_project(p, jnp.asarray(enc), cfg)
    _close(tk, jk)
    enc_pos = jnp.broadcast_to(jnp.arange(cfg.encoder_seq), (2, cfg.encoder_seq))
    for S in (5, 1):
        x = rng.standard_normal((2, S, d)).astype(np.float32)
        pos = jnp.broadcast_to(jnp.arange(S), (2, S))
        want, _ = jattn.attention_apply(p, jnp.asarray(x), positions=pos,
                                        cfg=cfg, cross_kv=(jk, jv),
                                        cross_positions=enc_pos)
        got, _ = tattn.attention_apply(
            tp, torch.from_numpy(x), positions=torch.from_numpy(
                np.array(pos, np.int32)), cfg=cfg, cross_kv=(tk, tv))
        _close(got, want)
        if S == 1:
            _close(tattn.cross_attention_decode(tp, torch.from_numpy(x),
                                                tk, tv, cfg), want)


def test_serve_launcher_feeds_audio_frames():
    from repro_torch.launch import serve as tserve

    cfg = get_config(ARCH, smoke=True)
    reqs = tserve.make_requests(cfg, 2, 3, seed=0)
    assert all(r.inputs["audio"].shape == (cfg.encoder_seq, cfg.d_model)
               for r in reqs)
    run = tserve.serve_arch(cfg, reqs, device="cpu")
    assert [len(r.output) for r in run.results] == [3, 3]
    assert run.decode_steps == 4
    rt = next(iter(run.engine.decoders.values()))
    assert rt.bundle.cfg.is_encoder_decoder
    # each request's frames reached prefill: its first token is the
    # argmax of a prefill over its own frames, whose logits differ from
    # those over silent (zero) frames
    b = rt.bundle
    for req, res in zip(reqs, run.results):
        def first_logits(frames, req=req):
            lg, _ = b.prefill(rt.params, {
                "tokens": torch.tensor([req.prompt], dtype=torch.int32),
                "audio_frames": torch.as_tensor(frames)[None]},
                b.init_cache(1, 16, device="cpu", dtype=torch.float32))
            return lg[0]
        lg = first_logits(req.inputs["audio"])
        assert int(lg.argmax()) == int(res.output[0])
        silent = first_logits(np.zeros_like(req.inputs["audio"]))
        assert (lg - silent).abs().max().item() > 1e-3


@pytest.mark.parametrize("arch", [ARCH, "tinyllama-1.1b"])
def test_arch_model_spec_matches_reference(arch):
    from repro.core.zoo import arch_model_spec as ref_spec
    from repro_torch.core.zoo import arch_model_spec

    want = ref_spec(ref_get_config(arch))
    got = arch_model_spec(get_config(arch))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.task == ("asr" if arch == ARCH else "text-gen")
    assert [m.name for m in got.modules] == [m.name for m in want.modules]


def test_full_whisper_tiny_param_count_matches_reference():
    """Specs only: the full config's count, no init."""
    want = ref_build_model(ref_get_config(ARCH)).param_count()
    assert build_model(get_config(ARCH)).param_count() == want == 41_314_176
