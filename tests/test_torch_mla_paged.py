"""DeepSeek-V3's serving path in the port, held to the plain reference
``tests/plain_dsv3.py`` at smoke size on seeded random weights: MLA's
latent pages and their absorbed decode (``ops.paged_mla_decode``,
whose plain version runs here), the noaux_tc router over a rank's held
experts, YaRN, and an image prefix that goes in with no further map —
the configuration dots.vlm1's head runs in ``portbench``.

Tolerances: float32 rtol = atol = 2e-4 (``TOLS`` of
``tests/test_kernels.py``): the absorbed form and the reference's
rebuilt keys and values sum in other orders; greedy tokens exact; the
router's choices exact (no near-tie at these seeds)."""

import dataclasses
import math

import numpy as np
import pytest
import torch

import plain_dsv3 as ref
from repro_torch.common.config import ArchConfig, Yarn
from repro_torch.kernels import ops
from repro_torch.launch.serve import make_requests, serve_arch
from repro_torch.layers import mla as tmla
from repro_torch.layers import moe as tmoe
from repro_torch.layers import rope as trope
from repro_torch.layers.initializers import init_tree
from repro_torch.models.api import build_model

TOL = dict(rtol=2e-4, atol=2e-4)
#: dots.vlm1's published rope_scaling (DeepSeek-V3's)
YARN = dict(factor=40, original_max_position_embeddings=4096, beta_fast=32,
            beta_slow=1, mscale=1, mscale_all_dim=1)


def _cfg(**kw) -> ArchConfig:
    """DeepSeek-V3's layer kinds at smoke widths: 1 dense + 2 MoE layers,
    32 routed experts in 4 groups (2 kept), top-4, 8 held from expert 8,
    YaRN over 64 original positions, a 6-token image prefix."""
    base = dict(
        name="dots-smoke", family="moe", n_layers=3, d_model=64, n_heads=4,
        n_kv_heads=4, d_ff=32, vocab_size=256, head_dim=16, n_experts=32,
        experts_top_k=4, n_shared_experts=1, moe_d_ff=32,
        first_dense_layers=1, dense_d_ff=96, use_mla=True, q_lora_rank=32,
        kv_lora_rank=16, qk_rope_dim=8, qk_nope_dim=16, v_head_dim=16,
        moe_router="noaux_tc", n_group=4, topk_group=2,
        routed_scaling_factor=2.5, experts_held=8, experts_offset=8,
        rope_yarn=Yarn(40.0, 64, 32, 1), norm_eps=1e-6,
        has_vision_stub=True, n_image_tokens=6, image_proj=False)
    base.update(kw)
    return ArchConfig(**base)


def _c(cfg) -> dict:
    """The reference's view of ``cfg``."""
    return dict(H=cfg.n_heads, nope=cfg.qk_nope_dim, rope=cfg.qk_rope_dim,
                v=cfg.v_head_dim, eps=cfg.norm_eps, theta=cfg.rope_theta,
                yarn=dataclasses.asdict(cfg.rope_yarn),
                n_group=cfg.n_group, topk_group=cfg.topk_group,
                top_k=cfg.experts_top_k,
                routed_scale=cfg.routed_scaling_factor,
                e0=cfg.experts_offset)


def _params(cfg, seed=0):
    """Random weights, the correction bias drawn too (it is zeros at
    init) so that it moves the choice."""
    b = build_model(cfg, compute_dtype=torch.float32)
    p = b.init(torch.Generator().manual_seed(seed), device="cpu")
    bias = p["stages"]["moe"]["blocks"]["moe"]["e_score_correction_bias"]
    bias.copy_(0.05 * torch.randn(bias.shape,
                                  generator=torch.Generator().manual_seed(9)))
    return b, p


@pytest.fixture(scope="module")
def model():
    cfg = _cfg()
    b, p = _params(cfg)
    return cfg, b, p


def test_yarn_frequencies_and_scales_follow_the_published_formulas():
    """At DeepSeek-V3's settings (rope dim 64, theta 1e4): the ramp runs
    between dims 10 and 23 of 32; below it theta's frequencies, above it
    theirs over 40; cos/sin unscaled (mscale = mscale_all_dim); the
    softmax scale 192^-0.5 (0.1 ln 40 + 1)^2."""
    yarn = Yarn(**YARN)
    got = trope.rope_freqs(64, 1e4, yarn=yarn)
    want = ref.inv_freq(64, 1e4, YARN)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)
    plain = trope.rope_freqs(64, 1e4)
    assert ref.yarn_find_correction_range(32, 1, 64, 1e4, 4096) == (10, 23)
    torch.testing.assert_close(got[:11], plain[:11], rtol=0, atol=0)
    torch.testing.assert_close(got[23:], plain[23:] / 40, rtol=1e-6, atol=0)
    assert (got[11:23] < plain[11:23]).all() and \
        (got[11:23] > plain[11:23] / 40).all()
    cfg = _cfg(qk_nope_dim=128, qk_rope_dim=64, rope_yarn=yarn)
    want_scale = 192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2
    assert tmla.softmax_scale(cfg) == pytest.approx(want_scale, rel=1e-12)
    assert ref.softmax_scale(dict(nope=128, rope=64, yarn=YARN)) == \
        pytest.approx(want_scale, rel=1e-12)
    # cos/sin scale mscale(40, m) / mscale(40, m_all): 1 at dots.vlm1's
    # settings, and the published ratio where they differ
    x = torch.randn(5, 3, 8, generator=torch.Generator().manual_seed(1))
    pos = torch.arange(5)
    for m, mad in ((1.0, 1.0), (0.707, 1.0)):
        y = Yarn(40.0, 64, 32, 1, m, mad)
        c = dict(theta=1e4, yarn=dict(YARN, original_max_position_embeddings=64,
                                      mscale=m, mscale_all_dim=mad))
        torch.testing.assert_close(trope.apply_rope(x, pos, 1e4, y),
                                   ref.rope(x, pos, c), **TOL)
    assert ref.cos_sin_scale(dict(YARN, mscale=0.707)) == pytest.approx(
        (0.1 * 0.707 * math.log(40) + 1) / (0.1 * math.log(40) + 1))


@pytest.mark.parametrize("bias_scale", [0.0, 0.05, 3.0])
def test_router_matches_the_reference(bias_scale):
    """The noaux_tc router's experts and gates == the reference's, with
    the correction bias off, small, and large enough to decide the
    groups; every chosen expert lies in a kept group, the gates sum to
    routed_scaling_factor, and the bias moves the choice but not the
    gates' source (the sigmoid scores)."""
    cfg = _cfg()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(40, cfg.d_model, generator=g)
    w = torch.randn(cfg.d_model, cfg.n_experts, generator=g) / 8
    bias = bias_scale * torch.randn(cfg.n_experts, generator=g)
    gates, idx, aux = tmoe._route(x, w, cfg, {
        "router": w, "e_score_correction_bias": bias})
    want_g, want_i = ref.route(x, w, bias, _c(cfg))
    assert torch.equal(idx, want_i)
    torch.testing.assert_close(gates, want_g, rtol=1e-6, atol=1e-7)
    assert float(aux) == 0.0
    torch.testing.assert_close(gates.sum(-1), torch.full((40,), 2.5))
    s = torch.sigmoid(x @ w)
    torch.testing.assert_close(
        gates, s.gather(1, idx) / s.gather(1, idx).sum(-1, keepdim=True) * 2.5)
    sel = (s + bias).view(40, 4, 8)
    kept = sel.topk(2, -1).values.sum(-1).topk(2, -1).indices
    assert all(set((idx[t] // 8).tolist()) <= set(kept[t].tolist())
               for t in range(40))
    if bias_scale == 3.0:
        # a bias this large decides the groups: the two groups with the
        # largest biased pairs, whatever the scores
        top = (bias.view(4, 8).topk(2, -1).values.sum(-1)).topk(2).indices
        assert all(set(kept[t].tolist()) == set(top.tolist())
                   for t in range(40))


def test_share_of_32_ranks_sums_to_the_uncut_layer():
    """32 ranks holding one routed expert each: their outputs, with the
    shared expert (which every rank computes alike) counted once, sum to
    the layer with every expert held; on the routed path (prefill) and
    the dense one (decode) alike, and each rank's == the reference's
    share."""
    whole_cfg = _cfg(experts_held=0, experts_offset=0)
    g = torch.Generator().manual_seed(4)
    specs = tmoe.moe_specs(whole_cfg)
    p = init_tree(specs, g, torch.float32, torch.device("cpu"))
    p["e_score_correction_bias"].copy_(0.05 * torch.randn(32, generator=g))
    x = torch.randn(2, 7, whole_cfg.d_model, generator=g)
    whole, _ = tmoe.moe_apply_dense(p, x, whole_cfg)
    shared = tmoe.mlp_apply(p["shared"], x, "silu")
    for impl in ("pairs", "dense"):
        total = shared.clone()
        for r in range(32):
            cfg = _cfg(experts_held=1, experts_offset=r)
            pr = dict(p, wi_gate=p["wi_gate"][r:r + 1],
                      wi_up=p["wi_up"][r:r + 1], wo=p["wo"][r:r + 1])
            y, _ = tmoe.moe_apply(pr, x, cfg, impl=impl)
            total += y - shared
            if impl == "pairs" and r in (0, 17):
                c = dict(_c(cfg), e0=r)
                st = {k: v[None] for k, v in pr.items() if k != "shared"}
                st["shared"] = {k: v[None] for k, v in p["shared"].items()}
                want = ref.moe(st, 0, x.reshape(-1, x.shape[-1]), c)
                torch.testing.assert_close(y.reshape(-1, x.shape[-1]), want,
                                           **TOL)
        torch.testing.assert_close(total, whole, **TOL)


def test_paged_mla_decode_plain_matches_the_reference_attention():
    """Rows of 37, 16, 1 and 50 keys over pages of 8 (crossing page
    boundaries; page ids shuffled, table entries past a row's pages
    garbage): the paged layer's absorbed decode through the kernel's
    wrapper (its plain version on the CPU) == the reference's rebuilt
    MLA at each row's last position, YaRN and all."""
    cfg = _cfg()
    g = torch.Generator().manual_seed(5)
    a = init_tree(tmla.mla_specs(cfg), g, torch.float32, torch.device("cpu"))
    lens = [37, 16, 1, 50]
    B, ps, n_max = len(lens), 8, 7
    xs = [torch.randn(n, cfg.d_model, generator=g) for n in lens]
    P = B * n_max + 3
    perm = torch.randperm(P, generator=g)
    tables = torch.randint(0, P, (B, n_max), generator=g, dtype=torch.int32)
    ckv_pages = torch.randn(P, ps, cfg.kv_lora_rank, generator=g)
    kr_pages = torch.randn(P, ps, cfg.qk_rope_dim, generator=g)
    for b, x in enumerate(xs):
        n_pages = -(-len(x) // ps)
        tables[b, :n_pages] = perm[b * n_max:b * n_max + n_pages].int()
        ckv, kr = tmla.mla_project_kv(a, x[None], torch.arange(len(x))[None],
                                      cfg)
        for t in range(len(x)):
            page, slot = int(tables[b, t // ps]), t % ps
            ckv_pages[page, slot] = ckv[0, t]
            kr_pages[page, slot] = kr[0, t]
    last = torch.stack([x[-1] for x in xs])[:, None]
    pos = torch.tensor([[n - 1] for n in lens], dtype=torch.int32)
    ops.reset_launches()
    got = tmla.mla_decode_paged(
        a, last, positions=pos, cfg=cfg, ckv_pages=ckv_pages,
        kr_pages=kr_pages, block_tables=tables,
        lengths=torch.tensor(lens, dtype=torch.int32))
    stacked = {k: (v[None] if not isinstance(v, dict)
                   else {kk: vv[None] for kk, vv in v.items()})
               for k, v in a.items()}
    for b, x in enumerate(xs):
        want = ref.mla(stacked, 0, x, _c(cfg))[-1]
        torch.testing.assert_close(got[b, 0], want, **TOL)
    assert ops.LAUNCHES["paged_mla_decode"] == 0      # the CPU's plain path
    # the wrapper's plain version is the kernel's function: == the
    # reference's over each row's gathered keys
    q_lat = torch.randn(B, cfg.n_heads, cfg.kv_lora_rank, generator=g)
    q_pe = torch.randn(B, cfg.n_heads, cfg.qk_rope_dim, generator=g)
    lengths = torch.tensor(lens, dtype=torch.int32)
    o = ops.paged_mla_decode(q_lat, q_pe, ckv_pages, kr_pages, tables,
                             lengths, scale=0.3)
    for b, n in enumerate(lens):
        keys = torch.stack([ckv_pages[int(tables[b, t // ps]), t % ps]
                            for t in range(n)])
        rot = torch.stack([kr_pages[int(tables[b, t // ps]), t % ps]
                           for t in range(n)])
        p = torch.softmax((q_lat[b] @ keys.T + q_pe[b] @ rot.T) * 0.3, -1)
        torch.testing.assert_close(o[b], p @ keys, **TOL)
    zero = ops.paged_mla_decode(q_lat, q_pe, ckv_pages, kr_pages, tables,
                                torch.zeros(B, dtype=torch.int32), scale=0.3)
    assert not zero.any()


def _ref_logits(p, cfg, req, out):
    """The reference's logits at each served token's position, teacher
    forced: the image prefix, the prompt, the served tokens but the
    last."""
    img = torch.from_numpy(req.inputs["vision"])
    seq = torch.tensor(list(req.prompt) + [int(t) for t in out[:-1]])
    first = cfg.n_image_tokens + len(req.prompt) - 1
    rows = torch.arange(first, first + len(out))
    return ref.logits_at(p, _c(cfg), img, seq, rows)


def test_paged_decode_matches_reference_logits_and_submit(model):
    """Three greedy requests (prompts 5, 11 and 7 after the 6-token image
    prefix, 10 new tokens: a prefill and 9 ticks each) through the paged
    scheduler: every served token's logits == the reference's, teacher
    forced; the tokens == the reference's argmax and ``submit()``'s."""
    from repro_torch.serving import decode, sampler

    cfg, b, p = model
    reqs = make_requests(cfg, 3, 10, prompt_lens=[5, 11, 7], seed=1)
    store: dict = {}
    select, pick = sampler.select_token, decode.pick_tokens

    def recording(logits, generator=None, **kw):
        store.setdefault(generator.initial_seed(), []).append(
            logits.detach().clone())
        return select(logits, generator, **kw)

    def picking(logits, live):
        for row, seq in live:
            store.setdefault(seq.rng.initial_seed(), []).append(
                logits[row].detach().clone())
        return pick(logits, live)

    decode.select_token = sampler.select_token = recording
    decode.pick_tokens = picking
    try:
        run = serve_arch(cfg, reqs, device="cpu", params=p)
    finally:
        decode.select_token = sampler.select_token = select
        decode.pick_tokens = pick
    assert run.scheduler is not None and run.decode_steps >= 9
    for req, r in zip(reqs, run.results, strict=True):
        out = np.asarray(r.output)
        assert len(out) == 10
        got = torch.stack(store[req.rid])
        want = _ref_logits(p, cfg, req, out)
        torch.testing.assert_close(got, want, **TOL)
        assert np.array_equal(out, want.argmax(-1).numpy())
        solo = run.engine.generate(req)
        np.testing.assert_array_equal(np.asarray(solo.output), out)


def test_expert_pairs_count_the_routed_pairs(model):
    """Each prefill and tick span's ``expert_pairs`` == the reference
    router's count of (token, expert) pairs on the held experts over
    the MoE layers: every position of the prefill, each live row's one
    position a tick; the ``moe.expert_pairs`` counter sums them.  Their
    ``expert_rows`` are the rows the held experts computed: the routed
    pairs alone in a prefill, every row slot through every held expert
    in a tick."""
    cfg, b, p = model
    reqs = make_requests(cfg, 3, 6, prompt_lens=[4, 9, 6], seed=2)
    run = serve_arch(cfg, reqs, device="cpu", params=p)
    c = _c(cfg)
    blk = p["stages"]["moe"]["blocks"]
    held = range(cfg.experts_offset, cfg.experts_offset + cfg.experts_held)
    routes: dict = {}
    orig = ref.moe

    def counting(m, i, x, c_, precision="float32"):
        _, idx = ref.route(x, m["router"][i],
                           m["e_score_correction_bias"][i], c_, precision)
        routes.setdefault("rows", []).append(
            sum((idx == e).sum(-1) for e in held))
        return orig(m, i, x, c_, precision)

    ref.moe = counting
    try:
        per_pos = {}
        for req, r in zip(reqs, run.results, strict=True):
            routes.clear()
            out = [int(t) for t in r.output]
            ref.hidden(p, c, torch.from_numpy(req.inputs["vision"]),
                       torch.tensor(list(req.prompt) + out[:-1]))
            per_pos[req.rid] = torch.stack(routes["rows"]).sum(0)   # (S,)
    finally:
        ref.moe = orig
    assert blk["moe"]["router"].shape[0] == 2
    spans = run.scheduler.tracer.trace.spans
    slots = run.scheduler.decode[cfg.name].rows.max_slots
    total = 0
    ticks: dict = {}
    for s in spans:
        if s.phase == "prefill":
            n = s.attrs["prefix_len"]
            assert s.attrs["expert_pairs"] == int(per_pos[s.rid][:n].sum())
            assert s.attrs["expert_rows"] == s.attrs["expert_pairs"]
            total += s.attrs["expert_pairs"]
        elif s.phase == "decode_tick":
            key = (s.t0, s.t1)
            assert s.attrs["expert_rows"] == 2 * cfg.experts_held * slots
            at = ticks.setdefault(key, [s.attrs["expert_pairs"], 0])
            k = sum(1 for q in spans if q.phase == "decode_tick"
                    and q.rid == s.rid and q.t0 < s.t0)
            pos = cfg.n_image_tokens + len(reqs[s.rid].prompt) + k
            at[1] += int(per_pos[s.rid][pos])
    assert ticks and all(got == want for got, want in ticks.values())
    total += sum(got for got, _ in ticks.values())
    counter = run.scheduler.metrics.counter("moe.expert_pairs",
                                            module=cfg.name)
    assert counter.value == total > 0
