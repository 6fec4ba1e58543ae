"""The hand-written CUDA kernels against their plain versions on the
card, at the serving paths' shapes (internvl2-1b attention: H=14, K=2,
D=64; zamba2-7b: shared attention H=K=32, D=112, and the SSD kernel at
L=128, H=112, P=64, N=64; xlstm-1.3b's sLSTM at d=2048, H=4, hd=512;
the mini-clip towers: H=K=4, D=16; tinyllama-1.1b: H=32, K=4, D=64;
whisper-tiny: H=K=6, D=64 over 1500 encoder frames; gemma2-9b: H=16,
K=8, D=256, windowed local layers and a softcap of 50; llama3-8b: H=32,
K=8, D=128; granite-moe-3b-a800m: H=24, K=8, D=64; llama3-405b:
H=128, K=8, D=128).

Then the wrappers under autograd (each raises ``NoBackwardError`` on a
card input that requires grad, and launches under ``torch.no_grad()``)
and one train step of tinyllama-1.1b's smoke config on the card against
the CPU.

Marked ``cuda``: they skip where no CUDA device is visible.  This file
imports no jax, so it runs on a machine with the card alone:

    python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import pytest
import torch

from repro_torch.kernels import ops, ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 2e-4, 2e-4),
    # both sides round one f32 result to bf16: at most one ulp apart
    (torch.bfloat16, 1e-3, 2.0**-7)])
def test_cuda_kernels_match_plain_versions(cuda_device, dtype, atol, rtol):
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, k, v = rnd(1, 267, 14, 64), rnd(1, 267, 2, 64), rnd(1, 267, 2, 64)
    for kw in (dict(), dict(softcap=30.0), dict(window=50)):
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, **kw).float(),
            ref.flash_attention_ref(q, k, v, **kw).float(), rtol=rtol, atol=atol)
    qd = rnd(4, 14, 64)
    kd, vd = rnd(4, 296, 2, 64), rnd(4, 296, 2, 64)
    lens = torch.tensor([296, 1, 150, 0], dtype=torch.int32,
                        device=cuda_device)
    torch.testing.assert_close(
        ops.decode_attention(qd, kd, vd, lens, softcap=30.0).float(),
        ref.decode_attention_ref(qd, kd, vd, lens, softcap=30.0).float(),
        rtol=rtol, atol=atol)
    kp, vp = rnd(129, 16, 2, 64), rnd(129, 16, 2, 64)
    tables = torch.randint(-5, 134, (4, 32), generator=g, device=cuda_device,
                           dtype=torch.int32)
    lens = torch.tensor([300, 17, 512, 0], dtype=torch.int32,
                        device=cuda_device)
    torch.testing.assert_close(
        ops.paged_decode_attention(qd, kp, vp, tables, lens).float(),
        ref.paged_decode_attention_ref(qd, kp, vp, tables, lens).float(),
        rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_model_steps_match_cpu_plain_path(cuda_device):
    """internvl2-1b smoke through the kernels on the card == the same
    weights through the plain versions on the CPU (which the CPU tests
    hold to the JAX package), for prefill, dense and paged decode."""
    from repro_torch.common.config import get_config
    from repro_torch.common.pytree import tree_map
    from repro_torch.models.api import build_model
    from repro_torch.serving.kvcache import insert_pages

    cfg = get_config("internvl2-1b", smoke=True)
    b = build_model(cfg, compute_dtype=torch.float32)
    p_cpu = b.init(torch.Generator().manual_seed(0), device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 9), generator=g,
                                     dtype=torch.int32),
             "image_embeds": torch.randn(1, cfg.n_image_tokens, cfg.d_model,
                                         generator=g)}
    L = cfg.n_image_tokens + 9
    outs = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev), p_cpu)
        dense = b.init_cache(1, 32, torch.float32, dev)
        logits, dense = b.prefill(p, {k: v.to(dev) for k, v in batch.items()},
                                  dense)
        got = [logits.cpu()]
        pool = insert_pages(b.init_paged_cache(9, 8, torch.float32, dev),
                            dense, [4, 7, 2], L)
        tables = torch.tensor([[4, 7, 2, 5], [0, 0, 0, 0]], dtype=torch.int32,
                              device=dev)
        for i in range(3):
            lens = torch.tensor([L + i, 0], dtype=torch.int32, device=dev)
            tok = torch.tensor([[i + 1], [0]], dtype=torch.int32, device=dev)
            logits, pool = b.paged_decode_step(p, tok, pool, tables, lens)
            got.append(logits[:1].cpu())
            logits, dense = b.decode_step(p, tok[:1], dense, lens[:1])
            got.append(logits.cpu())
        outs[str(dev)] = got
    for a, c in zip(outs["cpu"], outs[str(cuda_device)]):
        torch.testing.assert_close(c, a, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_cuda_sampled_serve_equals_submit(cuda_device):
    """Sampled decode draws on the card, from a generator seeded from
    the rid there: the batched paged stream and the solo path pick the
    same tokens."""
    import numpy as np

    from repro_torch.common.config import get_config
    from repro_torch.models.api import build_model
    from repro_torch.s2m3 import Request
    from repro_torch.serving.scheduler import SchedulerConfig, lm_scheduler

    cfg = get_config("internvl2-1b", smoke=True)
    b = build_model(cfg, compute_dtype=torch.float32)
    params = b.init(torch.Generator(device=cuda_device).manual_seed(0),
                    torch.float32, cuda_device)
    sched = lm_scheduler(b, params, device=cuda_device,
                         config=SchedulerConfig(decode_rows=2, page_size=8,
                                                max_seq_len=48,
                                                decode_pages=20))
    img = np.random.default_rng(5).standard_normal(
        (cfg.n_image_tokens, cfg.d_model)).astype(np.float32)
    reqs = [Request(rid=i, model="lm", source="dev0", prompt=(5 + i, 9),
                    max_new_tokens=6, temperature=0.8,
                    inputs={"vision": img}) for i in range(3)]
    for req, res in zip(reqs, sched.serve(reqs)):
        np.testing.assert_array_equal(res.output,
                                      sched.engine.generate(req).output)


TOLS = [(torch.float32, 2e-4, 2e-4),
        # both sides round one f32 result to bf16: at most one ulp apart
        (torch.bfloat16, 1e-3, 2.0**-7)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
def test_cuda_attention_head_dim_112(cuda_device, dtype, atol, rtol):
    """zamba2-7b's shared attention block: H = K = 32, D = 112, prefill
    of a ragged 383 tokens and decode over ~400 keys."""
    g = torch.Generator(device=cuda_device).manual_seed(1)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, k, v = rnd(1, 383, 32, 112), rnd(1, 383, 32, 112), rnd(1, 383, 32, 112)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v).float(),
        ref.flash_attention_ref(q, k, v).float(), rtol=rtol, atol=atol)
    qd = rnd(2, 32, 112)
    kd, vd = rnd(2, 400, 32, 112), rnd(2, 400, 32, 112)
    lens = torch.tensor([399, 77], dtype=torch.int32, device=cuda_device)
    torch.testing.assert_close(
        ops.decode_attention(qd, kd, vd, lens).float(),
        ref.decode_attention_ref(qd, kd, vd, lens).float(), rtol=rtol,
        atol=atol)


def ssd_inputs(gen, B, nc, L, H, P, N, dtype):
    """Inputs at the scales of a Mamba2 layer: silu-sized x, B, C;
    dt = softplus(.); A_log spread over a few decades of decay."""
    dev = gen.device

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    x = rnd(B, nc, L, H, P)
    Bm, Cm = 0.5 * rnd(B, nc, L, N), 0.5 * rnd(B, nc, L, N)
    dt = torch.nn.functional.softplus(rnd(B, nc, L, H) - 1.0)
    A_log = 0.5 * rnd(H)
    return (*(t.to(dtype) for t in (x, Bm, Cm, dt)), A_log)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("shape", [(1, 3, 128, 112, 64, 64),   # zamba2 path
                                   (1, 1, 126, 112, 64, 64),   # L < chunk
                                   (1, 2, 128, 112, 64, 64),   # two chunks
                                   (2, 2, 8, 8, 16, 16),       # smoke
                                   (3, 1, 40, 5, 48, 24),      # ragged tiles
                                   (1, 1, 128, 4, 128, 128)])  # the limits
def test_cuda_ssd_intra_chunk_matches_plain(cuda_device, dtype, atol, rtol,
                                            shape):
    g = torch.Generator(device=cuda_device).manual_seed(2)
    args = ssd_inputs(g, *shape, dtype)
    # all three outputs are float32 on both sides
    for got, want in zip(ops.ssd_intra_chunk(*args),
                         ref.ssd_intra_chunk_ref(*args)):
        torch.testing.assert_close(got, want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 3, 128, 112, 64, 64),
                                   (1, 1, 126, 112, 64, 64),
                                   (1, 1, 128, 4, 128, 128)])
def test_cuda_ssd_intra_chunk_no_further_from_float64_than_plain(
        cuda_device, shape):
    """The kernel's float32 outputs lie no further from the function in
    float64 than the float32 plain version's do (its cum scan sums in
    float64 and subtracts near keys' values, where the plain version's
    float32 cumsum loses bits in exp(cum_t - cum_s)); 1e-6 absolute for
    outputs float32 holds almost exactly (Lam near 0)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    args = ssd_inputs(g, *shape, torch.float32)
    f64 = ref.ssd_intra_chunk_ref(*args, dtype=torch.float64)
    for got, plain, want in zip(ops.ssd_intra_chunk(*args),
                                ref.ssd_intra_chunk_ref(*args), f64):
        e_kernel = (got.double() - want).abs().max().item()
        e_plain = (plain.double() - want).abs().max().item()
        assert e_kernel <= e_plain + 1e-6, (e_kernel, e_plain)


SLSTM_SHAPES = [(1, 383, 4, 512),    # xlstm-1.3b's longest prompt
                (1, 1, 4, 512),      # its decode step (the one-step kernel)
                (2, 9, 4, 16),       # smoke
                (1, 1000, 4, 512),   # a long prefill
                (2, 2, 4, 512)]      # two rows, two steps


def _slstm_inputs(device, B, S, H, hd, dtype):
    g = torch.Generator(device=device).manual_seed(3)
    d = H * hd

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=device)

    pre = rnd(B, S, 4, d).to(dtype)
    R = 0.02 * rnd(4, H, hd, hd)
    state = (rnd(B, d), 1.0 + rnd(B, d).abs(), rnd(B, d).tanh(), rnd(B, d))
    return pre, R, state


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("B,S,H,hd", SLSTM_SHAPES)
def test_cuda_slstm_scan_matches_plain(cuda_device, dtype, atol, rtol, B, S,
                                       H, hd):
    """Zero state, a random initial state, and one decode step (S=1)
    from that state; outputs and final states."""
    pre, R, state = _slstm_inputs(cuda_device, B, S, H, hd, dtype)
    for p, st in ((pre, None), (pre, state), (pre[:, :1].contiguous(), state)):
        y, fin = ops.slstm_scan(p, R, state=st)
        y_ref, fin_ref = ref.slstm_scan_ref(p, R, st)
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=rtol,
                                   atol=atol)
        for a, b in zip(fin, fin_ref):
            torch.testing.assert_close(a, b, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,hd", SLSTM_SHAPES)
def test_cuda_slstm_four_gate_R_equals_stacked(cuda_device, B, S, H, hd):
    """R as four gate tensors gives the stacked R's bits, and each call
    counts one launch of the kernel its S selects."""
    pre, R, state = _slstm_inputs(cuda_device, B, S, H, hd, torch.float32)
    four = tuple(R[i].clone() for i in range(4))
    key = "slstm_scan_s1" if S == 1 else "slstm_scan"
    for st in (None, state):
        ops.reset_launches()
        y, fin = ops.slstm_scan(pre, R, state=st)
        y4, fin4 = ops.slstm_scan(pre, four, state=st)
        assert ops.LAUNCHES[key] == 2 and sum(ops.LAUNCHES.values()) == 2
        torch.testing.assert_close(y4, y, rtol=0, atol=0)
        for a, b in zip(fin4, fin):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


# the paged kernel's geometries: (H, K, D) at G = 7 and G = 1
PAGED_GEOMS = {"D=16 G=7": (14, 2, 16), "D=64 G=7": (14, 2, 64),
               "D=112 G=7": (14, 2, 112), "D=16 G=1": (4, 4, 16),
               "D=64 G=1": (4, 4, 64), "D=112 G=1": (4, 4, 112),
               "D=64 G=8": (32, 4, 64)}          # tinyllama-1.1b
PAGE, N_MAX, N_PAGES = 16, 32, 129   # internvl2-1b's serve tick


def paged_edge_lengths(n_split, ps=PAGE, n_max=N_MAX):
    """0, 1, ps - 1, ps, ps + 1, the first split boundary of a full span
    - 1 and + 1, and the full span n_max * ps."""
    c = ops.split_range(n_max * ps, n_split, 1)[0]
    return [0, 1, ps - 1, ps, ps + 1, c - 1, c + 1, n_max * ps]


def paged_tables(gen, lengths, device, ps=PAGE, n_max=N_MAX, P=N_PAGES):
    """Random pages for each row's live keys; the table entries past them
    are garbage, many out of [0, P)."""
    lens = torch.tensor(lengths, dtype=torch.int32, device=device)
    B = len(lengths)
    pages = torch.randint(0, P, (B, n_max), generator=gen, device=device,
                          dtype=torch.int32)
    junk = torch.randint(-50, P + 50, (B, n_max), generator=gen,
                         device=device, dtype=torch.int32)
    owned = torch.arange(n_max, device=device)[None] * ps < lens[:, None]
    return torch.where(owned, pages, junk).contiguous(), lens


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("geom", PAGED_GEOMS)
@pytest.mark.parametrize("batch", ["edges", "B=1", "B=4"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_cuda_paged_split_edges(cuda_device, dtype, atol, rtol, geom, batch,
                                softcap):
    """The split-KV paged kernel over a 129-page pool with garbage table
    tails: one batch of edge lengths, one row, or four rows; the merge
    tickets are left zero, and a second call gives the same bits."""
    H, K, D = PAGED_GEOMS[geom]
    g = torch.Generator(device=cuda_device).manual_seed(6)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    span = N_MAX * PAGE
    if batch == "edges":
        lens = paged_edge_lengths(ops.decode_splits(span, 8, K, H // K, n_sm))
    elif batch == "B=1":
        lens = [273]
    else:
        lens = [span, 1, 137, 0]
    tables, lengths = paged_tables(g, lens, cuda_device)
    B = len(lens)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q = rnd(B, H, D)
    kp, vp = rnd(N_PAGES, PAGE, K, D), rnd(N_PAGES, PAGE, K, D)
    got = ops.paged_decode_attention(q, kp, vp, tables, lengths,
                                     softcap=softcap)
    torch.testing.assert_close(
        got.float(),
        ref.paged_decode_attention_ref(q, kp, vp, tables, lengths,
                                       softcap=softcap).float(),
        rtol=rtol, atol=atol)
    again = ops.paged_decode_attention(q, kp, vp, tables, lengths,
                                       softcap=softcap)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    assert int(ops._TICKETS[cuda_device.index or 0].abs().sum()) == 0
    if 0 in lens:
        assert not bool(got[lens.index(0)].float().abs().any())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("geom", ["D=64 G=7", "D=16 G=1", "D=64 G=8",
                                  "D=256 G=2"])
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2), (2, 4)])
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (37, 50.0)])
def test_cuda_paged_tile_mode_matches_plain(cuda_device, dtype, atol, rtol,
                                            geom, mesh, window, softcap):
    """The paged kernel's tile mode on each rank's tile of a pool split
    ``mesh`` ways (pages over the first, each page's slots over the
    second, as ``paged_decode_attention_shardmap`` splits it), at the
    split edges with garbage table tails: each tile's (o, lse) == the
    plain version's (lse -inf on the same rows), and in float32 the
    tiles combined == the whole-pool kernel (in bfloat16 each tile's o is
    rounded before the combine, the whole pool's once)."""
    H, K, D = {"D=256 G=2": (16, 8, 256)}.get(geom) or PAGED_GEOMS[geom]
    g = torch.Generator(device=cuda_device).manual_seed(7)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    lens = paged_edge_lengths(ops.decode_splits(N_MAX * PAGE // mesh[1], 8,
                                                K, H // K, n_sm))
    tables, lengths = paged_tables(g, lens, cuda_device, P=N_PAGES - 1)
    B, P = len(lens), N_PAGES - 1

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q = rnd(B, H, D)
    kp, vp = rnd(P, PAGE, K, D), rnd(P, PAGE, K, D)
    Pl, sl = P // mesh[0], PAGE // mesh[1]
    kw = dict(window=window, softcap=softcap)
    os_, lses = [], []
    for i in range(mesh[0]):
        for j in range(mesh[1]):
            tile = (i * Pl, P, j * sl, PAGE)
            kt = kp[i * Pl:(i + 1) * Pl, j * sl:(j + 1) * sl].contiguous()
            vt = vp[i * Pl:(i + 1) * Pl, j * sl:(j + 1) * sl].contiguous()
            o, lse = ops.paged_decode_attention(q, kt, vt, tables, lengths,
                                                tile=tile, **kw)
            wo, wl = ref.paged_decode_attention_ref(q, kt, vt, tables,
                                                    lengths, tile=tile, **kw)
            torch.testing.assert_close(o.float(), wo.float(), rtol=rtol,
                                       atol=atol)
            live = torch.isfinite(wl)
            assert torch.equal(torch.isfinite(lse), live)
            torch.testing.assert_close(lse[live], wl[live], rtol=rtol,
                                       atol=atol)
            os_.append(o.float())
            lses.append(lse)
    assert int(ops._TICKETS[cuda_device.index or 0].abs().sum()) == 0
    if dtype is not torch.float32:
        return
    L, O = torch.stack(lses), torch.stack(os_)
    M = L.amax(0)
    w = torch.exp(L - torch.where(torch.isfinite(M), M, torch.zeros_like(M)))
    got = (w[..., None] * O).sum(0) / w.sum(0).clamp_min(1e-30)[..., None]
    whole = ops.paged_decode_attention(q, kp, vp, tables, lengths, **kw)
    torch.testing.assert_close(got, whole, rtol=rtol, atol=atol)


# the attention kernels' edge cases at each path's head geometry:
# (H, K, D, the path's S or T)
ATTN_GEOMS = {"internvl2-1b": (14, 2, 64, 267), "zamba2-7b": (32, 32, 112, 383),
              "mini-clip": (4, 4, 16, 16),            # the towers
              "tinyllama-1.1b": (32, 4, 64, 12),      # G = 8, a prompt
              "whisper-tiny": (6, 6, 64, 1500)}       # the encoder
# (B, S, T, keywords); None is the path's S
FLASH_EDGES = [
    (1, 1, 1, {}), (1, 5, 5, {}), (1, 5, 5, dict(causal=False)),
    (1, 20, 20, dict(window=7)), (1, 1, None, dict(causal=False)),
    (2, 37, 37, dict(softcap=30.0)), (1, None, None, dict(window=100)),
    (1, None, None, dict(causal=False)), (1, None, None, dict(softcap=30.0)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("arch", ATTN_GEOMS)
@pytest.mark.parametrize("B,S,T,kw", FLASH_EDGES)
def test_cuda_flash_edges(cuda_device, dtype, atol, rtol, arch, B, S, T, kw):
    """S = 1, S under one q-tile, windows, non-causal, B = 2, softcap."""
    H, K, D, S_path = ATTN_GEOMS[arch]
    S, T = S or S_path, T or S_path
    g = torch.Generator(device=cuda_device).manual_seed(4)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, k, v = rnd(B, S, H, D), rnd(B, T, K, D), rnd(B, T, K, D)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, **kw).float(),
        ref.flash_attention_ref(q, k, v, **kw).float(), rtol=rtol, atol=atol)


DECODE_GEOMS = {"internvl2-1b": (14, 2, 64, 304),     # G = 7
                "zamba2-7b": (32, 32, 112, 400),      # G = 1
                "G=1 D=112 K=4": (4, 4, 112, 400),    # G = 1, several splits
                "tinyllama-1.1b": (32, 4, 64, 32),    # G = 8, solo cache
                "whisper-tiny": (6, 6, 64, 1500)}     # G = 1, cross keys


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("arch", DECODE_GEOMS)
@pytest.mark.parametrize("batch", ["split edges", "B=4"])
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_cuda_decode_split_edges(cuda_device, dtype, atol, rtol, arch, batch,
                                 softcap):
    """Lengths 0, 1, the first split boundary of a full row - 1 and + 1,
    and T in one batch (or B = 4 with T, 1, 237 or T - 1, 0); the merge tickets
    are left zero, and a second call gives the same bits."""
    H, K, D, T = DECODE_GEOMS[arch]
    g = torch.Generator(device=cuda_device).manual_seed(5)
    n_sm = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    if batch == "B=4":
        lens = [T, 1, min(237, T - 1), 0]
    else:
        n = ops.decode_splits(T, 5, K, H // K, n_sm)
        c = ops.split_range(T, n, 1)[0]
        lens = [0, 1, c - 1, c + 1, T]
    B = len(lens)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda_device)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, k, v = rnd(B, H, D), rnd(B, T, K, D), rnd(B, T, K, D)
    got = ops.decode_attention(q, k, v, lengths, softcap=softcap)
    torch.testing.assert_close(
        got.float(),
        ref.decode_attention_ref(q, k, v, lengths, softcap=softcap).float(),
        rtol=rtol, atol=atol)
    again = ops.decode_attention(q, k, v, lengths, softcap=softcap)
    torch.testing.assert_close(again, got, rtol=0, atol=0)
    assert int(ops._TICKETS[cuda_device.index or 0].abs().sum()) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", TOLS)
@pytest.mark.parametrize("S", [2, 8])
def test_cuda_flash_cross_attention(cuda_device, dtype, atol, rtol, S):
    """whisper-tiny's cross-attention prefill: a prompt of S queries
    against the 1500 encoder keys, H = K = 6, D = 64, non-causal."""
    g = torch.Generator(device=cuda_device).manual_seed(7)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    q, k, v = rnd(1, S, 6, 64), rnd(1, 1500, 6, 64), rnd(1, 1500, 6, 64)
    torch.testing.assert_close(
        ops.flash_attention(q, k, v, causal=False).float(),
        ref.flash_attention_ref(q, k, v, causal=False).float(),
        rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_attention_launches_counted_by_shape(cuda_device):
    """Each attention wrapper counts one launch under its call shape, and
    the counts by shape sum to the kernel's launches."""
    g = torch.Generator(device=cuda_device).manual_seed(8)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device)

    q, k = rnd(1, 7, 6, 64), rnd(1, 1500, 6, 64)
    qd, kd = rnd(2, 32, 64), rnd(2, 24, 4, 64)
    lens = torch.tensor([5, 24], dtype=torch.int32, device=cuda_device)
    kp = rnd(9, 16, 4, 64)
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32,
                          device=cuda_device)
    ops.reset_launches()
    for _ in range(2):
        ops.flash_attention(q, k, k, causal=False)
    ops.flash_attention(q, q, q)
    ops.decode_attention(qd, kd, kd, lens)
    ops.paged_decode_attention(qd, kp, kp, tables, lens)
    ops.flash_attention(q, q, q, window=4)
    ops.decode_attention(qd, kd, kd, lens, window=8)
    f32 = "float32"
    assert ops.SHAPE_LAUNCHES["flash_attention"] == {
        (1, 7, 1500, 6, 6, 64, False, 0, f32): 2,
        (1, 7, 7, 6, 6, 64, True, 0, f32): 1,
        (1, 7, 7, 6, 6, 64, True, 4, f32): 1}
    assert ops.SHAPE_LAUNCHES["decode_attention"] == {
        (2, 24, 32, 4, 64, 0, f32): 1, (2, 24, 32, 4, 64, 8, f32): 1}
    assert ops.SHAPE_LAUNCHES["paged_decode_attention"] == {
        (2, 2, 16, 32, 4, 64, 0, f32): 1}
    assert {name: sum(c.values()) for name, c in ops.SHAPE_LAUNCHES.items()
            } == {name: ops.LAUNCHES[name] for name in ops.SHAPE_LAUNCHES}


# gemma2-9b (H=16, K=8, D=256; window 4096, softcap 50), llama3-8b
# (H=32, K=8, D=128), granite-moe-3b-a800m (H=24, K=8, D=64, G=3) and
# llama3-405b (H=128, K=8, D=128: G=16, two blocks of 8 q-heads a kv
# head in both decode kernels)
FAMILY_GEOMS = [(16, 8, 256), (32, 8, 128), (24, 8, 64), (128, 8, 128)]
# and D = 256 with G = 8 and 12 (blocks of 8 and 4 q-heads), where the
# decode merge has more output float4s than threads and runs in passes
FAMILY_DECODE_GEOMS = FAMILY_GEOMS + [(16, 2, 256), (12, 1, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 2e-4, 2e-4), (torch.bfloat16, 1e-3, 2.0**-7)])
@pytest.mark.parametrize("H,K,D", FAMILY_GEOMS)
@pytest.mark.parametrize("kw", [dict(), dict(softcap=50.0),
                                dict(window=37, softcap=50.0),
                                dict(window=200)])
def test_cuda_flash_family_head_dims(cuda_device, dtype, atol, rtol, H, K,
                                     D, kw):
    """Ragged S = 300 (no tile multiple), causal, with and without a
    window and a softcap; and S = 1."""
    g = torch.Generator(device=cuda_device).manual_seed(9)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    for S in (300, 1):
        q, k, v = rnd(1, S, H, D), rnd(1, S, K, D), rnd(1, S, K, D)
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, **kw).float(),
            ref.flash_attention_ref(q, k, v, **kw).float(),
            rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H,K,D,kw", [
    (1, 267, 14, 2, 64, {}),                     # internvl2-1b prefill
    (1, 200, 32, 32, 112, {}),                   # zamba2-7b shared attention
    (4, 512, 4, 4, 16, dict(causal=False)),      # the mini-clip towers' D
    (1, 1024, 32, 8, 128, {}),                   # llama3-8b
    (1, 2048, 16, 8, 256, dict(window=1024, softcap=50.0))])  # gemma2-9b
def test_cuda_flash_bf16_flips_near_plain(cuda_device, B, S, H, K, D, kw):
    """The bf16 instance keeps float32 math on its bf16 inputs: the share
    of its outputs that differ from exact (float64) attention rounded to
    bf16 is at most 3x the plain version's (``FLIPS_MULTIPLE`` of
    ``chip_smoke.py``), which one bf16 ulp of tolerance cannot see; a
    P narrowed to bf16 or to two bf16 terms fails it."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    q, k, v = (torch.randn(B, S, n, D, generator=g,
                           device=cuda_device).bfloat16() for n in (H, K, K))
    exact = ref.flash_attention_ref(q, k, v, dtype=torch.float64, **kw)
    plain = ref.flips(ref.flash_attention_ref(q, k, v, **kw), exact)
    assert ref.flips(ops.flash_attention(q, k, v, **kw), exact) <= 3 * plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 2e-4, 2e-4), (torch.bfloat16, 1e-3, 2.0**-7)])
@pytest.mark.parametrize("H,K,D", FAMILY_DECODE_GEOMS)
@pytest.mark.parametrize("window,softcap", [(0, 0.0), (0, 50.0), (100, 0.0),
                                            (100, 50.0)])
def test_cuda_decode_family_head_dims(cuda_device, dtype, atol, rtol, H, K,
                                      D, window, softcap):
    """Contiguous and paged split-KV decode: lengths 0, 1, below, at and
    past the window, and the full cache, in one batch."""
    g = torch.Generator(device=cuda_device).manual_seed(10)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=cuda_device).to(dtype)

    T, ps = 320, 16
    lens = torch.tensor([0, 1, 99, 100, 101, 257, T], dtype=torch.int32,
                        device=cuda_device)
    B = len(lens)
    q, k, v = rnd(B, H, D), rnd(B, T, K, D), rnd(B, T, K, D)
    torch.testing.assert_close(
        ops.decode_attention(q, k, v, lens, window=window,
                             softcap=softcap).float(),
        ref.decode_attention_ref(q, k, v, lens, window=window,
                                 softcap=softcap).float(),
        rtol=rtol, atol=atol)
    n_max = T // ps
    P = B * n_max + 1
    perm = torch.randperm(P - 1, generator=g, device=cuda_device) + 1
    tables = perm.reshape(B, n_max).to(torch.int32)
    owned = torch.arange(n_max, device=cuda_device)[None] * ps < lens[:, None]
    junk = torch.randint(-9, P + 9, (B, n_max), generator=g,
                         device=cuda_device, dtype=torch.int32)
    tables = torch.where(owned, tables, junk).contiguous()
    kp, vp = rnd(P, ps, K, D), rnd(P, ps, K, D)
    torch.testing.assert_close(
        ops.paged_decode_attention(q, kp, vp, tables, lens, window=window,
                                   softcap=softcap).float(),
        ref.paged_decode_attention_ref(q, kp, vp, tables, lens,
                                       window=window, softcap=softcap).float(),
        rtol=rtol, atol=atol)


@pytest.mark.cuda
def test_cuda_windowed_decode_reads_no_key_below_the_window(cuda_device):
    """Keys below a row's window hold NaN: the kernels never read them,
    so the output stays finite and equal to the plain version's on a
    clean cache."""
    g = torch.Generator(device=cuda_device).manual_seed(11)
    H, K, D, T, w = 16, 8, 256, 600, 256
    q = torch.randn(2, H, D, generator=g, device=cuda_device)
    k = torch.randn(2, T, K, D, generator=g, device=cuda_device)
    v = torch.randn(2, T, K, D, generator=g, device=cuda_device)
    lens = torch.tensor([T, 400], dtype=torch.int32, device=cuda_device)
    want = ref.decode_attention_ref(q, k, v, lens, window=w)
    k2, v2 = k.clone(), v.clone()
    for b, n in enumerate(lens.tolist()):
        k2[b, :n - w] = float("nan")
        v2[b, :n - w] = float("nan")
    torch.testing.assert_close(ops.decode_attention(q, k2, v2, lens,
                                                    window=w),
                               want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", ops.HEAD_DIMS)
def test_cuda_flash_plan_equals_the_kernel_plan(cuda_device, D, dtype):
    """``ops.flash_plan`` (what the kernel checker reads on the CPU) is the
    plan ``flash_attention_plan`` reports from the built kernel for the
    same dtype; a head dim without one is refused by both."""
    import ctypes

    from repro_torch.kernels.build import load

    out = (ctypes.c_int * 4)()
    code = ops._DTYPES[dtype]
    assert load("flash_attention").flash_attention_plan(D, code, out) == 0
    p = ops.flash_plan(D, dtype)
    assert (p.bq, p.bk, p.threads, p.smem) == tuple(out)
    assert load("flash_attention").flash_attention_plan(96, code, out) != 0
    with pytest.raises(ops.NoPlanError):
        ops.flash_plan(96, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(7))
def test_cuda_wrapper_raises_under_grad_and_launches_under_no_grad(
        cuda_device, case):
    from test_torch_autograd_guard import guard_cases

    name, fn, inputs = guard_cases(cuda_device)[case]
    ops.reset_launches()
    for i in range(len(inputs)):
        args = [t.clone().requires_grad_(j == i) for j, t in enumerate(inputs)]
        with pytest.raises(ops.NoBackwardError, match="no backward"):
            fn(*args)
    assert sum(ops.LAUNCHES.values()) == 0
    args = [t.clone().requires_grad_(True) for t in inputs]
    with torch.no_grad():
        fn(*args)
    torch.cuda.synchronize()
    assert sum(ops.LAUNCHES.values()) == 1


@pytest.mark.cuda
def test_cuda_train_step_matches_cpu(cuda_device):
    """tinyllama-1.1b smoke: the loss and every gradient leaf on the card
    (the differentiable path) == the CPU at 2e-4; the kernels' loss under
    no_grad == the plain one; two microbatches == one on the card."""
    from repro_torch.common.config import TrainConfig, get_config
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.models.api import build_model
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_step import (
        batch_to_tensors, loss_and_grads, make_train_step,
    )

    cfg = get_config("tinyllama-1.1b", smoke=True)
    bundle = build_model(cfg, compute_dtype=torch.float32)
    p_cpu = bundle.init(torch.Generator().manual_seed(0), device="cpu")
    p_gpu = tree_map(lambda t: t.to(cuda_device), p_cpu)
    batch = next(TokenStream(DataConfig(seq_len=16, global_batch=4,
                                        vocab_size=cfg.vocab_size)))
    lc, _, gc = loss_and_grads(bundle, p_cpu, batch_to_tensors(batch, "cpu"))
    bg = batch_to_tensors(batch, cuda_device)
    lg, _, gg = loss_and_grads(bundle, p_gpu, bg)
    torch.testing.assert_close(lg.cpu(), lc, rtol=2e-4, atol=2e-4)
    for a, b in zip(tree_leaves(gg), tree_leaves(gc)):
        torch.testing.assert_close(a.cpu(), b, rtol=2e-4, atol=2e-4)
    with torch.no_grad():
        lk, _ = build_model(cfg, attn_impl="kernel",
                            compute_dtype=torch.float32).loss_fn(p_gpu, bg)
    torch.testing.assert_close(lk, lg, rtol=2e-4, atol=2e-4)
    tcfg = dict(learning_rate=1e-3, warmup_steps=2, total_steps=10)
    outs = []
    for k in (1, 2):
        state = init_state(tree_map(torch.clone, p_gpu),
                           TrainConfig(microbatches=k, **tcfg))
        state, m = make_train_step(
            bundle, TrainConfig(microbatches=k, **tcfg))(state, bg)
        outs.append((state, m))
    torch.testing.assert_close(outs[0][1]["loss"], outs[1][1]["loss"],
                               rtol=1e-5, atol=1e-5)
    for a, b in zip(tree_leaves(outs[0][0]["params"]),
                    tree_leaves(outs[1][0]["params"])):
        torch.testing.assert_close(a, b, rtol=2e-3, atol=2e-5)


# the bfloat16 compute's decode launches: internvl2-1b's geometry (H=14,
# K=2, D=64), q in bfloat16 against the serving engine's float32 cache
# and pool, and against the bundle's own bfloat16 ones
@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_cuda_bf16_q_against_a_float32_cache_runs_the_float32_instance(
        cuda_device, kind):
    """A bfloat16 q against a float32 cache (``decode_attend``) or pool
    (``paged_attend``) is widened: one launch of the float32 instance,
    output in bfloat16, equal to the plain version on the widened
    operands within one bfloat16 ulp; no copy of the cache is made (the
    bytes allocated during the call stay below its size)."""
    from repro_torch.layers import attention as attn

    g = torch.Generator(device=cuda_device).manual_seed(16)
    B, H, K, D = 4, 14, 2, 64
    q = torch.randn(B, 1, H, D, generator=g, device=cuda_device).to(
        torch.bfloat16)
    lens = torch.tensor([296, 1, 150, 9], dtype=torch.int32,
                        device=cuda_device)
    if kind == "dense":
        k, v = (torch.randn(B, 296, K, D, generator=g, device=cuda_device)
                for _ in range(2))
        call = lambda: attn.decode_attend(q, k, v, lens)           # noqa: E731
        want = ref.decode_attention_ref(q[:, 0].float(), k, v, lens)
        key = (B, 296, H, K, D, 0, "float32")
        name = "decode_attention"
    else:
        k, v = (torch.randn(129, 16, K, D, generator=g, device=cuda_device)
                for _ in range(2))
        tables = torch.randint(1, 129, (B, 32), generator=g,
                               device=cuda_device, dtype=torch.int32)
        call = lambda: attn.paged_attend(q, k, v, tables, lens)    # noqa: E731
        want = ref.paged_decode_attention_ref(q[:, 0].float(), k, v, tables,
                                              lens)
        key = (B, 32, 16, H, K, D, 0, "float32")
        name = "paged_decode_attention"
    call()                                             # build, warm up
    torch.cuda.synchronize()
    ops.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = call()
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - before
    assert out.dtype == torch.bfloat16 and out.shape == (B, 1, H, D)
    assert ops.LAUNCHES[name] == 1 and sum(ops.LAUNCHES.values()) == 1
    assert ops.SHAPE_LAUNCHES[name] == {key: 1}
    assert grown < k.numel() * k.element_size(), grown
    torch.testing.assert_close(out[:, 0].float(),
                               want.to(torch.bfloat16).float(),
                               rtol=2.0**-7, atol=1e-3)


@pytest.mark.cuda
def test_cuda_launches_are_keyed_by_dtype(cuda_device):
    """One shape launched in float32 and in bfloat16 counts under two
    keys, each ending in its instance's dtype; a bfloat16 cache under a
    bfloat16 q runs the bfloat16 instance."""
    from repro_torch.layers import attention as attn

    g = torch.Generator(device=cuda_device).manual_seed(17)
    q = torch.randn(1, 7, 14, 64, generator=g, device=cuda_device)
    k = torch.randn(1, 7, 2, 64, generator=g, device=cuda_device)
    qd = torch.randn(2, 1, 14, 64, generator=g, device=cuda_device).to(
        torch.bfloat16)
    kd = torch.randn(2, 24, 2, 64, generator=g, device=cuda_device).to(
        torch.bfloat16)
    lens = torch.tensor([5, 24], dtype=torch.int32, device=cuda_device)
    ops.reset_launches()
    ops.flash_attention(q, k, k)
    ops.flash_attention(q.bfloat16(), k.bfloat16(), k.bfloat16())
    assert attn.decode_attend(qd, kd, kd, lens).dtype == torch.bfloat16
    assert ops.SHAPE_LAUNCHES["flash_attention"] == {
        (1, 7, 7, 14, 2, 64, True, 0, "float32"): 1,
        (1, 7, 7, 14, 2, 64, True, 0, "bfloat16"): 1}
    assert ops.SHAPE_LAUNCHES["decode_attention"] == {
        (2, 24, 14, 2, 64, 0, "bfloat16"): 1}
    assert ops.LAUNCHES["flash_attention"] == 2
