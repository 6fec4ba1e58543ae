"""Static Hopper launch-plan checker — it never launches a kernel.

On the CPU every kernel wrapper in ``repro_torch.kernels.ops`` takes its
plain version, at any shape: a head dim without a kernel instance, an
sLSTM head dim no cluster splits or a tile above a block's shared memory
passes every CPU test and raises only at launch on the card.  For every
kernel entry point and every shape the zoo serves (the JAX package's
sweep — gemma2-9b, llama3-8b, whisper-tiny, mini-clip, xlstm-1.3b,
zamba2-7b — and the shapes ``chip_smoke.py`` and ``portbench`` serve,
deepseek-v3-671b's paged MLA decode among them), this pass:

* calls the real entry point on ``meta`` tensors: the wrappers run every
  check of the card path there (plan, shared memory, cluster, grid) and
  return their outputs unfilled, launching nothing.  The error the
  wrapper raises is the verdict: ``ops.NoPlanError`` (no kernel instance
  or tiling takes the shape) is a ``kernel/no-plan`` ERROR,
  ``ops.SharedMemoryError`` ``kernel/smem-limit``, ``ops.ClusterError``
  (an sLSTM head dim with no cluster of at most 16 blocks)
  ``kernel/cluster``, ``ops.GridError`` ``kernel/grid-limit``,
  ``ops.TileError`` (a paged decode tile outside its pool or its page)
  ``kernel/tile-range``, another ValueError ``kernel/invalid-shape`` and
  anything else
  ``kernel/meta-eval``.  So the checker and the card share one rule;
* diffs the outputs with the plain version's in ``kernels/ref.py`` on
  the same meta tensors: ``kernel/shape-drift`` / ``kernel/dtype-drift``
  ERRORs;
* where the wrapper accepts the shape, lays out its launch with the
  wrapper's own planners (``launch_plan``), warns where an SSD plan holds
  fewer than two blocks an SM (``kernel/occupancy``) and summarises the
  case (``kernel/summary`` INFO): grid, threads, dynamic shared memory,
  cluster, the split-KV decode kernels' workspace and the paged kernel's
  tile, and its bound from ``common.hw`` — each input read once and
  each output written once at the card's memory rate, or the operations
  at its peak for the input type, whichever is larger.

No shape the wrappers accept reaches ``kernel/smem-limit`` today: the
planners' fixed tiles and ``ops.SSD_MAX_DIM`` keep every block under the
limit (at most ``ops.ssd_smem(128, 128, 128, 32, 64)`` = 103,424 B for
SSD), so the planners' shared-memory checks, and this code, guard the
tiles and limits of a later change.

The SM count, which the decode and SSD planners read, is
``ops.sm_count``'s: the H100's from ``common.hw`` unless ``device`` names
a CUDA device, whose count is read.  The wrappers' meta path plans for
the H100's.
The JAX package's ``vmem_budget`` has no counterpart: a Hopper block's
shared memory and an SM's registers are the card's limits, not a budget.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch.analysis.diagnostics import Diagnostic, Severity
from repro_torch.common import hw
from repro_torch.kernels import ops, ref

_KB = 1024

#: the public kernel entry points the checker must cover
ENTRY_POINTS = ("flash_attention", "decode_attention",
                "paged_decode_attention", "paged_mla_decode", "ssd_chunked",
                "ssd_intra_chunk", "slstm_scan")

#: case names of the JAX package's sweep that the port checks under
#: another name (see ``zoo_cases``)
RENAMED = {"whisper-tiny/audio-prefill-padded": "whisper-tiny/audio-prefill"}

#: the finding each planner error becomes
PLAN_CODES = ((ops.SharedMemoryError, "kernel/smem-limit"),
               (ops.ClusterError, "kernel/cluster"),
               (ops.GridError, "kernel/grid-limit"),
               (ops.TileError, "kernel/tile-range"),
               (ops.NoPlanError, "kernel/no-plan"))


@dataclass(frozen=True)
class LaunchPlan:
    """The launch a wrapper makes on the card for one case."""

    kernel: str                      # the CUDA kernel launched
    grid: tuple[int, int, int]
    threads: int                     # threads a block
    smem: int                        # dynamic shared-memory bytes a block
    cluster: int = 1                 # blocks a thread-block cluster
    blocks_per_sm: int | None = None  # the planner's, where it has one
    plan: Any = None                 # FlashPlan, SsdPlan or SlstmPlan
    workspace: int = 0               # the split-KV kernels' float32 bytes
    tile: tuple | None = None        # the paged kernel's (p0, n_pages, s0,
    #                                  page_size) in its tile mode


# operand kinds: how ``KernelCase.inputs`` draws each one
_FLOAT, _F32, _LENGTHS, _TABLES = "float", "f32", "lengths", "tables"


@dataclass(frozen=True)
class KernelCase:
    """One (entry point, served shape) combination to vet.  ``operands``
    are (name, shape, kind) in the entry point's argument order; the
    case's float operands are in ``dtype``."""

    name: str                        # e.g. "gemma2-9b/global-prefill"
    entry: str                       # a name in ``ENTRY_POINTS``
    operands: tuple
    kwargs: dict = field(default_factory=dict)
    dtype: torch.dtype = torch.float32

    def shape(self, arg: str) -> tuple:
        return next(s for n, s, _ in self.operands if n == arg)

    def _dtype(self, kind):
        return {_FLOAT: self.dtype, _F32: torch.float32,
                _LENGTHS: torch.int32, _TABLES: torch.int32}[kind]

    def meta_args(self) -> tuple:
        return tuple(torch.empty(s, dtype=self._dtype(k), device="meta")
                     for _, s, k in self.operands)

    def inputs(self, generator: torch.Generator) -> tuple:
        """The operands at the case's full shape, drawn from
        ``generator`` on its device at the served paths' scales: lengths
        in [1, T] with the last row full, each row's own pages in a
        shuffled pool (its pages again where the tables need more than
        a tile's pool has), SSD's dt through softplus, sLSTM's R at
        0.02."""
        dev = generator.device
        # a paged tile's tables hold its pool's page ids, its rows the
        # pool's pages of page_size slots
        tile = self.kwargs.get("tile")
        pool = "ckv_pages" if self.entry == "paged_mla_decode" else "k_pages"
        out = []
        for name, s, kind in self.operands:
            if kind == _LENGTHS:
                T = (self.shape("k")[1] if self.entry == "decode_attention"
                     else self.shape("block_tables")[1]
                     * (tile[3] if tile else self.shape(pool)[1]))
                t = torch.randint(1, T + 1, s, generator=generator,
                                  device=dev, dtype=torch.int32)
                t[-1] = T
            elif kind == _TABLES:
                n_pages = tile[1] if tile else self.shape(pool)[0]
                t = torch.randperm(n_pages, generator=generator, device=dev)
                if t.numel() < s[0] * s[1]:     # a pool of fewer pages
                    t = t.repeat(-(-s[0] * s[1] // n_pages))
                t = t[:s[0] * s[1]].reshape(s).to(torch.int32)
            else:
                t = torch.randn(s, generator=generator, device=dev)
                if name in ("Bm", "Cm", "A_log"):
                    t = 0.5 * t
                elif name == "dt":
                    t = torch.nn.functional.softplus(t - 1.0)
                elif name == "R":
                    t = 0.02 * t
                t = t.to(self._dtype(kind))
            out.append(t)
        return tuple(out)


def _flash_case(name, *, B, S, H, D, T, K, causal=True, window=0,
                softcap=0.0, dtype=torch.float32):
    return KernelCase(
        name, "flash_attention",
        (("q", (B, S, H, D), _FLOAT), ("k", (B, T, K, D), _FLOAT),
         ("v", (B, T, K, D), _FLOAT)),
        dict(causal=causal, window=window, softcap=softcap), dtype)


def _decode_case(name, *, B, H, D, T, K, window=0, softcap=0.0,
                 dtype=torch.float32):
    return KernelCase(
        name, "decode_attention",
        (("q", (B, H, D), _FLOAT), ("k", (B, T, K, D), _FLOAT),
         ("v", (B, T, K, D), _FLOAT), ("lengths", (B,), _LENGTHS)),
        dict(window=window, softcap=softcap), dtype)


def _paged_decode_case(name, *, B, H, D, T, K, page_size=16, window=0,
                       softcap=0.0, dtype=torch.float32):
    """Paged variant of the decode shape: the T-token budget of a row
    carved into pages, a pool of B rows' worth."""
    n_max = -(-T // page_size)
    n_pages = B * n_max
    return KernelCase(
        name, "paged_decode_attention",
        (("q", (B, H, D), _FLOAT),
         ("k_pages", (n_pages, page_size, K, D), _FLOAT),
         ("v_pages", (n_pages, page_size, K, D), _FLOAT),
         ("block_tables", (B, n_max), _TABLES),
         ("lengths", (B,), _LENGTHS)),
        dict(window=window, softcap=softcap), dtype)


def _paged_tile_case(name, *, B, H, D, K, n_max, n_pages, pages, p0=0,
                     page_size=16, slots=8, s0=0, window=0, softcap=0.0,
                     dtype=torch.float32):
    """The paged kernel's tile mode on one rank of a sharded pool: B rows
    of up to n_max pages over a pool of n_pages pages of page_size slots,
    of which the rank holds ``pages`` pages from p0 and ``slots`` slots
    from s0 (``layers.attention.paged_decode_attention_shardmap``)."""
    return KernelCase(
        name, "paged_decode_attention",
        (("q", (B, H, D), _FLOAT),
         ("k_pages", (pages, slots, K, D), _FLOAT),
         ("v_pages", (pages, slots, K, D), _FLOAT),
         ("block_tables", (B, n_max), _TABLES),
         ("lengths", (B,), _LENGTHS)),
        dict(window=window, softcap=softcap,
             tile=(p0, n_pages, s0, page_size)), dtype)


def _paged_mla_case(name, *, B, H, T, r, rope, page_size=16,
                    scale=0.125, dtype=torch.float32):
    """MLA's absorbed decode over a latent pool of B rows' worth of
    pages, each row's T-token budget carved into pages."""
    n_max = -(-T // page_size)
    n_pages = B * n_max
    return KernelCase(
        name, "paged_mla_decode",
        (("q_lat", (B, H, r), _FLOAT), ("q_pe", (B, H, rope), _FLOAT),
         ("ckv_pages", (n_pages, page_size, r), _FLOAT),
         ("kr_pages", (n_pages, page_size, rope), _FLOAT),
         ("block_tables", (B, n_max), _TABLES),
         ("lengths", (B,), _LENGTHS)), dict(scale=scale), dtype)


def _ssd_intra_case(name, *, B, nc, L, H, P, N, dtype=torch.float32):
    return KernelCase(
        name, "ssd_intra_chunk",
        (("x", (B, nc, L, H, P), _FLOAT), ("Bm", (B, nc, L, N), _FLOAT),
         ("Cm", (B, nc, L, N), _FLOAT), ("dt", (B, nc, L, H), _FLOAT),
         ("A_log", (H,), _F32)), {}, dtype)


def _ssd_cases(name, *, B, S, H, P, N, chunk, dtype=torch.float32):
    chunked = KernelCase(
        f"{name}/chunked", "ssd_chunked",
        (("x", (B, S, H, P), _FLOAT), ("Bm", (B, S, N), _FLOAT),
         ("Cm", (B, S, N), _FLOAT), ("dt", (B, S, H), _FLOAT),
         ("A_log", (H,), _F32)), dict(chunk=chunk), dtype)
    L = min(chunk, S)
    intra = _ssd_intra_case(f"{name}/intra-chunk", B=B, nc=max(S // L, 1),
                            L=L, H=H, P=P, N=N, dtype=dtype)
    return [chunked, intra]


def _slstm_case(name, *, B, S, H, hd, dtype=torch.float32):
    return KernelCase(
        name, "slstm_scan",
        (("pre", (B, S, 4, H * hd), _FLOAT), ("R", (4, H, hd, hd), _F32)),
        {}, dtype)


def zoo_cases(dtype=torch.float32) -> list[KernelCase]:
    """The shapes the zoo's published configs run, in ``dtype`` (the
    port serves float32): the JAX package's sweep, case for case, then
    the shapes ``chip_smoke.py`` serves.

    whisper-tiny's 1500-frame audio encoder is checked unpadded, at S = T
    = 1500, as ``whisper-tiny/audio-prefill``.  The JAX package checks
    ``audio-prefill-padded`` at S = 1536, because its Pallas blocks are
    powers of two and 1500 is a multiple of none; the port's flash kernel
    masks a ragged last tile, so the deployment does not pad."""
    from repro_torch.common.config import get_config
    from repro_torch.configs.s2m3_zoo import get_clip_config

    g, l3 = get_config("gemma2-9b"), get_config("llama3-8b")
    wt, zb = get_config("whisper-tiny"), get_config("zamba2-7b")
    xl, vl = get_config("xlstm-1.3b"), get_config("internvl2-1b")
    tl = get_config("tinyllama-1.1b")
    gr, l405 = get_config("granite-moe-3b-a800m"), get_config("llama3-405b")
    ds = get_config("deepseek-v3-671b")
    clip = get_clip_config("mini-clip")
    dt = dict(dtype=dtype)
    gkw = dict(H=g.n_heads, D=g.head_dim, K=g.n_kv_heads,
               softcap=g.attn_logit_softcap, **dt)
    lkw = dict(H=l3.n_heads, D=l3.head_dim, K=l3.n_kv_heads, **dt)
    d_inner = zb.d_model * zb.mamba_expand
    ssd = dict(H=d_inner // zb.mamba_head_dim, P=zb.mamba_head_dim,
               N=zb.ssm_state, **dt)
    xl_hd = xl.d_model // xl.n_heads

    cases = [
        # the JAX package's sweep
        _flash_case("gemma2-9b/global-prefill", B=1, S=2048, T=2048, **gkw),
        _flash_case("gemma2-9b/local-prefill", B=1, S=2048, T=2048,
                    window=g.sliding_window, **gkw),
        _flash_case("llama3-8b/prefill", B=1, S=2048, T=2048, **lkw),
        _flash_case("whisper-tiny/audio-prefill", B=1, S=wt.encoder_seq,
                    T=wt.encoder_seq, H=wt.n_heads, D=wt.head_dim,
                    K=wt.n_kv_heads, causal=False, **dt),
        _flash_case("mini-clip/vision", B=8, S=clip.n_image_tokens,
                    T=clip.n_image_tokens, H=clip.vision_heads,
                    D=clip.vision_width // clip.vision_heads,
                    K=clip.vision_heads, causal=False, **dt),
        _decode_case("gemma2-9b/decode", B=4, T=4096, **gkw),
        _decode_case("llama3-8b/decode", B=4, T=8192, **lkw),
        _paged_decode_case("gemma2-9b/paged-decode", B=4, T=4096, **gkw),
        _paged_decode_case("llama3-8b/paged-decode", B=4, T=8192, **lkw),
        _slstm_case("xlstm-1.3b/scan", B=1, S=512, H=xl.n_heads, hd=xl_hd,
                    **dt),
        *_ssd_cases("zamba2-7b", B=1, S=1024, chunk=zb.mamba_chunk, **ssd),
        # the shapes chip_smoke.py serves: internvl2-1b (G = 7) at phase
        # 3's longest prefill (256 image tokens + 11), solo cache and
        # 4-row paged tick
        _flash_case("internvl2-1b/prefill", B=1, S=267, T=267,
                    H=vl.n_heads, D=vl.head_dim, K=vl.n_kv_heads, **dt),
        _decode_case("internvl2-1b/decode", B=1, T=296, H=vl.n_heads,
                     D=vl.head_dim, K=vl.n_kv_heads, **dt),
        _paged_decode_case("internvl2-1b/paged-decode", B=4, T=512,
                           H=vl.n_heads, D=vl.head_dim, K=vl.n_kv_heads,
                           **dt),
        # zamba2-7b's shared attention (D = 112) at its 383-token prompt
        _flash_case("zamba2-7b/attention-prefill", B=1, S=383, T=383,
                    H=zb.n_heads, D=zb.head_dim, K=zb.n_kv_heads, **dt),
        _decode_case("zamba2-7b/attention-decode", B=1, T=400, H=zb.n_heads,
                     D=zb.head_dim, K=zb.n_kv_heads, **dt),
        # gemma2-9b's 4,100-token prompt, where the window bites
        _flash_case("gemma2-9b/long-local-prefill", B=1, S=4100, T=4100,
                    window=g.sliding_window, **gkw),
        # whisper-tiny's cross-attention over the 1500 frames
        _flash_case("whisper-tiny/cross-prefill", B=1, S=7, T=wt.encoder_seq,
                    H=wt.n_heads, D=wt.head_dim, K=wt.n_kv_heads,
                    causal=False, **dt),
        _decode_case("whisper-tiny/cross-decode", B=1, T=wt.encoder_seq,
                     H=wt.n_heads, D=wt.head_dim, K=wt.n_kv_heads, **dt),
        # chip_smoke.py phase 15's rank tiles on a (1, 2) mesh, pages of 16
        # split in two by slots: internvl2-1b's tick (4 rows of up to 18
        # pages in a pool of 70), gemma2-9b's local layer (up to 257 pages
        # in a pool of 262, the 4,100-token row's window from mid-page);
        # and a page range with 4 of 16 slots, as a (2, 4) mesh lays it
        _paged_tile_case("internvl2-1b/paged-tile-rank", B=4, n_max=18,
                         n_pages=70, pages=70, s0=8, H=vl.n_heads,
                         D=vl.head_dim, K=vl.n_kv_heads, **dt),
        _paged_tile_case("gemma2-9b/paged-tile-local-rank", B=4, n_max=257,
                         n_pages=262, pages=262, window=g.sliding_window,
                         **gkw),
        _paged_tile_case("internvl2-1b/paged-tile-page-range", B=4, n_max=18,
                         n_pages=70, pages=35, p0=35, slots=4, s0=4,
                         H=vl.n_heads, D=vl.head_dim, K=vl.n_kv_heads, **dt),
        # deepseek-v3-671b's latent pool: chip_smoke.py phase 9's 4-row
        # tick and portbench's dots-vlm1.ocr tick (64 rows of up to 3,200
        # keys), float32 only
        *(_paged_mla_case(f"deepseek-v3-671b/paged-mla-decode{tag}", B=B,
                          T=T, H=ds.n_heads, r=ds.kv_lora_rank,
                          rope=ds.qk_rope_dim)
          for tag, B, T in (("", 4, 256), ("-64rows", 64, 3200))
          if dtype is torch.float32),
        # xlstm-1.3b's decode step (the one-step kernel)
        _slstm_case("xlstm-1.3b/step", B=1, S=1, H=xl.n_heads, hd=xl_hd,
                    **dt),
        # zamba2-7b's prefills of 126, 200 and 383 tokens: 1 chunk of
        # 126, 2 and 3 chunks of 128
        *(_ssd_intra_case(f"zamba2-7b/prefill-{nc}-chunk", B=1, nc=nc, L=L,
                          **ssd)
          for nc, L in ((1, 126), (2, 128), (3, 128))),
    ]
    # G = 8, 3 and 16 at phase 7-9's prompts of up to 11 tokens, solo
    # caches of 32 / 24 tokens and 4-row ticks of 256-token rows
    for arch, c, T_solo in (("tinyllama-1.1b", tl, 32),
                            ("granite-moe-3b-a800m", gr, 24),
                            ("llama3-405b", l405, 24)):
        geo = dict(H=c.n_heads, D=c.head_dim, K=c.n_kv_heads, **dt)
        cases += [
            _flash_case(f"{arch}/prefill", B=1, S=11, T=11, **geo),
            _decode_case(f"{arch}/decode", B=1, T=T_solo, **geo),
            _paged_decode_case(f"{arch}/paged-decode", B=4, T=256, **geo),
        ]
    return cases


def error_cases(dtype=torch.float32) -> list[KernelCase]:
    """Geometries the kernels cannot launch, each of which must raise in
    its wrapper on the card: one for each ERROR rule a shape can reach
    (``kernel/smem-limit`` is reached by none; see the module's
    docstring).  ``bad/ssd-tile-oversized`` (N = 1024) would need at
    least ``ops.ssd_smem(128, 64, 1024, 32, 32)`` = 423,424 B a block, but
    the wrapper refuses N above ``ops.SSD_MAX_DIM`` first: ``no-plan``."""
    return [
        _flash_case("bad/flash-head-dim-96", B=1, S=64, T=64, H=4, K=4,
                    D=96, dtype=dtype),
        _decode_case("bad/decode-head-dim-96", B=1, T=64, H=4, K=4, D=96,
                     dtype=dtype),
        _slstm_case("bad/slstm-hd-1024", B=1, S=4, H=1, hd=1024,
                    dtype=dtype),
        _slstm_case("bad/slstm-hd-136", B=1, S=4, H=1, hd=136, dtype=dtype),
        _ssd_intra_case("bad/ssd-state-256", B=1, nc=1, L=128, H=2, P=64,
                        N=256, dtype=dtype),
        _ssd_intra_case("bad/ssd-tile-oversized", B=1, nc=1, L=128, H=2,
                        P=64, N=1024, dtype=dtype),
        _decode_case("bad/decode-grid", B=65536, T=16, H=1, K=1, D=16,
                     dtype=dtype),
        _flash_case("bad/flash-grid", B=65536, S=1, T=1, H=1, K=1, D=16,
                    dtype=dtype),
        _paged_tile_case("bad/paged-tile-slots", B=1, H=4, K=2, D=16,
                         n_max=2, n_pages=8, pages=8, slots=8, s0=12,
                         dtype=dtype),
    ]


#: case name -> the finding code ``check_case`` gives it
ERROR_CODES = {
    "bad/flash-head-dim-96": "kernel/no-plan",
    "bad/decode-head-dim-96": "kernel/no-plan",
    "bad/slstm-hd-1024": "kernel/no-plan",
    "bad/slstm-hd-136": "kernel/cluster",
    "bad/ssd-state-256": "kernel/no-plan",
    "bad/ssd-tile-oversized": "kernel/no-plan",
    "bad/decode-grid": "kernel/grid-limit",
    "bad/flash-grid": "kernel/grid-limit",
    "bad/paged-tile-slots": "kernel/tile-range",
}


def launch_plan(case: KernelCase, n_sm: int) -> LaunchPlan:
    """The launch ``case.entry`` makes on a card of ``n_sm`` SMs, from the
    wrapper's own planners, for a shape the wrapper accepts (whether it
    does is ``check_case``'s verdict, from the wrapper itself)."""
    e, kw = case.entry, case.kwargs
    if e == "flash_attention":
        B, S, H, D = case.shape("q")
        p = ops.flash_plan(D, case.dtype)
        kernel = ("flash_fwd_mma" if case.dtype is torch.bfloat16
                  else "flash_fwd")
        return LaunchPlan(kernel, ops.flash_grid(B, S, H, D, case.dtype),
                          p.threads, p.smem, plan=p)
    if e in ("decode_attention", "paged_decode_attention"):
        B, H, D = case.shape("q")
        if e == "decode_attention":
            T, K = case.shape("k")[1:3]
        else:
            ps, K = case.shape("k_pages")[1:3]
            T = case.shape("block_tables")[1] * ps
        # a tile's splits share its n_max * (its slots) candidate keys
        G = H // K
        n_split = ops.decode_splits(T, B, K, G, n_sm, kw.get("window", 0))
        grid = ops.decode_grid(B, K, G, n_split)
        kernel = "decode_fwd" if e == "decode_attention" else \
            "paged_decode_fwd"
        return LaunchPlan(kernel, grid, 32 * ops.DECODE_HEADS_PER_BLOCK, 0,
                          blocks_per_sm=ops.DECODE_BLOCKS_PER_SM,
                          workspace=ops._decode_ws_bytes(B, H, D, n_split),
                          tile=kw.get("tile"))
    if e == "paged_mla_decode":
        B, H, r = case.shape("q_lat")
        ps = case.shape("ckv_pages")[1]
        T = case.shape("block_tables")[1] * ps
        n_split = ops.mla_splits(T, B, H, n_sm)
        return LaunchPlan("paged_mla_decode_kernel",
                          ops.mla_grid(B, H, n_split), ops.MLA_THREADS,
                          ops.MLA_SMEM,
                          blocks_per_sm=ops.MLA_BLOCKS_PER_SM,
                          workspace=ops._mla_ws_bytes(B, H, r, n_split))
    if e in ("ssd_intra_chunk", "ssd_chunked"):
        if e == "ssd_intra_chunk":
            B, nc, L, H, P = case.shape("x")
        else:
            B, S, H, P = case.shape("x")
            L = min(kw.get("chunk", 128), S)
            nc = S // L
        N = case.shape("Bm")[-1]
        p = ops.ssd_plan(L, P, N, H, B * nc, n_sm)
        return LaunchPlan("ssd_tile_kernel", (p.blocks, 1, 1), p.threads,
                          p.smem, blocks_per_sm=p.blocks_per_sm, plan=p)
    if e == "slstm_scan":
        B, S = case.shape("pre")[:2]
        _, H, hd, _ = case.shape("R")
        p = ops.slstm_plan(B, H, hd)
        grid = ops.slstm_grid(B, S, H, hd)
        if S == 1:
            return LaunchPlan("slstm_step_kernel", grid,
                              ops.SLSTM_STEP_THREADS, 0, plan=p)
        return LaunchPlan("slstm_prefill_kernel", grid, p.threads, p.smem,
                          cluster=p.cluster, plan=p)
    raise ValueError(f"unknown kernel entry point {e!r}")


def plain(case: KernelCase, args):
    """The plain version of ``case.entry`` on ``args`` (for
    ``ssd_chunked`` the step-by-step recurrence, not the chunked form):
    what the kernel is held to."""
    kw = case.kwargs
    if case.entry == "flash_attention":
        return ref.flash_attention_ref(*args, **kw)
    if case.entry == "decode_attention":
        return ref.decode_attention_ref(*args, **kw)
    if case.entry == "paged_decode_attention":
        return ref.paged_decode_attention_ref(*args, **kw)
    if case.entry == "paged_mla_decode":
        return ref.paged_mla_decode_ref(*args, **kw)
    if case.entry == "ssd_intra_chunk":
        return ref.ssd_intra_chunk_ref(*args)
    if case.entry == "ssd_chunked":
        return ref.ssd_scan_ref(*args)
    return ref.slstm_scan_ref(*args)


def leaves(out) -> list[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    return [t for o in out for t in leaves(o)]


def _work(case: KernelCase, args, outs) -> tuple[int, float]:
    """The case's bytes (each input read once, each output written once)
    and operations: 4 D a visible (query, key) pair and head in
    attention (every key of a full row live), C.B^T and M.x over the
    causal pairs and B^T.x over each chunk in SSD, the four recurrent
    products and the cell's ~10 operations a unit and step in sLSTM."""
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    e, kw = case.entry, case.kwargs
    if e == "flash_attention":
        B, S, H, D = case.shape("q")
        T = case.shape("k")[1]
        w = kw.get("window", 0)
        if kw.get("causal", True):
            pairs = sum(min(i + 1, w) if w else i + 1 for i in range(min(S, T)))
        else:
            pairs = S * T
        return nbytes, 4.0 * D * H * B * pairs
    if e in ("decode_attention", "paged_decode_attention"):
        B, H, D = case.shape("q")
        if e == "decode_attention":
            T = case.shape("k")[1]
        else:
            T = case.shape("block_tables")[1] * case.shape("k_pages")[1]
        w = kw.get("window", 0)
        return nbytes, 4.0 * D * H * B * (min(T, w) if w else T)
    if e == "paged_mla_decode":
        B, H, r = case.shape("q_lat")
        rope = case.shape("q_pe")[2]
        T = case.shape("block_tables")[1] * case.shape("ckv_pages")[1]
        return nbytes, 2.0 * B * H * T * (2 * r + rope)
    if e in ("ssd_intra_chunk", "ssd_chunked"):
        if e == "ssd_intra_chunk":
            B, nc, L, H, P = case.shape("x")
        else:
            B, S, H, P = case.shape("x")
            L = min(kw.get("chunk", 128), S)
            nc = S // L
        N = case.shape("Bm")[-1]
        pairs = L * (L + 1) / 2
        return nbytes, B * nc * H * (2 * pairs * (N + P) + 2 * L * N * P)
    B, S, _, d = case.shape("pre")
    hd = case.shape("R")[2]
    return nbytes, B * S * (8.0 * d * hd + 10.0 * d)


def _dtype_name(dtype) -> str:
    return {torch.float32: "float32", torch.bfloat16: "bfloat16"}[dtype]


def check_case(case: KernelCase, *, n_sm: int | None = None
               ) -> list[Diagnostic]:
    """The findings for one case on a card of ``n_sm`` SMs (the H100's by
    default)."""
    n_sm = hw.H100_SXM.sms if n_sm is None else n_sm
    args = case.meta_args()
    try:
        got = leaves(getattr(ops, case.entry)(*args, **case.kwargs))
    except ops.KernelPlanError as err:
        code = next(c for cls, c in PLAN_CODES if isinstance(err, cls))
        return [Diagnostic(
            Severity.ERROR, code, str(err), entity=case.name,
            hint="the wrapper raises at launch on the card for this shape; "
                 "see the planners in repro_torch.kernels.ops")]
    except ValueError as err:
        return [Diagnostic(Severity.ERROR, "kernel/invalid-shape", str(err),
                           entity=case.name)]
    except Exception as err:    # the wrapper broke: report, don't die
        return [Diagnostic(
            Severity.ERROR, "kernel/meta-eval",
            f"{case.entry} failed on meta tensors: {type(err).__name__}: "
            f"{err}", entity=case.name)]
    diags: list[Diagnostic] = []
    want = leaves(plain(case, args))
    if len(got) != len(want):
        diags.append(Diagnostic(
            Severity.ERROR, "kernel/shape-drift",
            f"{case.entry} returns {len(got)} tensor(s), the plain version "
            f"{len(want)}", entity=case.name))
        return diags
    for i, (g, w) in enumerate(zip(got, want)):
        if tuple(g.shape) != tuple(w.shape):
            diags.append(Diagnostic(
                Severity.ERROR, "kernel/shape-drift",
                f"{case.entry} output[{i}] shape {tuple(g.shape)} != plain "
                f"{tuple(w.shape)}", entity=case.name,
                hint="the wrapper and kernels/ref.py disagree — fix "
                     "whichever drifted"))
        elif g.dtype != w.dtype:
            diags.append(Diagnostic(
                Severity.ERROR, "kernel/dtype-drift",
                f"{case.entry} output[{i}] dtype {g.dtype} != plain "
                f"{w.dtype}", entity=case.name,
                hint="check the dtype the wrapper allocates its output in"))

    lp = launch_plan(case, n_sm)
    # MLA's decode holds one block an SM by design: its ring of key tiles
    # keeps loads in flight across the block's barriers
    if isinstance(lp.plan, ops.SsdPlan) and lp.blocks_per_sm < 2:
        diags.append(Diagnostic(
            Severity.WARNING, "kernel/occupancy",
            f"{case.entry}: the plan holds {lp.blocks_per_sm} block(s) an "
            "SM; one block's barriers then idle the SM", entity=case.name,
            hint="a narrower S_loc tile (ops.ssd_layout) halves the shared "
                 "memory a block"))
    nbytes, flops = _work(case, args, got)
    t, by = hw.bound_s(nbytes, flops, _dtype_name(case.dtype))
    extra = (f", clusters of {lp.cluster}" if lp.cluster > 1 else "") + (
        f", {lp.blocks_per_sm} blocks an SM" if lp.blocks_per_sm else "") + (
        f", {lp.workspace} B workspace" if lp.workspace else "") + (
        f", tile (p0, n_pages, s0, page_size) {lp.tile}" if lp.tile else "")
    diags.append(Diagnostic(
        Severity.INFO, "kernel/summary",
        f"{case.entry} -> {lp.kernel}: grid={lp.grid}, {lp.threads} "
        f"threads, {lp.smem / _KB:.1f} KiB dynamic shared memory{extra}; "
        f"bound {t * 1e3:.5f} ms by {by} ({nbytes} B, {flops:.3e} FLOP)",
        entity=case.name))
    return diags


def check_kernels(*, device=None, cases: list[KernelCase] | None = None
                  ) -> list[Diagnostic]:
    """Run every case (default: the zoo sweep, which covers all of
    ``ENTRY_POINTS``) and concatenate the findings.  ``device``: a CUDA
    device reads its SM count from the card (nothing is launched); None
    or the CPU take the H100's."""
    n_sm = ops.sm_count(torch.device("meta" if device is None else device))
    diags: list[Diagnostic] = []
    for c in (zoo_cases() if cases is None else cases):
        diags.extend(check_case(c, n_sm=n_sm))
    return diags
