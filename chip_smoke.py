#!/usr/bin/env python3
"""Drive the PyTorch port's main paths once on one NVIDIA GPU.

    python3 chip_smoke.py          # from the root of a checkout

Phases (any failure exits non-zero; nothing is caught):

1. Build: compile the CUDA kernels under ``src/repro_torch/csrc`` with
   ``nvcc`` for sm_90a (one process per source, in parallel), print the
   card's name and power limit, each kernel instance's registers,
   static shared memory and spills (``ptxas -v``; a spill in an
   attention or SSD kernel fails; the bfloat16 flash instance,
   ``flash_fwd_mma``, must be there at every head dim), the flash
   kernel's tiles and dynamic shared memory per head dim and dtype (the
   float32 and the bfloat16 instance have their own), the SSD kernel's
   plan at zamba2-7b's three prefill shapes (tiles, threads, shared
   memory, and how many blocks an SM holds:
   ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, at least
   two), and the sLSTM prefill kernel's plan at xlstm-1.3b (cluster size,
   shared memory, and how many such clusters the card holds at once:
   ``cudaOccupancyMaxActiveClusters``).
2. Kernels: hold each hand-written kernel against its plain PyTorch
   version on the card, at the shapes the serving paths give it, in
   float32 and bfloat16: the attention kernels at internvl2-1b's head
   geometry (random lengths, garbage block-table entries past each
   row's pages, a logit softcap, a ragged S) and at zamba2-7b's shared
   attention (H = K = 32, D = 112), with the flash kernel's edges (S = 1,
   S under one tile, windows, non-causal, B = 2, softcap) and the
   split-KV decode kernels' (lengths 0, 1, a split boundary +- 1 and T
   in one batch, G = 1 and 7, B = 4, softcap; for the paged kernel also
   ps - 1, ps, ps + 1 and the full span, at D = 16, 64 and 112); the
   Mamba2 SSD intra-chunk kernel at zamba2-7b's three prefill shapes (one
   chunk of 126, two and three of 128), phase 14's rank (two chunks on
   56 of the 112 heads) and the smoke shape, and the sLSTM kernels at
   xlstm-1.3b's (S = 383 and 1000, two rows of two steps, one decode
   step), phase 14's rank (2 of the 4 heads: S = 200 and a decode step)
   and the smoke shape (fresh and random state; R as four gate tensors
   against R stacked), and the paged kernel's tile mode at phase 15's
   rank tiles (internvl2-1b's tick on 8 of 16 slots, gemma2-9b's local
   layer, and a page range with 4 of 16 slots as a (2, 4) mesh lays the
   pool out: o and the log-sum-exp); then
   time each kernel (CUDA events over back-to-back calls; its own
   device time under ``torch.profiler``; the wrapper's host enqueue
   time), its plain version and, where one PyTorch call computes the
   same function (``scaled_dot_product_attention``), that call, in turns
   with the kernel.
3. Serve internvl2-1b at full width (24 layers, d_model 896, random
   float32 weights from a seed) as the generative head ``vlm-head``
   behind a shared encoder ``pix-enc``, three tasks (caption, ocr,
   classify), eight requests through ``Deployment.serve()`` and the
   generative ones again through ``Deployment.submit()``.  Tokens and
   every step's logits, routes, cross-task batching, the drained page
   pool and the kernel launch counts are checked.  The recorded serve()
   takes the eager decode step (the only one that keeps every row's
   logits); the same requests are then served once more on the tick's
   CUDA graph: its tokens == the eager ticks', one capture and every
   later tick a replay, the replays' counted paged launches == ticks x
   layers, and the rates are that run's.  Before it, the
   model's logits through the kernels on the card are held against the
   plain versions on the CPU, at smoke size and at full width with
   depth cut to 2 layers.
4. Profile: one more serve() under ``torch.profiler`` — device busy
   share and the kernels that take the device time.
5. Recurrent families: xlstm-1.3b and zamba2-7b at their published
   widths and depths, random float32 weights from a seed, each serving
   three greedy requests (prompts of 126, 200 and 383 tokens, 16 new
   tokens) through ``repro_torch.launch.serve.serve_arch`` and
   ``Deployment.submit()``.  Checked: finite logits, decode == a fresh
   prefill at the first decode step and across the 128-token chunk
   boundary, exact kernel launch counts; and before it, the same
   weights through the kernels on the card against the plain versions
   on the CPU at full width with depth cut to one group / superblock.
   Then a warm prefill of the longest prompt is timed, and three decode
   steps run under ``torch.profiler`` (device busy share, kernels per
   step, the kernels that take the device time).
6. The paper's multi-task scenario, ``repro_torch.examples.
   multi_task_serving``, on the card: retrieval, classification and VQA
   on the shared mini-clip towers (flash D = 16) through plan,
   materialize, verify, simulate + submit, split == monolithic, a
   9-request serve() burst with cross-task batches, SLO rows, the trace,
   compare() (no route divergence) and evict + replan.  Checked: every
   check of the CPU test, the towers on the card against the CPU, and
   exactly one flash launch per tower layer per tower call (each tower's
   counted at its own call shapes).
7. tinyllama-1.1b (22 layers, d_model 2048, 32 q / 4 kv heads) and
   whisper-tiny (4 + 4 layers, 1500 encoder frames) at their published
   widths and depths, random float32 weights from a seed, through
   ``launch.serve.serve_arch``: tinyllama's 6 greedy requests through the
   paged scheduler and again through the solo path (tokens and every
   step's logits equal), whisper's 3 through ``Deployment.submit()``;
   decode == a fresh prefill, card == CPU (tinyllama with depth cut to
   2 layers, whisper at full depth), exact launch counts by kernel and
   by call shape, prefill ms and decode tokens/s; tinyllama's requests
   again on the tick's CUDA graph, as phase 3's.  Phase 2 checks and
   times the attention kernels at these phases' shapes (D = 16 towers,
   G = 8, S = T = 1500, the cross-attention prefill, T = 1500 cross
   decode, the paged G = 8 tick).
8. gemma2-9b (local layers windowed to 4,096 keys, softcaps 50 and 30,
   head dim 256), llama3-8b (head dim 128) and granite-moe-3b-a800m (40
   experts padded to 48, top-8, G = 3) at their published widths, depth
   cut to 8 layers each (of 42, 32 and 32; phase 14 carries the
   script's full-depth time), one after the other
   (random float32 weights from a seed; each freed before the next, its
   peak device memory printed), through ``launch.serve.serve_arch``:
   4 greedy requests of 4-12 prompt tokens each, and for gemma2 a fifth
   whose 4,100-token prompt passes the window (in flash prefill and in
   paged and dense decode), through the paged scheduler and again solo;
   tokens and every step's logits serve == submit, decode == a fresh
   prefill (gemma2's long request past position 4,096), card == CPU at
   full width with depth cut to 2 layers, exact launches by kernel and
   by call shape (local and global apart), prefill ms, tokens/s, device
   busy over 3 decode steps; then the requests again on the tick's CUDA
   graph, as phase 3's.  Phase 2 checks and times the attention
   kernels at these shapes (flash D = 256 local and global at S =
   4,100, D = 128, D = 64 with G = 3; decode D = 256 local and global,
   D = 128; paged D = 256 local, D = 128), with the window's edges.
9. deepseek-v3-671b and llama3-405b at their published widths, depth
   cut to fit one card (random float32 weights from a seed; each freed
   before the next).  deepseek (MLA with its latent cache, 256 routed
   experts top-8 and a shared one, the MTP weights carried) at 2 layers,
   one dense and one MoE (14,630,400,000 parameters), serves phase 8's 4
   greedy requests through ``launch.serve.serve_arch``'s paged scheduler
   (the latent pages, the absorbed decode through ``paged_mla_decode``)
   and again solo (``submit()``): tokens and every step's logits serve
   == submit, finite logits, decode == a fresh prefill, card == CPU at 2
   layers with 16 of the 256 experts (a cut for the host), exact
   launches (``paged_mla_decode`` once a layer a tick, no other kernel),
   then the requests again on the tick's CUDA graph; prints the prefill
   time, serve() and solo tokens/s beside the weight-read floor, the
   latent cache's bytes a token and the peak device memory, which must
   stay below the weights plus one expert leaf.  Phase 2 holds
   ``paged_mla_decode`` to its plain version at its tick (4 rows, 128
   heads, lengths across page boundaries), at edge lengths and at
   dots-vlm1.ocr's 64 rows, and times it.  llama3-405b (128 q / 8 kv heads of 128, G = 16) at 2 layers
   runs phase 8's path and checks, card == CPU at 1 layer; phase 2
   checks and times the three attention kernels at its shapes.
10. The analysis passes against the card: the kernel checker's sweep
   (``check_kernels(device=...)``) gives no ERROR and its flash, SSD and
   sLSTM plans equal the built kernels' (``flash_attention_plan`` in
   each dtype, ``ssd_intra_chunk_info``, ``slstm_prefill_info``); every
   case it passes launches once at its full shape in float32 with seeded
   inputs and matches its plain version at the tests' f32 tolerance
   (rtol = atol = 2e-4); every case it marks ERROR
   (head dim 96, sLSTM head dims 1024 and 136, SSD states of 256 and
   1024, grid extents above CUDA's, a paged tile past its page) raises in
   its wrapper; the checker's tile plans (threads, blocks an SM) against
   the built kernel's ``paged_decode_tile_info``, and each split-KV
   case's outputs and workspace as the wrapper reports them against the
   plan's; phase 3's
   deployment and phase 6's scenario verify clean with ``kernels=True,
   model_check=True`` before they materialize; ``python -m
   repro_torch.analysis --self`` exits 0.
11. Training: tinyllama-1.1b at full width and depth (22 layers, float32)
   takes 20 steps of ``training.train_step.make_train_step`` on the
   synthetic corpus (seq 128, batch 8, lr 1e-3, warmup 10) with remat
   "none" and 5 with "full": each step's loss and grad norm, finite,
   the loss falling by the margin the CPU rehearsal predicts; step ms,
   tokens/s and peak GB of each policy beside the 6 N tokens floor.  The
   trained weights' loss through the kernels under no_grad == the plain
   path's, with one flash launch a layer at the training shape (this
   phase's main path).  At full width cut to 2 layers: the loss and
   every gradient leaf card == CPU, one AdamW update card == CPU, two
   microbatches == one.  Each kernel wrapper raises ``NoBackwardError``
   on a card input that requires grad and launches under no_grad.  A
   checkpoint written by ``save_async`` mid-run, restored into fresh
   weights, steps as the uninterrupted run does.
12. The distributed path: granite-moe-3b-a800m at full width, depth cut
   to 8 of its 32 layers (phase 14 carries a mesh path at full depth)
   (random float32 weights, each leaf drawn whole from seed 0 on every
   rank, each rank keeping its slice) through ``build_model(cfg,
   mesh=..., rules=...)``, phase 8's 4 greedy requests served solo
   (prefill, then 7 decode steps), in spawned ranks after phase 11 has
   freed its memory: (a) one rank over NCCL on a (1, 1) mesh with the
   reference's serving rules (its expert-parallel MoE routes with
   capacity drops, prefill through the flash kernel, decode through the
   decode kernel); (b) two ranks sharing the card over gloo on a (1, 2)
   mesh with the serving rules plus replicated heads and the shardmap
   decode over a sequence-sharded cache (24 experts a rank).  Checked:
   (a) and (b) give equal tokens and every step's logits within 2e-4;
   (b) issues only all_reduce (``CommDebugMode``), exactly one a layer at
   a prefill and four a layer at a decode step; exact flash and decode
   launches by call shape in each rank; (b)'s decode == a fresh prefill
   (at the capacity factor that drops no token) within 5e-4; (b) cut to
   2 layers == the mesh path on the CPU (a world of one, gloo) within
   2e-4.  Prints each rank's held weight bytes and peak memory, prefill
   ms, tokens/s and all_reduces beside the weight-read floor.
13. The dry run against the card (``repro_torch.launch.dryrun``: meta
   tensors over a fake process group, counted by
   ``common.profiling``): (a) phase 12 (b)'s granite on two gloo ranks
   sharing the card, a prefill of phase 8's 11-token prompt and one
   decode step counted on the card (after a warm-up) and laid out on
   meta over a fake group of 2: argument bytes, dot FLOPs and
   collectives by kind (count and bytes) equal, the predicted temp
   within 10 % of the card's peak above the arguments, exact flash and
   decode launches by shape in each rank; (b) phase 11's tinyllama-1.1b
   step (B 8, S 128, remat "none", float32) as DTensors on one NCCL
   rank, mesh (1, 1): the loss == the unsharded loss of the same weights
   and batch (2e-4), argument bytes equal, the predicted peak within 10 %
   of ``max_memory_allocated``; (c) meanwhile on the host, four
   production cells through the dry-run CLI (tinyllama-1.1b train_4k,
   granite-moe-3b-a800m decode_32k and zamba2-7b long_500k, the
   reference's long-context cell, on 16 x 16, llama3-405b prefill_32k
   on 2 x 16 x 16), each exiting 0 within 300 s with FLOPs and
   collective bytes above 0; their HBM a card, roofline terms and
   model/counted FLOPs are printed as predictions from the H100's
   published figures.
14. The recurrent families on a mesh: zamba2-7b (81 Mamba2 blocks, 13
   shared-attention calls) and xlstm-1.3b (48 blocks) at full width and
   depth (random float32 weights from a seed), each on two gloo ranks
   sharing the card, mesh (1, 2), the reference's serving rules: every
   Mamba2, mLSTM and sLSTM block on its rank's heads (``shard_map``), the
   SSD kernel on 56 of 112 heads, flash and decode on 16 of 32, the sLSTM
   kernels on 2 of 4; prompts of 126 and 200 tokens, 4 decode steps
   each.  The unsharded bundle of the same weights runs first in the
   main process and is freed.  Checked: tokens equal to it and every
   step's logits within 2e-4; decode == a fresh prefill within 5e-4;
   exact launches by call shape in each rank; collectives by kind over
   the path and at one prefill and one decode step equal to the count
   derived from the code; the two ranks' peaks below the card's 80 GB;
   each arch cut to the fewest layers that hold every block kind (7 and
   8) == the mesh path on the CPU within 2e-4.  Prints each rank's held
   weights, peak memory, prefill ms and ms a decode step.
15. Paged decode under a mesh: internvl2-1b at full width and depth (24
   layers) and gemma2-9b at full width cut to 2 layers (one local/global
   pair), random float32 weights from a seed, each on two gloo ranks
   sharing the card, mesh (1, 2), the reference's serving rules, through
   ``build_model(cfg, mesh=, rules=)``'s ``init_paged_cache`` and
   ``paged_decode_step``: the page pool laid out as the reference lays it
   out (pages over "cache_batch", each page's 16 slots over "cache_seq":
   8 a rank), the paged kernel's tile mode once a layer a tick on each
   rank's tile and the ranks' partial softmaxes combined.  Four requests
   (phase 8's prompts; gemma2's fourth the 4,100-token one, whose window
   starts mid-page), each prefilled alone into a one-row dense cache and
   copied into the pool (``insert_pages``), then 7 batched ticks.  The
   unsharded bundle's paged step of the same weights runs first in the
   main process.  Checked: tokens equal to it and every step's logits
   within 2e-4; the longest request's first tick == a fresh prefill
   within 5e-4; exact launches by call shape in each rank (the tile mode
   at the kernel checker's case's shape, flash on 7 of 14 / 8 of 16
   heads); every tick's collectives by kind equal to the count derived
   from the code; the ranks' peaks below the card's 80 GB; internvl2-1b
   cut to 2 layers == the mesh path on the CPU within 2e-4.  Prints each
   rank's held and peak GB, prefill ms and ms a tick.
16. The reference's default compute, bfloat16 (``build_model(cfg)``):
   (a) internvl2-1b at full width and depth on the main path, its
   weights phase 3's float32 draws cast to bfloat16, phase 3's requests
   through serve() and submit() (the engine's caches float32, q widened
   at the decode kernels); (b) the same through the bundle at its
   defaults, a bfloat16 dense cache and page pool; (c) zamba2-7b at full
   width cut to 8 layers.  Checked: routes, compare(), the pool drained;
   serve() == submit() tokens; launches exact by shape and dtype; at full
   depth the bfloat16 paths round alike (each no further from the
   float32 compute on the same weights than twice its peer), decode ==
   prefill in (b) and card == CPU at 2 layers within rtol = atol 3e-2.
   Prints (a)'s rates beside phase 3's float32 ones.  Phase 2's bfloat16
   rows read their launches off these paths, but for the flash row at
   gemma2-9b's 4,100-token local layer, which no bfloat16 path runs (its
   launches 0, and a failure if one of these paths ran that shape).
17. Print the kernels line (JSON), the card line, and last
   ``{"ok": true, "device": {...}}``.  Each row of the kernels line is
   timed at a call shape its path runs; its ``launches`` are that path's
   main-path launches at that shape (``ops.SHAPE_LAUNCHES``), beside
   the kernel's launches on the path (``launches_of_kernel``); a row
   whose shape its path never ran fails.

It exits non-zero, printing no result, when no CUDA device is visible
or when run outside a checkout of the repository.  Every phase prints
``[phaseN] done in X s``.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0

# |got - want| <= atol + rtol * |want|, elementwise, as (atol, rtol)
TOL = {"float32": (2e-4, 0.0),        # f32 math, another summation order
       # both sides do f32 math on the same bf16 inputs and round the
       # result to bf16: at most one bf16 ulp (2^-7 relative) apart; the
       # 1e-3 floor stays below one key's share of a ~270-key softmax
       "bfloat16": (1e-3, 2.0**-7)}
# TOL["bfloat16"] passes one bf16 ulp anywhere, so it cannot tell float32
# math from a narrower one.  A bf16 flash output is also read against
# exact (float64) attention rounded to bf16: the share of outputs that
# differ (``ref.flips``) may be at most FLIPS_MULTIPLE times the plain
# version's on the same inputs.  Float32 math flips ~0.02-0.06 % (its
# summation order); P kept to ~17 bits, or O summed in the tensor cores'
# truncating accumulators over 4,096 keys, flips 0.18-0.37 % (H100).
FLIPS_MULTIPLE = 3.0
# A library call in bf16 (SDPA, flex_attention) rounds P to bf16 before
# P.V, a narrower function than the kernels' (2.3x TOL["bfloat16"] for
# flex_attention at gemma2-9b's local layer, H100); it stands as the
# library time where it is within this multiple of the tolerance.
LIB_BF16_MULTIPLE = 4.0
# phase 10 holds each kernel-checker case to its plain version at
# TOL["float32"], except the SSD cases: those are held to the plain
# version in float64 (ssd_intra_chunk_ref, and for ssd_chunked the
# step-by-step ssd_scan_ref), each output no further from it than
# SSD_F64_MULTIPLE times the float32 plain version of the same chunked
# algorithm is, plus SSD_F64_FLOOR for outputs float32 holds almost
# exactly (Lam near 0).  An SSD y reaches |y| ~ 50, where float32's
# exp(cum_t - cum_s) alone costs the plain version ~1e-4
# (tools/ssd_precision.py)
SSD_ENTRIES = ("ssd_intra_chunk", "ssd_chunked")
SSD_F64_MULTIPLE, SSD_F64_FLOOR = 2.0, 1e-6

# the serving path's shapes (internvl2-1b: H=14, K=2, D=64)
H, K, D = 14, 2, 64
PROMPT_MAX, MAX_NEW_MAX = 12, 32
N_IMG = 256
ROWS, PAGE, N_MAX, N_PAGES = 4, 16, 32, 129

# the recurrent paths (phase 5): prompts of 126, 200 and 383 tokens, 16
# new tokens each; zamba2-7b's shared attention (H = K = 32, D = 112)
# and its SSD prefills (B=1; the prompts run as 1 chunk of L=126, 2 and
# 3 chunks of L=128 after padding; H=112 heads of P=64, state N=64), one
# kernels-line row each; xlstm-1.3b's sLSTM (d=2048, H=4 heads of hd=512)
REC_PROMPTS, REC_NEW = (126, 200, 383), 16
S_REC = max(REC_PROMPTS)
Z_HEADS, Z_D, T_REC = 32, 112, 400
SSD_SHAPE = (1, 3, 128, 112, 64, 64)                     # B, nc, L, H, P, N
SSD_ROWS = {"ssd_intra_chunk": SSD_SHAPE,
            "ssd_intra_chunk_nc2": (1, 2, 128, 112, 64, 64),
            "ssd_intra_chunk_l126": (1, 1, 126, 112, 64, 64)}
SSD_SMOKE = (2, 2, 8, 8, 16, 16)                          # the smoke config
# phase 14's per-rank shapes: zamba2-7b's 200-token prefill (two chunks of
# 128) on one rank's 56 of 112 heads; xlstm-1.3b's sLSTM on 2 of its 4
# heads (hd 512) at the 200-token prefill and a decode step
SSD_MESH_ROWS = {"ssd_intra_chunk_h56": (1, 2, 128, 56, 64, 64)}
SL_MESH = (1, 200, 2, 512)
SL_D, SL_H = 2048, 4
# the sLSTM kernels' checks (B, S, H, hd): xlstm-1.3b's longest prompt,
# its decode step, a long prefill, two rows of two steps, and smoke
SLSTM_CHECKS = ((1, S_REC, SL_H, 512), (1, 1, SL_H, 512),
                (1, 1000, SL_H, 512), (2, 2, SL_H, 512), (2, 9, 4, 16),
                SL_MESH)

# the multi-task scenario (phase 6): the mini-clip towers, H = K = 4
# heads of 16; a request carries 4 images of 16 patches and 4 token rows
# of 12, and serve() batches up to 8 requests (32 rows) at a tower
CLIP = "mini-clip"
CLIP_B, CLIP_HEADS, CLIP_D, CLIP_PATCHES, CLIP_TEXT = 4, 4, 16, 16, 12
# phase 7: tinyllama-1.1b (32 q / 4 kv heads of 64) serves 6 greedy
# requests, prompts of 4-12 tokens, 16 new tokens, 4 decode rows, pages
# of 16 (the serve launcher's pool: 4 x 256 / 16 + 1 pages); whisper-tiny
# (6 heads of 64, 1500 encoder frames) 3 greedy requests, prompts of 2-8
# tokens, 16 new tokens
TL_ARCH, TL_REQS, TL_NEW, TL_PROMPTS = "tinyllama-1.1b", 6, 16, (4, 12)
TL_H, TL_K, TL_ROWS, TL_CACHE = 32, 4, 4, 256
TL_PAGES, TL_NMAX = TL_ROWS * TL_CACHE // PAGE + 1, TL_CACHE // PAGE
W_ARCH, W_REQS, W_NEW, W_PROMPTS = "whisper-tiny", 3, 16, (2, 8)
W_HEADS, W_T = 6, 1500
# phase 8: gemma2-9b (16 q / 8 kv heads of 256, local layers windowed to
# 4,096 keys, softcap 50), llama3-8b (32 / 8 of 128) and
# granite-moe-3b-a800m (24 / 8 of 64, G = 3), each 4 greedy requests of
# 4-12 prompt tokens, 8 new tokens, 4 decode rows, pages of 16; gemma2
# a fifth request whose 4,100-token prompt passes the window, in a pool
# whose rows hold 4,112 tokens
FAM_ARCHS = ("gemma2-9b", "llama3-8b", "granite-moe-3b-a800m")
# phase 8 cuts each to FAM_LAYERS layers (of 42, 32 and 32) since phase 14
# came: the script's time (gemma2's stay local / global pairs)
FAM_LAYERS = 8
FAM_GEOM = {"gemma2-9b": (16, 8, 256), "llama3-8b": (32, 8, 128),
            "granite-moe-3b-a800m": (24, 8, 64)}
FAM_REQS, FAM_NEW, FAM_PROMPTS, FAM_ROWS = 4, 8, (4, 12), 4
G2_LONG, G2_WINDOW, G2_SOFTCAP, G2_CACHE = 4100, 4096, 50.0, 4112
G2_DECODE_LEN = G2_LONG + FAM_NEW // 2  # phase 2's solo decode length
FAM_CACHE = {"gemma2-9b": G2_CACHE, "llama3-8b": 256,
             "granite-moe-3b-a800m": 256}
# phase 9: deepseek-v3-671b with 2 layers (one dense, one MoE; the CPU
# reference with 16 of its 256 experts) and llama3-405b (128 q / 8 kv
# heads of 128: G = 16) with 2 layers (the CPU reference with 1), phase
# 8's requests; llama3-405b pages like llama3-8b
DS_ARCH, DS_CUT, DS_CPU_EXPERTS = ("deepseek-v3-671b",
                                   dict(n_layers=2, first_dense_layers=1), 16)
L405_ARCH, L405_LAYERS, L405_CPU_LAYERS = "llama3-405b", 2, 1
FAM_GEOM[L405_ARCH] = (128, 8, 128)
#: deepseek-v3-671b's rotary key width (its latent, kv_lora_rank, is 512)
MLA_ROPE = 64
FAM_CACHE[L405_ARCH] = 256

# phase 11: tinyllama-1.1b trains at full width and depth in float32 for
# 20 steps (the train launcher's seq 128 and batch 8, lr 1e-3, warmup
# 10) with remat "none", then 5 with remat "full"; the mean of steps
# 16-20's losses must lie TRAIN_MARGIN below step 1's: half the least
# drop of the CPU rehearsals at full width cut to 2 and 6 layers (4.96,
# 5.16 and 5.34; PERF.md §6, PR 21); card == CPU at 2 layers and batch 2;
# the checkpoint restart at the smoke config, saved after 3 steps
TRAIN_ARCH, TRAIN_STEPS, TRAIN_FULL_STEPS = "tinyllama-1.1b", 20, 5
TRAIN_SEQ, TRAIN_BATCH, TRAIN_LR, TRAIN_WARMUP = 128, 8, 1e-3, 10
TRAIN_TCFG = dict(learning_rate=TRAIN_LR, warmup_steps=TRAIN_WARMUP,
                  total_steps=TRAIN_STEPS)
TRAIN_MARGIN = 2.5
TRAIN_CPU_LAYERS, TRAIN_CPU_BATCH, TRAIN_CKPT_STEP = 2, 2, 3

# phase 12: granite-moe-3b-a800m at full width, depth cut to DIST_LAYERS,
# through build_model(cfg, mesh=..., rules=...), phase 8's 4 greedy requests served
# solo (prefill, then FAM_NEW - 1 decode steps): (a) one rank over NCCL,
# mesh (1, 1), the reference's serving rules (dryrun's serving profile) and
# default options; (b) two ranks sharing the card over gloo (NCCL refuses
# two ranks on one device), mesh (1, 2), the serving rules plus the
# reference's attnrep profile and its smattn options: 24 experts a rank,
# the KV cache sharded over the sequence, all_reduce the only collective.
# (b)'s decode == a fresh prefill is held at the capacity factor that drops
# no token (n_experts / top_k): at the default 1.25 a prefill of S + 1
# tokens may drop other tokens than the prefill of S and the one-token step
DIST_ARCH = "granite-moe-3b-a800m"
DIST_SERVING = {"embed": None}
DIST_ATTNREP = {"embed": None, "heads": None, "kv_heads": None}
DIST_SMATTN = {"decode_attn": "shardmap", "cache_update": "shard"}
DIST_CPU_LAYERS, DIST_TIMEOUT = 2, 900
# phases 12 and 13 (a) cut granite's depth from 32 layers to DIST_LAYERS:
# phase 14 carries a mesh path at full depth, and the script's time
DIST_LAYERS = 8

# phase 13: the dry run (launch/dryrun.py on meta tensors over a fake
# process group) held against the card.  (a) phase 12 (b)'s granite on two
# gloo ranks: a prefill of phase 8's longest prompt and one decode step,
# each counted by common.profiling on the card and laid out on meta over a
# fake group of 2; (b) phase 11's tinyllama step (one NCCL rank, mesh
# (1, 1)); the predicted peaks within DRY_MEM_TOL of the card's.  (c) three
# production cells through the dry-run CLI, each within DRY_CELL_TIMEOUT s
DRY_MEM_TOL = 0.10
DRY_CELLS = (("tinyllama-1.1b", "train_4k", False),
             ("granite-moe-3b-a800m", "decode_32k", False),
             ("llama3-405b", "prefill_32k", True),
             ("zamba2-7b", "long_500k", False))
DRY_CELL_TIMEOUT = 300

# phase 14: the recurrent families on a mesh.  zamba2-7b (81 Mamba2
# blocks, 13 shared-attention calls) and xlstm-1.3b (6 groups of 7 mLSTM
# + 1 sLSTM) at full width and depth, random float32 weights from a seed,
# on two gloo ranks sharing the card, mesh (1, 2), the reference's
# serving rules: zamba2's SSD on 56 of 112 heads a rank and its attention
# on 16 of 32, xlstm's mLSTM and sLSTM on 2 of 4 heads (sLSTM hd 512).
# Prompts of 126 and 200 tokens (one chunk of 126; two of 128, the
# inter-chunk carry on each rank's heads), MESH_STEPS decode steps each,
# against the unsharded bundle of the same weights in the main process;
# then each arch cut to MESH_CUT layers (the fewest that hold every block
# kind: one superblock and a tail block; one group) against the mesh path
# on the CPU (a world of one, gloo)
MESH_ARCHS = ("zamba2-7b", "xlstm-1.3b")
MESH_PROMPTS, MESH_STEPS = (126, 200), 4
MESH_RULES = {"zamba2-7b": {"embed": None}, "xlstm-1.3b": {"embed": None}}
MESH_CUT = {"zamba2-7b": 7, "xlstm-1.3b": 8}
CARD_BYTES = 80e9

# phase 15: paged decode under a mesh.  internvl2-1b at full width and
# depth and gemma2-9b at full width cut to PM_LAYERS (one local/global
# pair), random float32 weights from a seed, on two gloo ranks sharing
# the card, mesh (1, 2), the reference's serving rules: the page pool laid
# out as the reference lays it out (pages over "cache_batch", each page's
# slots over "cache_seq": 8 of 16 a rank), the paged kernel's tile mode
# once a layer a tick on each rank's tile.  Four requests (phase 8's
# prompts; for gemma2 the first three and the 4,100-token one, whose
# window starts mid-page), each prefilled alone into a one-row dense cache
# and copied into the pool (insert_pages), then FAM_NEW - 1 batched ticks
# of all four rows; against the unsharded bundle's paged step of the same
# weights in the main process; internvl2-1b cut to PM_CPU_LAYERS against
# the mesh path on the CPU.  The ranks' tiles are the kernel checker's
# cases of TILE_ROWS (phase 2 times them and fails where phase 15's pool
# is not theirs; phase 10 launches them)
PM_ARCHS = ("internvl2-1b", "gemma2-9b")
PM_LAYERS = {"gemma2-9b": 2}
PM_RULES = {"embed": None}
PM_CPU_LAYERS = 2


def prompt_lens(bounds, n) -> list[int]:
    """Phase 7's n prompt lengths, drawn in [lo, hi] from the seed; phase
    2 times its kernels-line rows at the longest."""
    import numpy as np

    rng = np.random.default_rng(SEED)
    return [int(x) for x in rng.integers(bounds[0], bounds[1] + 1, n)]


def dense_T(prompt: int, new: int) -> int:
    """The dense cache length ``S2M3Engine.generate()`` gives a prompt."""
    return -(-(prompt + new + 1) // 8) * 8


def serve_shapes() -> tuple[int, int]:
    """Phase 3's longest prefill (the image's tokens and a prompt: ragged,
    not a block multiple) and longest solo cache, at which phase 2 times
    the internvl2-1b rows."""
    from repro_torch.common.config import get_config
    from repro_torch.s2m3 import Request

    gen = [r for r in _workload(get_config("internvl2-1b"), Request)
           if r.prompt is not None]
    return (max(N_IMG + len(r.prompt) for r in gen),
            max(dense_T(N_IMG + len(r.prompt), r.max_new_tokens)
                for r in gen))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def f32_shapes() -> dict:
    """``ops.SHAPE_LAUNCHES`` of a float32 path, each key without its
    last element, the launch's dtype: the shapes the float32 phases
    count their exact launches by.  Fails where a launch ran at another
    dtype (phase 16's bfloat16 paths read ``ops.SHAPE_LAUNCHES`` whole)."""
    from repro_torch.kernels import ops

    out = {}
    for name, counts in ops.SHAPE_LAUNCHES.items():
        out[name] = {}
        for key, n in counts.items():
            if key[-1] != "float32":
                fail(f"{name}: {n} launches at {key} on a float32 path")
            out[name][key[:-1]] = n
    return out


# --------------------------------------------------------------------------
# phase 1: build
# --------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# libraries whose kernels must not spill registers (the redesigned
# attention and SSD kernels; a spill there is a failure)
NO_SPILL = ("flash_attention", "decode_attention", "ssd_scan")


def ptxas_entries(report: str) -> list[dict]:
    """Per entry function of an ``nvcc -Xptxas -v`` report: its mangled
    name, registers, static shared memory and spilled bytes."""
    import re

    entries, cur, props = [], None, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = {"name": m.group(1), "registers": None, "smem": 0,
                   "spill": 0}
            entries.append(cur)
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props == cur["name"]:
            cur["spill"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem"] = int(m.group(1))
    return entries


def _short_names(names: list[str]) -> list[str]:
    """``flash_fwd<float, 112, 32, 32>`` for a mangled kernel name (via
    the toolkit's ``cu++filt``; the mangled names where it is missing)."""
    from repro_torch.kernels.build import nvcc_path

    tool = Path(nvcc_path()).parent / "cu++filt"
    try:
        out = subprocess.run([str(tool), *names], capture_output=True,
                             text=True, check=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return names
    lines = out.stdout.splitlines()
    if len(lines) != len(names):
        return names
    short = []
    for ln in lines:
        ln = (ln.replace("(anonymous namespace)::", "")
              .replace("<unnamed>::", "").replace("(int)", "")
              .removeprefix("void "))
        short.append(ln.split(">(")[0] + ">" if ">(" in ln
                     else ln.split("(")[0])
    return short


def phase_build():
    import ctypes

    import torch

    from repro_torch.kernels import build, ops

    t0 = time.perf_counter()
    reports = build.build_all()
    log(f"[build] {len(reports)} libraries in "
        f"{time.perf_counter() - t0:.1f} s (nvcc {build.NVCC_FLAGS[1]})")
    spilled = []
    for name, rep in reports.items():
        entries = ptxas_entries(rep)
        for e, short in zip(entries, _short_names([e["name"] for e in entries])):
            log(f"[build] {name}: {short}: {e['registers']} registers, "
                f"{e['smem']} B static shared memory, {e['spill']} B "
                "spilled")
            if e["spill"] and name in NO_SPILL:
                spilled.append(short)
    plan = (ctypes.c_int * 4)()
    lib = build.load("flash_attention")
    for D in ops.HEAD_DIMS:
        for dt, code in ops._DTYPES.items():
            if lib.flash_attention_plan(D, code, plan) != 0:
                fail(f"flash_attention has no {dt} plan for D={D}")
            log(f"[build] flash_attention {str(dt).split('.')[1]} plan "
                f"D={D}: BQ {plan[0]}, BK {plan[1]}, {plan[2]} threads, "
                f"{plan[3]} B dynamic shared memory")
    # the bfloat16 instance is flash_fwd_mma<D, BQ, BK, KW>, one a head dim
    mma = [e for e in ptxas_entries(reports["flash_attention"])
           if "flash_fwd_mma" in e["name"]]
    if len(mma) != len(ops.HEAD_DIMS):
        fail(f"ptxas reported {len(mma)} flash_fwd_mma instances, not "
             f"{len(ops.HEAD_DIMS)}")
    if spilled:
        fail(f"register spills in {spilled}")
    # the SSD kernel's plan at zamba2-7b's prefills (and smoke): the
    # planner's shared memory and threads against the kernel's own, and
    # the blocks an SM holds (two at least at the path shapes)
    info = (ctypes.c_int * 3)()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for name, (B_, nc, L, H_, P, N) in (*SSD_ROWS.items(),
                                         ("smoke", SSD_SMOKE)):
        p = ops.ssd_plan(L, P, N, H_, B_ * nc, n_sm)
        if build.load("ssd_scan").ssd_intra_chunk_info(L, P, N, p.tr, p.ns,
                                                      info) != 0:
            fail(f"ssd_scan has no plan for L={L} P={P} N={N}")
        log(f"[build] ssd_scan plan {name} (B, nc, L, H, P, N) = "
            f"{(B_, nc, L, H_, P, N)}: {p.n_y} y tiles of {p.tr} rows + "
            f"{p.n_s} S_loc tiles of {p.ns} state rows a (chunk, head), "
            f"{p.n_heavy} y tiles before them, "
            f"{p.blocks} blocks of {info[1]} threads, {info[0]} B dynamic "
            f"shared memory; blocks an SM: {info[2]} "
            f"(cudaOccupancyMaxActiveBlocksPerMultiprocessor; planner "
            f"{p.blocks_per_sm})")
        if info[0] != p.smem or info[1] != p.threads:
            fail(f"ssd_scan plan disagrees with the kernel: {list(info)[:2]}"
                 f" vs {p.smem}, {p.threads}")
        if name != "smoke" and info[2] < 2:
            fail(f"ssd_scan: {info[2]} block(s) an SM at {name}, not two")
    # the sLSTM prefill kernel's plan at xlstm-1.3b, and whether the card
    # holds a cluster per head at once
    hd = SL_D // SL_H
    info = (ctypes.c_int * 3)()
    for B_ in (1, ops.SLSTM_MAX_ROWS):
        p = ops.slstm_plan(B_, SL_H, hd)
        if build.load("slstm_scan").slstm_prefill_info(
                hd, p.cluster, p.reg_slots, p.rows, info) != 0:
            fail(f"slstm_scan has no prefill plan for hd={hd}, B={B_}")
        log(f"[build] slstm_scan prefill plan hd={hd} B={B_}: clusters of "
            f"{p.cluster} blocks x {info[1]} threads, {p.units} units a "
            f"block, R rows {p.smem_slots * 32} in shared memory and "
            f"{p.reg_rows} in registers, {info[0]} B dynamic shared memory; "
            f"cudaOccupancyMaxActiveClusters {info[2]} (needs {SL_H})")
        if info[0] != p.smem or info[1] != p.threads:
            fail(f"slstm_scan plan disagrees with the kernel: "
                 f"{list(info)[:2]} vs {p.smem}, {p.threads}")
        if info[2] < SL_H:
            fail(f"the card holds {info[2]} clusters of {p.cluster}, "
                 f"fewer than the {SL_H} heads")


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def time_ms(fn, iters=200, warmup=20) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_us(fn, iters=200) -> float:
    """The host's enqueue time of one call (no synchronise inside the
    loop; the queue does not fill at these counts)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / iters * 1e6


def device_ms(fn, kernel: str, iters=50):
    """Device time of one call from ``torch.profiler``: with a kernel
    name, the mean duration of the device events whose name holds it
    (a wrapper launches its kernel once a call); with "" the summed time
    of every kernel and copy over ``iters`` calls, per call.  None when
    the profiler saw no such event."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    # the device's events only: tracing every host op as well costs the
    # script seconds a row and changes no device duration
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and kernel in e.name]
    if not ev:
        return None
    if kernel and len(ev) != iters:
        log(f"[kernels] the profiler saw {len(ev)} '{kernel}' events in "
            f"{iters} calls")
    total = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    return total / len(ev) if kernel else total / iters


def bound(nbytes: float, flops: float, dtype: str):
    """The least ms the card could take (``common.hw``: the published
    H100 SXM dense peaks; bf16 at the tensor-core rate, float32 at the
    FMA rate), and whether bytes or operations set it."""
    from repro_torch.common import hw

    t, by = hw.bound_s(nbytes, flops, dtype)
    return t * 1e3, by


def hbm_bytes_s() -> float:
    from repro_torch.common.hw import H100_SXM

    return H100_SXM.hbm_bandwidth


def _err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def _within(got, want, dtype: str) -> tuple[float, float]:
    """(max |got - want|, max of |got - want| / (atol + rtol |want|));
    the second is <= 1 where the two agree within ``TOL[dtype]``."""
    import torch

    atol, rtol = TOL[dtype]
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf"), float("inf")
    diff = (g - w).abs()
    return diff.max().item(), (diff / (atol + rtol * w.abs())).max().item()


def _flips(what, got, q, k, v, **kw) -> dict:
    """The flips of a bf16 flash output ``got`` of (q, k, v, **kw) and of
    the plain version, against exact attention rounded to bf16; fails
    above ``FLIPS_MULTIPLE`` times the plain version's.  Returns both."""
    import torch

    from repro_torch.kernels import ref

    exact = ref.flash_attention_ref(q, k, v, dtype=torch.float64, **kw)
    mine = ref.flips(got, exact)
    plain = ref.flips(ref.flash_attention_ref(q, k, v, **kw), exact)
    ok = mine <= FLIPS_MULTIPLE * plain
    log(f"[kernels] flash_attention bfloat16 {what}: flips {mine:.5%} of "
        f"the outputs, the plain version {plain:.5%} (at most "
        f"{FLIPS_MULTIPLE:g}x) {'ok' if ok else 'TOO MANY'}")
    if not ok:
        fail(f"flash_attention bfloat16 {what}: {mine:.5%} of the outputs "
             f"differ from exact attention, above {FLIPS_MULTIPLE:g}x the "
             f"plain version's {plain:.5%}")
    return {"flips": mine, "plain_flips": plain}


def _check(name, dtype, what, got, want) -> float:
    import torch

    torch.cuda.synchronize()
    err, ratio = _within(got, want, dtype)
    atol, rtol = TOL[dtype]
    ok = ratio <= 1.0
    log(f"[kernels] {name} {dtype} {what}: max_abs_err {err:.3e}, "
        f"{ratio:.2f} of the tolerance (atol {atol:g}, rtol {rtol:g}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{name} {dtype} {what} disagrees with its plain version")
    return err


def _row(name, src, repl, kernel, err, fn, plain, lib, nbytes, flops,
         dname="float32", iters=200) -> dict:
    """One entry of the kernels line: the kernel, its plain version and
    (where there is one) the one-call library equivalent, timed on the
    same inputs, the kernel and the library in turns (kernel, library,
    kernel, library; the faster of each pair is kept); ``device_ms`` is
    the kernel's own device time (events named ``kernel``) under the
    profiler and ``host_us`` the wrapper's enqueue time; ``launches`` is
    filled in from the main-path run."""
    b_ms, b_by = bound(nbytes, flops, dname)
    k_ms, l_ms = [], []
    for _ in range(2):
        k_ms.append(time_ms(fn, iters))
        if lib is not None:
            l_ms.append(time_ms(lib, iters))
    n_prof = min(iters, 50)
    row = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/{src}", "replaces": repl,
           "launches": None, "max_abs_err": err,
           "ms": min(k_ms), "plain_ms": time_ms(plain, iters),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": min(l_ms) if lib is not None else None,
           "device_ms": device_ms(fn, kernel, n_prof),
           "host_us": host_us(fn, iters)}
    lib_dev = device_ms(lib, "", n_prof) if lib is not None else None
    log(f"[kernels] {name} {dname} timing: kernel {row['ms']:.4f} ms "
        f"(turns {', '.join(f'{t:.4f}' for t in k_ms)}; device "
        f"{row['device_ms']} ms, host enqueue {row['host_us']:.1f} us), "
        f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']} ms "
        f"(turns {', '.join(f'{t:.4f}' for t in l_ms) or '-'}; device "
        f"{lib_dev} ms), bound {b_ms:.5f} ms ({b_by}; {nbytes} B, "
        f"{flops:.3e} FLOP)")
    return row


# flex_attention's mask_mods at gemma2-9b's rows: each row has its own
# function, with no closure or default argument, because torch 2.11's
# compiled flex_attention reuses the mask compiled for one function object
# when called with another of the same code (seen on the H100: a causal
# call then ran with the windowed mask)
def _g2_prefill_local(b, h, qi, ki):
    return (qi >= ki) & (qi - ki < G2_WINDOW)


def _g2_prefill_global(b, h, qi, ki):
    return qi >= ki


def _g2_decode_local(b, h, qi, ki):
    return (ki < G2_DECODE_LEN) & (ki >= G2_DECODE_LEN - G2_WINDOW)


def _g2_decode_global(b, h, qi, ki):
    return ki < G2_DECODE_LEN


def _g2_softcap(s, b, h, qi, ki):
    return G2_SOFTCAP * (s / G2_SOFTCAP).tanh()


def _flex_lib(name, q, k, v, want, mask_mod, Q_LEN, KV_LEN, dname):
    """The one-call library equivalent where SDPA has no softcap:
    ``flex_attention`` over q (1, H, Q_LEN, D) and k, v (1, K, KV_LEN, D)
    with gemma2-9b's tanh softcap as score_mod, ``mask_mod`` as a block
    mask and GQA, compiled once here, outside any timing.  Its output
    (1, H, Q_LEN, D) is held to ``want`` (the plain version's) before it
    is timed: at ``TOL["float32"]``, or in bfloat16 within
    ``LIB_BF16_MULTIPLE`` times ``TOL["bfloat16"]``; returns the call."""
    import torch
    from torch.nn.attention.flex_attention import (create_block_mask,
                                                   flex_attention)

    block_mask = create_block_mask(mask_mod, 1, None, Q_LEN, KV_LEN,
                                   device=q.device)
    flex = torch.compile(flex_attention, dynamic=False)

    def call():
        return flex(q, k, v, score_mod=_g2_softcap, block_mask=block_mask,
                    enable_gqa=True)

    got = call().transpose(1, 2).reshape(want.shape)
    if dname == "float32":
        _check(name, dname, "library (flex_attention) vs plain", got, want)
        return call
    torch.cuda.synchronize()
    err, ratio = _within(got, want, dname)
    log(f"[kernels] {name} {dname} library (flex_attention) vs plain: "
        f"max_abs_err {err:.3e}, {ratio:.2f} of the tolerance (at most "
        f"{LIB_BF16_MULTIPLE:g}: it keeps P in bf16)")
    if not ratio <= LIB_BF16_MULTIPLE:
        fail(f"{name}: flex_attention in {dname} is not the same function")
    return call


def _flash_edges(mk, dname, H_, K_, D_, T_full):
    """Shapes at the flash kernel's edges for one head geometry: S = 1
    and S under one q-tile (causal and not), a window inside a short S,
    one query against a longer non-causal T, and B = 2 with a ragged S
    and a softcap."""
    from repro_torch.kernels import ops, ref

    for B_, S_, T_, kw in ((1, 1, 1, {}), (1, 5, 5, {}),
                           (1, 5, 5, dict(causal=False)),
                           (1, 20, 20, dict(window=7)),
                           (1, 1, T_full, dict(causal=False)),
                           (2, 37, 37, dict(softcap=30.0))):
        q = mk(B_, S_, H_, D_)
        k, v = mk(B_, T_, K_, D_), mk(B_, T_, K_, D_)
        _check("flash_attention", dname,
               f"D={D_} B={B_} S={S_} T={T_} {kw}",
               ops.flash_attention(q, k, v, **kw),
               ref.flash_attention_ref(q, k, v, **kw))


def _decode_edges(mk, dname, dev, H_, K_, D_, T_):
    """One batch whose lengths reach the split-KV kernel's edges: 0, 1,
    the first split boundary of a full row - 1 and + 1, and T; without
    and with a softcap."""
    import torch

    from repro_torch.kernels import ops, ref

    B_ = 5
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n = ops.decode_splits(T_, B_, K_, H_ // K_, n_sm)
    c = ops.split_range(T_, n, 1)[0]
    lens = torch.tensor([0, 1, c - 1, c + 1, T_], dtype=torch.int32,
                        device=dev)
    q = mk(B_, H_, D_)
    k, v = mk(B_, T_, K_, D_), mk(B_, T_, K_, D_)
    for sc in (0.0, 30.0):
        _check("decode_attention", dname,
               f"D={D_} G={H_ // K_} n_split={n} lengths {lens.tolist()} "
               f"softcap={sc}",
               ops.decode_attention(q, k, v, lens, softcap=sc),
               ref.decode_attention_ref(q, k, v, lens, softcap=sc))


def _paged_edges(mk, dname, dev, H_, K_, D_):
    """The split-KV paged kernel over the serve tick's 129-page pool with
    garbage (many out-of-range) table entries past each row's pages: one
    batch of lengths 0, 1, ps - 1, ps, ps + 1, the first split boundary
    of a full span - 1 and + 1, and the full span; without and with a
    softcap."""
    import torch

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    span = N_MAX * PAGE
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    n = ops.decode_splits(span, 8, K_, H_ // K_, n_sm)
    c = ops.split_range(span, n, 1)[0]
    lens = torch.tensor([0, 1, PAGE - 1, PAGE, PAGE + 1, c - 1, c + 1, span],
                        dtype=torch.int32, device=dev)
    B_ = len(lens)
    pages = torch.randint(0, N_PAGES, (B_, N_MAX), generator=g, device=dev,
                          dtype=torch.int32)
    junk = torch.randint(-50, N_PAGES + 50, (B_, N_MAX), generator=g,
                         device=dev, dtype=torch.int32)
    owned = torch.arange(N_MAX, device=dev)[None] * PAGE < lens[:, None]
    tables = torch.where(owned, pages, junk).contiguous()
    q = mk(B_, H_, D_)
    kp, vp = mk(N_PAGES, PAGE, K_, D_), mk(N_PAGES, PAGE, K_, D_)
    for sc in (0.0, 30.0):
        _check("paged_decode_attention", dname,
               f"D={D_} G={H_ // K_} n_split={n} lengths {lens.tolist()} "
               f"softcap={sc}",
               ops.paged_decode_attention(q, kp, vp, tables, lens,
                                          softcap=sc),
               ref.paged_decode_attention_ref(q, kp, vp, tables, lens,
                                              softcap=sc))


# the work a call must do, for its bound: each input read once, each
# output written once, and the FLOPs of the pairs this call's data makes
# live (QK^T and PV: 4 D a query-key pair and head)

def _flash_work(B, S, T, H, K, D, causal, isz, window=0) -> tuple[int, float]:
    """A flash call's bytes (q, k, v, o) and FLOPs over the visible
    pairs: all S x T, or the causal triangle where S = T, less the keys a
    window hides (query i sees min(i + 1, window) keys)."""
    pairs = S * (S + 1) / 2 if causal else S * T
    if causal and 0 < window < S:
        pairs = window * (window + 1) / 2 + (S - window) * window
    return (2 * B * S * H * D + 2 * B * T * K * D) * isz, 4 * D * H * B * pairs


def _live_keys(lens, T, window=0):
    """Per row, the first live key and the live keys' count: [max(0, n -
    window), min(n, T)) under a window, [0, min(n, T)) without one."""
    end = lens.long().clamp(0, T)
    start = (lens.long() - window).clamp_min(0) if window else end * 0
    return start, (end - start).clamp_min(0)


def _decode_work(q, k, lens, isz, window=0) -> tuple[int, float]:
    """A decode call's bytes (q, o, the live keys' k and v, the lengths)
    and FLOPs over the live keys (lengths clamped to the cache's T; a
    window's span only)."""
    T, K, D = k.shape[1:]
    n_keys = int(_live_keys(lens, T, window)[1].sum())
    return (2 * q.numel() * isz + 2 * n_keys * K * D * isz
            + 4 * lens.numel()), 4 * D * q.shape[1] * n_keys


def _paged_work(q, k_pages, lens, owned, isz, window=0) -> tuple[int, float]:
    """A paged decode call's bytes (q, o, the live keys' k and v, the
    table entries of the pages they lie in, the lengths) and FLOPs over
    the live keys (a window's span only).  ``owned`` marks the table
    entries a row owns; under a window only those of its span are read."""
    import torch

    K, D = k_pages.shape[2:]
    ps = k_pages.shape[1]
    start, n = _live_keys(lens, owned.shape[1] * ps, window)
    live = int(n.sum())
    cols = torch.arange(owned.shape[1], device=owned.device)[None]
    read = owned & (cols >= (start // ps)[:, None]) & (n[:, None] > 0)
    nbytes = (2 * q.numel() * isz + 2 * live * K * D * isz
              + 4 * int(read.sum()) + 4 * lens.numel())
    return nbytes, 4 * D * q.shape[1] * live


def phase_kernels(dev) -> tuple[list[dict], dict]:
    """The attention kernels at internvl2-1b's head geometry (phase 3's
    serve path), with their edges; one kernels-line row each, timed at
    the path's longest prefill and solo cache.  Returns the rows and, for
    each row, (path, kernel, call shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = []
    S_pre, T_dec = serve_shapes()
    keys = {"flash_attention": ("serve", "flash_attention",
                                (1, S_pre, S_pre, H, K, D, True, 0)),
            "decode_attention": ("serve", "decode_attention",
                                 (1, T_dec, H, K, D, 0)),
            "paged_decode_attention": ("serve", "paged_decode_attention",
                                       (ROWS, N_MAX, PAGE, H, K, D, 0))}

    def rnd(*shape, dtype):
        return torch.randn(shape, generator=g, device=dev).to(dtype)

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        isz = torch.tensor([], dtype=dt).element_size()

        # -- flash attention: batch-1 prefill, ragged S, causal, GQA 7 --
        S = S_pre
        q, k, v = rnd(1, S, H, D, dtype=dt), rnd(1, S, K, D, dtype=dt), \
            rnd(1, S, K, D, dtype=dt)
        err_f = _check("flash_attention", dname, f"S={S} causal",
                       ops.flash_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v))
        for kw in (dict(softcap=30.0), dict(window=100),
                   dict(causal=False)):
            _check("flash_attention", dname, f"S={S} {kw}",
                   ops.flash_attention(q, k, v, **kw),
                   ref.flash_attention_ref(q, k, v, **kw))
        q2 = rnd(2, 61, H, D, dtype=dt)
        k2, v2 = rnd(2, 61, K, D, dtype=dt), rnd(2, 61, K, D, dtype=dt)
        _check("flash_attention", dname, "B=2 S=61",
               ops.flash_attention(q2, k2, v2),
               ref.flash_attention_ref(q2, k2, v2))
        _flash_edges(lambda *sh: rnd(*sh, dtype=dt), dname, H, K, D, S)
        flash_work = _flash_work(1, S, S, H, K, D, True, isz)

        # -- decode attention: batch-1 dense cache, random lengths ------
        T = T_dec
        qd = rnd(1, H, D, dtype=dt)
        kd, vd = rnd(1, T, K, D, dtype=dt), rnd(1, T, K, D, dtype=dt)
        lens_d = torch.randint(1, T + 1, (1,), generator=g, device=dev,
                               dtype=torch.int32)
        err_d = _check("decode_attention", dname, f"T={T} len={lens_d.item()}",
                       ops.decode_attention(qd, kd, vd, lens_d),
                       ref.decode_attention_ref(qd, kd, vd, lens_d))
        qb = rnd(ROWS, H, D, dtype=dt)
        kb, vb = rnd(ROWS, T, K, D, dtype=dt), rnd(ROWS, T, K, D, dtype=dt)
        lens_b = torch.tensor([T, 1, 137, 0], dtype=torch.int32, device=dev)
        _check("decode_attention", dname, "B=4 lengths [T,1,137,0] softcap=30",
               ops.decode_attention(qb, kb, vb, lens_b, softcap=30.0),
               ref.decode_attention_ref(qb, kb, vb, lens_b, softcap=30.0))
        _decode_edges(lambda *sh: rnd(*sh, dtype=dt), dname, dev, H, K, D, T)
        dec_work = _decode_work(qd, kd, lens_d, isz)

        # -- paged decode: 4 rows over a 129-page pool ------------------
        kp = rnd(N_PAGES, PAGE, K, D, dtype=dt)
        vp = rnd(N_PAGES, PAGE, K, D, dtype=dt)
        lens_p = torch.randint(1, 300, (ROWS,), generator=g, device=dev,
                               dtype=torch.int32)
        perm = torch.randperm(N_PAGES - 1, generator=g, device=dev) + 1
        tables = perm[:ROWS * N_MAX].reshape(ROWS, N_MAX).to(torch.int32)
        # entries past each row's pages are garbage, some out of range
        junk = torch.randint(-50, N_PAGES + 50, (ROWS, N_MAX), generator=g,
                             device=dev, dtype=torch.int32)
        owned = torch.arange(N_MAX, device=dev)[None] * PAGE < lens_p[:, None]
        tables = torch.where(owned, tables, junk).contiguous()
        err_p = _check("paged_decode_attention", dname,
                       f"lengths {lens_p.tolist()} garbage tails",
                       ops.paged_decode_attention(qb, kp, vp, tables, lens_p),
                       ref.paged_decode_attention_ref(qb, kp, vp, tables,
                                                      lens_p))
        _check("paged_decode_attention", dname, "softcap=30",
               ops.paged_decode_attention(qb, kp, vp, tables, lens_p,
                                          softcap=30.0),
               ref.paged_decode_attention_ref(qb, kp, vp, tables, lens_p,
                                              softcap=30.0))
        for H_, K_ in ((H, K), (4, 4)):                  # G = 7 and G = 1
            for D_ in ops.HEAD_DIMS:
                _paged_edges(lambda *sh: rnd(*sh, dtype=dt), dname, dev, H_,
                             K_, D_)
        paged_work = _paged_work(qb, kp, lens_p, owned, isz)

        if dt is not torch.float32:
            continue
        # timing at the path's dtype (float32) and shapes
        qh, kh_, vh = (x.transpose(1, 2) for x in (q, k, v))
        mask_d = (torch.arange(T, device=dev)[None] < lens_d[:, None])[
            :, None, None, :]
        specs = [
            ("flash_attention", "csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention.py:93", "flash_fwd", err_f,
             lambda: ops.flash_attention(q, k, v),
             lambda: ref.flash_attention_ref(q, k, v),
             lambda: F.scaled_dot_product_attention(
                 qh, kh_, vh, is_causal=True, enable_gqa=True),
             *flash_work),
            ("decode_attention", "csrc/decode_attention.cu",
             "src/repro/kernels/decode_attention.py:70", "decode_fwd", err_d,
             lambda: ops.decode_attention(qd, kd, vd, lens_d),
             lambda: ref.decode_attention_ref(qd, kd, vd, lens_d),
             lambda: F.scaled_dot_product_attention(
                 qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
                 attn_mask=mask_d, enable_gqa=True),
             *dec_work),
            ("paged_decode_attention", "csrc/decode_attention.cu",
             "src/repro/kernels/paged_decode_attention.py:77",
             "paged_decode_fwd", err_p,
             lambda: ops.paged_decode_attention(qb, kp, vp, tables, lens_p),
             lambda: ref.paged_decode_attention_ref(qb, kp, vp, tables,
                                                    lens_p),
             None, *paged_work),
        ]
        rows += [_row(*spec) for spec in specs]
        # the paged kernel has no one-call library equivalent; as a
        # yardstick, SDPA over the rows' pages gathered beforehand
        kg = kp[tables.long().clamp(0, N_PAGES - 1)].reshape(
            ROWS, N_MAX * PAGE, K, D).transpose(1, 2)
        vg = vp[tables.long().clamp(0, N_PAGES - 1)].reshape(
            ROWS, N_MAX * PAGE, K, D).transpose(1, 2)
        mask_p = (torch.arange(N_MAX * PAGE, device=dev)[None]
                  < lens_p[:, None])[:, None, None, :]
        log("[kernels] paged_decode_attention float32: SDPA over the "
            "pre-gathered pages (gather not timed) "
            f"{time_ms(lambda: F.scaled_dot_product_attention(qb[:, :, None], kg, vg, attn_mask=mask_p, enable_gqa=True)):.4f} ms")
    return rows, keys


def _ssd_inputs(g, dt, shape=SSD_SHAPE):
    """SSD inputs of ``shape`` (B, nc, L, H, P, N) at a Mamba2 layer's
    scales: silu-sized x, B, C; dt = softplus(.); A_log spread over a few
    decades of decay."""
    import torch

    B, nc, L, Hs, P, N = shape
    dev = g.device

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    x = rnd(B, nc, L, Hs, P)
    Bm, Cm = 0.5 * rnd(B, nc, L, N), 0.5 * rnd(B, nc, L, N)
    dtt = torch.nn.functional.softplus(rnd(B, nc, L, Hs) - 1.0)
    return (*(t.to(dt) for t in (x, Bm, Cm, dtt)), 0.5 * rnd(Hs))


def _ssd_work(shape, args) -> tuple[int, float]:
    """The SSD call's bytes (inputs read once, float32 outputs written
    once) and FLOPs (C.B^T and M@x over the causal pairs, B^T@x over the
    whole chunk)."""
    B_, nc, L, Hs, P, N = shape
    nbytes = (sum(t.numel() * t.element_size() for t in args)
              + 4 * (B_ * nc * L * Hs * P + B_ * nc * Hs * N * P
                     + B_ * nc * Hs))
    causal_pairs = L * (L + 1) / 2
    return nbytes, B_ * nc * Hs * (2 * causal_pairs * (N + P) + 2 * L * N * P)


def phase_kernels_recurrent(dev) -> tuple[list[dict], dict]:
    """The recurrent paths' kernels against their plain versions: the
    attention kernels at zamba2-7b's D = 112, the SSD intra-chunk kernel
    and the sLSTM kernel, each also at the shapes one rank of phase 14
    gives it (the ``_h16``, ``_h56`` and ``_h2`` rows, whose launches
    are read off that phase's rank 0).  The SSD and sLSTM kernels have
    no one-call PyTorch equivalent (``library_ms`` null).  Returns the
    rows and, for each row, (path, kernel, call shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rows = []
    # phase 14's rank: 16 of the shared block's 32 heads at the longer
    # prompt, and the decode kernel over that request's whole cache
    S_m = max(MESH_PROMPTS)
    T_m = dense_T(S_m, MESH_STEPS + 1)
    keys = {"flash_attention_d112": (
                "zamba2-7b", "flash_attention",
                (1, S_REC, S_REC, Z_HEADS, Z_HEADS, Z_D, True, 0)),
            "decode_attention_d112": ("zamba2-7b", "decode_attention",
                                      (1, T_REC, Z_HEADS, Z_HEADS, Z_D, 0)),
            **{name: ("zamba2-7b", "ssd_intra_chunk", shape[:4])
               for name, shape in SSD_ROWS.items()},
            **{name: ("zamba2-7b-mesh", "ssd_intra_chunk", shape[:4])
               for name, shape in SSD_MESH_ROWS.items()},
            "flash_attention_d112_h16": (
                "zamba2-7b-mesh", "flash_attention",
                (1, S_m, S_m, Z_HEADS // 2, Z_HEADS // 2, Z_D, True, 0)),
            "decode_attention_d112_h16": (
                "zamba2-7b-mesh", "decode_attention",
                (1, T_m, Z_HEADS // 2, Z_HEADS // 2, Z_D, 0)),
            "slstm_scan_h2": ("xlstm-1.3b-mesh", "slstm_scan", SL_MESH),
            "slstm_scan_s1_h2": ("xlstm-1.3b-mesh", "slstm_scan_s1",
                                 (1, 1, *SL_MESH[2:])),
            "slstm_scan": ("xlstm-1.3b", "slstm_scan",
                           (1, S_REC, SL_H, SL_D // SL_H)),
            "slstm_scan_s1": ("xlstm-1.3b", "slstm_scan_s1",
                              (1, 1, SL_H, SL_D // SL_H))}

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        isz = torch.tensor([], dtype=dt).element_size()

        # -- attention at zamba2-7b's shared block: H = K = 32, D = 112 --
        q, k, v = (rnd(1, S_REC, Z_HEADS, Z_D).to(dt) for _ in range(3))
        err_f = _check("flash_attention", dname, f"D=112 S={S_REC} causal",
                       ops.flash_attention(q, k, v),
                       ref.flash_attention_ref(q, k, v))
        for kw in (dict(softcap=30.0), dict(window=100),
                   dict(causal=False)):
            _check("flash_attention", dname, f"D=112 S={S_REC} {kw}",
                   ops.flash_attention(q, k, v, **kw),
                   ref.flash_attention_ref(q, k, v, **kw))
        _flash_edges(lambda *sh: rnd(*sh).to(dt), dname, Z_HEADS, Z_HEADS,
                     Z_D, S_REC)
        qd = rnd(1, Z_HEADS, Z_D).to(dt)
        kd, vd = (rnd(1, T_REC, Z_HEADS, Z_D).to(dt) for _ in range(2))
        lens = torch.tensor([S_REC + REC_NEW], dtype=torch.int32, device=dev)
        err_d = _check("decode_attention", dname,
                       f"D=112 T={T_REC} len={lens.item()}",
                       ops.decode_attention(qd, kd, vd, lens),
                       ref.decode_attention_ref(qd, kd, vd, lens))
        qb = rnd(4, Z_HEADS, Z_D).to(dt)
        kb, vb = (rnd(4, T_REC, Z_HEADS, Z_D).to(dt) for _ in range(2))
        lens_b = torch.tensor([T_REC, 1, 237, 0], dtype=torch.int32,
                              device=dev)
        _check("decode_attention", dname,
               f"D=112 B=4 lengths {lens_b.tolist()} softcap=30",
               ops.decode_attention(qb, kb, vb, lens_b, softcap=30.0),
               ref.decode_attention_ref(qb, kb, vb, lens_b, softcap=30.0))
        _decode_edges(lambda *sh: rnd(*sh).to(dt), dname, dev, 4, 4, Z_D,
                      T_REC)
        qm, km, vm = (rnd(1, S_m, Z_HEADS // 2, Z_D).to(dt) for _ in range(3))
        err_fm = _check("flash_attention", dname,
                        f"D=112 H=16 S={S_m} causal (a rank's heads)",
                        ops.flash_attention(qm, km, vm),
                        ref.flash_attention_ref(qm, km, vm))
        qdm = rnd(1, Z_HEADS // 2, Z_D).to(dt)
        kdm, vdm = (rnd(1, T_m, Z_HEADS // 2, Z_D).to(dt) for _ in range(2))
        lens_m = torch.tensor([S_m + MESH_STEPS], dtype=torch.int32,
                              device=dev)
        err_dm = _check("decode_attention", dname,
                        f"D=112 H=16 T={T_m} len={lens_m.item()} (a rank's "
                        "heads)", ops.decode_attention(qdm, kdm, vdm, lens_m),
                        ref.decode_attention_ref(qdm, kdm, vdm, lens_m))

        # -- SSD intra-chunk at zamba2-7b's three prefill shapes, smoke ---
        ssd_args, ssd_err = {}, {}
        for name, shape in (*SSD_ROWS.items(), *SSD_MESH_ROWS.items(),
                            ("smoke", SSD_SMOKE)):
            args_ = _ssd_inputs(g, dt, shape)
            ssd_args[name] = args_
            ssd_err[name] = max(
                _check("ssd_intra_chunk", dname, f"{shape} {what}", got, want)
                for what, got, want in zip(
                    ("y_intra", "S_loc", "Lam"), ops.ssd_intra_chunk(*args_),
                    ref.ssd_intra_chunk_ref(*args_)))

        # -- sLSTM at xlstm-1.3b: fresh state, random state, decode -------
        errs, errs1, errs_m, errs1_m = [], [], [], []
        for B_, S_, H_, hd_ in SLSTM_CHECKS:
            d_ = H_ * hd_
            R_ = 0.02 * rnd(4, H_, hd_, hd_)
            gates_ = tuple(R_[i].clone() for i in range(4))
            pre_s = rnd(B_, S_, 4, d_).to(dt)
            state_s = (rnd(B_, d_), 1.0 + rnd(B_, d_).abs(),
                       rnd(B_, d_).tanh(), rnd(B_, d_))
            cases = [("fresh state", pre_s, None),
                     ("random state", pre_s, state_s)]
            if S_ > 1:
                cases.append(("S=1 (decode) random state",
                              pre_s[:, :1].contiguous(), state_s))
            for what, p, st in cases:
                what = f"B={B_} S={p.shape[1]} H={H_} hd={hd_} {what}"
                (y, fin), (y_r, fin_r) = (ops.slstm_scan(p, R_, state=st),
                                          ref.slstm_scan_ref(p, R_, st))
                err = _check("slstm_scan", dname, f"{what}: h", y, y_r)
                if (B_, S_, H_, hd_) == SL_MESH:     # phase 14's rows
                    (errs1_m if p.shape[1] == 1 else errs_m).append(err)
                elif hd_ == SL_D // SL_H:     # the rows' path shapes
                    (errs1 if p.shape[1] == 1 else errs).append(err)
                for part, a, b in zip("cnhm", fin, fin_r):  # float32 state
                    _check("slstm_scan", "float32", f"{what}: final {part}",
                           a, b)
                y4, fin4 = ops.slstm_scan(p, gates_, state=st)
                torch.cuda.synchronize()
                if not (torch.equal(y4, y) and all(
                        torch.equal(a, b) for a, b in zip(fin4, fin))):
                    fail(f"slstm_scan {dname} {what}: four gate tensors "
                         "differ from the stacked R")
            if (B_, S_, H_) == (1, S_REC, SL_H):
                pre, state, R, gates = pre_s, state_s, R_, gates_
            if (B_, S_, H_, hd_) == SL_MESH:
                pre_m, state_m, R_m, gates_m = pre_s, state_s, R_, gates_
        log(f"[kernels] slstm_scan {dname}: R as four gate tensors gives "
            "the stacked R's bits in every case")
        pre1 = pre[:, :1].contiguous()
        pre1_m = pre_m[:, :1].contiguous()
        if dt is not torch.float32:
            continue

        # timing at the path's dtype (float32) and shapes
        mask = (torch.arange(T_REC, device=dev)[None] < lens[:, None])[
            :, None, None, :]
        qh, kh_, vh = (x.transpose(1, 2) for x in (q, k, v))
        mask_m = (torch.arange(T_m, device=dev)[None] < lens_m[:, None])[
            :, None, None, :]
        qmh, kmh, vmh = (x.transpose(1, 2) for x in (qm, km, vm))
        hd = SL_D // SL_H
        sl_bytes = (pre.numel() + R.numel() + S_REC * SL_D + 8 * SL_D) * 4
        sl_flops = 2 * 4 * SL_D * hd * S_REC
        # the decode step: R read once, pre, the state in and out, y
        sl1_bytes = (R.numel() + pre1.numel() + 9 * SL_D) * 4
        sl1_flops = 2 * 4 * SL_D * hd
        # phase 14's rank: 2 of the 4 heads
        _, S_m, H_m, hd_m = SL_MESH
        d_m = H_m * hd_m
        slm_bytes = (pre_m.numel() + R_m.numel() + S_m * d_m + 8 * d_m) * 4
        slm_flops = 2 * 4 * d_m * hd_m * S_m
        slm1_bytes = (R_m.numel() + pre1_m.numel() + 9 * d_m) * 4
        slm1_flops = 2 * 4 * d_m * hd_m
        rows += [
            _row("flash_attention_d112", "csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:93", "flash_fwd",
                 err_f,
                 lambda: ops.flash_attention(q, k, v),
                 lambda: ref.flash_attention_ref(q, k, v),
                 lambda: F.scaled_dot_product_attention(qh, kh_, vh,
                                                        is_causal=True),
                 *_flash_work(1, S_REC, S_REC, Z_HEADS, Z_HEADS, Z_D, True,
                              isz)),
            _row("decode_attention_d112", "csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention.py:70", "decode_fwd",
                 err_d,
                 lambda: ops.decode_attention(qd, kd, vd, lens),
                 lambda: ref.decode_attention_ref(qd, kd, vd, lens),
                 lambda: F.scaled_dot_product_attention(
                     qd[:, :, None], kd.transpose(1, 2), vd.transpose(1, 2),
                     attn_mask=mask),
                 *_decode_work(qd, kd, lens, isz)),
            _row("flash_attention_d112_h16", "csrc/flash_attention.cu",
                 "src/repro/kernels/flash_attention.py:93", "flash_fwd",
                 err_fm,
                 lambda: ops.flash_attention(qm, km, vm),
                 lambda: ref.flash_attention_ref(qm, km, vm),
                 lambda: F.scaled_dot_product_attention(qmh, kmh, vmh,
                                                        is_causal=True),
                 *_flash_work(1, S_m, S_m, Z_HEADS // 2, Z_HEADS // 2, Z_D,
                              True, isz)),
            _row("decode_attention_d112_h16", "csrc/decode_attention.cu",
                 "src/repro/kernels/decode_attention.py:70", "decode_fwd",
                 err_dm,
                 lambda: ops.decode_attention(qdm, kdm, vdm, lens_m),
                 lambda: ref.decode_attention_ref(qdm, kdm, vdm, lens_m),
                 lambda: F.scaled_dot_product_attention(
                     qdm[:, :, None], kdm.transpose(1, 2),
                     vdm.transpose(1, 2), attn_mask=mask_m),
                 *_decode_work(qdm, kdm, lens_m, isz)),
            *(_row(name, "csrc/ssd_scan.cu",
                   "src/repro/kernels/ssd_scan.py:51", "ssd_tile_kernel",
                   ssd_err[name],
                   lambda a=ssd_args[name]: ops.ssd_intra_chunk(*a),
                   lambda a=ssd_args[name]: ref.ssd_intra_chunk_ref(*a), None,
                   *_ssd_work({**SSD_ROWS, **SSD_MESH_ROWS}[name],
                              ssd_args[name]))
              for name in (*SSD_ROWS, *SSD_MESH_ROWS)),
            _row("slstm_scan", "csrc/slstm_scan.cu",
                 "src/repro/kernels/slstm_scan.py:91", "slstm_prefill_kernel",
                 max(errs),
                 lambda: ops.slstm_scan(pre, R),
                 lambda: ref.slstm_scan_ref(pre, R), None,
                 sl_bytes, sl_flops, iters=20),
            # the decode step's call (S = 1, from a state), as the layer
            # makes it: R as four gate tensors
            _row("slstm_scan_s1", "csrc/slstm_scan.cu",
                 "src/repro/kernels/slstm_scan.py:91", "slstm_step_kernel",
                 max(errs1),
                 lambda: ops.slstm_scan(pre1, gates, state=state),
                 lambda: ref.slstm_scan_ref(pre1, R, state), None,
                 sl1_bytes, sl1_flops),
            _row("slstm_scan_h2", "csrc/slstm_scan.cu",
                 "src/repro/kernels/slstm_scan.py:91", "slstm_prefill_kernel",
                 max(errs_m),
                 lambda: ops.slstm_scan(pre_m, gates_m),
                 lambda: ref.slstm_scan_ref(pre_m, R_m), None,
                 slm_bytes, slm_flops, iters=20),
            _row("slstm_scan_s1_h2", "csrc/slstm_scan.cu",
                 "src/repro/kernels/slstm_scan.py:91", "slstm_step_kernel",
                 max(errs1_m),
                 lambda: ops.slstm_scan(pre1_m, gates_m, state=state_m),
                 lambda: ref.slstm_scan_ref(pre1_m, R_m, state_m), None,
                 slm1_bytes, slm1_flops),
        ]
    return rows, keys


def phase_kernels_slice(dev) -> tuple[list[dict], dict]:
    """The attention kernels at the shapes the multi-task scenario and
    the phase 7 models give them, in float32 and bfloat16 against their
    plain versions, one kernels-line row each (float32), timed at a
    shape its path runs (phase 7's longest prompt):

    * flash D = 16 at the mini-clip towers: the vision tower's 16
      patches non-causal and the text tower's 12 tokens causal, H = K =
      4, one request's 4 rows (and serve()'s batch of 32 rows, checked);
    * flash D = 64, G = 8 at tinyllama-1.1b's longest prompt (causal);
    * flash D = 64, G = 1 at whisper-tiny's encoder, S = T = 1500,
      non-causal, and its cross-attention prefill, the longest prompt's
      queries against the 1500 encoder keys;
    * flash D = 64, G = 8 at phase 11's training shape: tinyllama-1.1b's
      kernel-path loss over a batch of 8 rows of 128 tokens (causal);
    * decode D = 64, G = 1 over whisper-tiny's 1500 cross keys (lengths
      = T), and D = 64, G = 8 over tinyllama-1.1b's solo cache of the
      longest prompt (and whisper-tiny's self-attention cache, checked);
    * paged decode D = 64, G = 8 at tinyllama-1.1b's serve tick: 4 rows
      over a 65-page pool, garbage table tails.

    Returns the rows and, for each row, (path, kernel, call shape): the
    key under which its path's main-path run counts the row's launches
    in ``ops.SHAPE_LAUNCHES``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rows, keys = [], {}
    S_tl = max(prompt_lens(TL_PROMPTS, TL_REQS))
    S_w = max(prompt_lens(W_PROMPTS, W_REQS))
    T_tl, T_w = dense_T(S_tl, TL_NEW), dense_T(S_w, W_NEW)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    # name, path, B, S, T, H, K, causal, what; D = 16 for the towers,
    # else 64
    flash = (("flash_attention_d16", "scenario", CLIP_B, CLIP_PATCHES,
              CLIP_PATCHES, CLIP_HEADS, CLIP_HEADS, False,
              "mini-clip vision tower"),
             ("flash_attention_d16_causal", "scenario", CLIP_B, CLIP_TEXT,
              CLIP_TEXT, CLIP_HEADS, CLIP_HEADS, True, "mini-clip text tower"),
             ("flash_attention_g8", TL_ARCH, 1, S_tl, S_tl, TL_H, TL_K, True,
              "tinyllama-1.1b prefill"),
             ("flash_attention_t1500", W_ARCH, 1, W_T, W_T, W_HEADS, W_HEADS,
              False, "whisper-tiny encoder"),
             ("flash_attention_cross", W_ARCH, 1, S_w, W_T, W_HEADS, W_HEADS,
              False, "whisper-tiny cross-attention prefill"),
             ("flash_attention_train", "train", TRAIN_BATCH, TRAIN_SEQ,
              TRAIN_SEQ, TL_H, TL_K, True,
              "tinyllama-1.1b training loss (phase 11)"))
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        isz = torch.tensor([], dtype=dt).element_size()
        specs = []
        for name, path, B_, S_, T_, H_, K_, causal, what in flash:
            D_ = CLIP_D if path == "scenario" else D
            keys[name] = (path, "flash_attention",
                          (B_, S_, T_, H_, K_, D_, causal, 0))
            q = rnd(B_, S_, H_, D_).to(dt)
            k, v = rnd(B_, T_, K_, D_).to(dt), rnd(B_, T_, K_, D_).to(dt)
            err = _check("flash_attention", dname,
                         f"{what}: B={B_} S={S_} T={T_} H={H_} K={K_} "
                         f"D={D_} causal={causal}",
                         ops.flash_attention(q, k, v, causal=causal),
                         ref.flash_attention_ref(q, k, v, causal=causal))
            qh, kh_, vh = (x.transpose(1, 2) for x in (q, k, v))
            specs.append((
                name, "csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:93", "flash_fwd", err,
                lambda q=q, k=k, v=v, c=causal: ops.flash_attention(
                    q, k, v, causal=c),
                lambda q=q, k=k, v=v, c=causal: ref.flash_attention_ref(
                    q, k, v, causal=c),
                lambda q=qh, k=kh_, v=vh, c=causal, gqa=H_ != K_:
                    F.scaled_dot_product_attention(q, k, v, is_causal=c,
                                                   enable_gqa=gqa),
                *_flash_work(B_, S_, T_, H_, K_, D_, causal, isz)))
        # serve() stacks up to 8 requests' rows at a tower
        for S_, causal in ((CLIP_PATCHES, False), (CLIP_TEXT, True)):
            q = rnd(8 * CLIP_B, S_, CLIP_HEADS, CLIP_D).to(dt)
            k, v = (rnd(8 * CLIP_B, S_, CLIP_HEADS, CLIP_D).to(dt)
                    for _ in range(2))
            _check("flash_attention", dname,
                   f"mini-clip tower batch of 8 requests: B={8 * CLIP_B} "
                   f"S={S_} D={CLIP_D} causal={causal}",
                   ops.flash_attention(q, k, v, causal=causal),
                   ref.flash_attention_ref(q, k, v, causal=causal))

        # -- decode: whisper-tiny cross (T = 1500, lengths = T) and self,
        #    tinyllama-1.1b solo ----------------------------------------
        for name, path, H_, K_, T_, lens, what in (
                ("decode_attention_t1500", W_ARCH, W_HEADS, W_HEADS, W_T,
                 [W_T], "whisper-tiny cross-attention decode"),
                ("decode_attention_g8", TL_ARCH, TL_H, TL_K, T_tl,
                 [S_tl + TL_NEW // 2], "tinyllama-1.1b solo decode"),
                (None, W_ARCH, W_HEADS, W_HEADS, T_w, [S_w + W_NEW // 2],
                 "whisper-tiny self-attention decode")):
            qd = rnd(1, H_, D).to(dt)
            kd, vd = rnd(1, T_, K_, D).to(dt), rnd(1, T_, K_, D).to(dt)
            ld = torch.tensor(lens, dtype=torch.int32, device=dev)
            err = _check("decode_attention", dname,
                         f"{what}: H={H_} K={K_} D={D} T={T_} lengths {lens}",
                         ops.decode_attention(qd, kd, vd, ld),
                         ref.decode_attention_ref(qd, kd, vd, ld))
            if name is None:
                continue
            keys[name] = (path, "decode_attention", (1, T_, H_, K_, D, 0))
            mask = (torch.arange(T_, device=dev)[None] < ld[:, None])[
                :, None, None, :]
            specs.append((
                name, "csrc/decode_attention.cu",
                "src/repro/kernels/decode_attention.py:70", "decode_fwd", err,
                lambda q=qd, k=kd, v=vd, l_=ld: ops.decode_attention(
                    q, k, v, l_),
                lambda q=qd, k=kd, v=vd, l_=ld: ref.decode_attention_ref(
                    q, k, v, l_),
                lambda q=qd, k=kd, v=vd, m=mask, gqa=H_ != K_:
                    F.scaled_dot_product_attention(
                        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                        attn_mask=m, enable_gqa=gqa),
                *_decode_work(qd, kd, ld, isz)))

        # -- paged decode at tinyllama-1.1b's serve tick -----------------
        keys["paged_decode_attention_g8"] = (
            TL_ARCH, "paged_decode_attention",
            (TL_ROWS, TL_NMAX, PAGE, TL_H, TL_K, D, 0))
        qp = rnd(TL_ROWS, TL_H, D).to(dt)
        kp, vp = (rnd(TL_PAGES, PAGE, TL_K, D).to(dt) for _ in range(2))
        lens_p = torch.randint(TL_PROMPTS[0], TL_PROMPTS[1] + TL_NEW,
                               (TL_ROWS,), generator=g, device=dev,
                               dtype=torch.int32)
        perm = torch.randperm(TL_PAGES - 1, generator=g, device=dev) + 1
        tables = perm[:TL_ROWS * TL_NMAX].reshape(TL_ROWS, TL_NMAX).to(
            torch.int32)
        junk = torch.randint(-50, TL_PAGES + 50, (TL_ROWS, TL_NMAX),
                             generator=g, device=dev, dtype=torch.int32)
        owned = torch.arange(TL_NMAX, device=dev)[None] * PAGE < lens_p[:, None]
        tables = torch.where(owned, tables, junk).contiguous()
        err_p = _check("paged_decode_attention", dname,
                       f"tinyllama-1.1b tick: H={TL_H} K={TL_K} D={D} "
                       f"lengths {lens_p.tolist()} garbage tails",
                       ops.paged_decode_attention(qp, kp, vp, tables, lens_p),
                       ref.paged_decode_attention_ref(qp, kp, vp, tables,
                                                      lens_p))
        specs.append((
            "paged_decode_attention_g8", "csrc/decode_attention.cu",
            "src/repro/kernels/paged_decode_attention.py:77",
            "paged_decode_fwd", err_p,
            lambda: ops.paged_decode_attention(qp, kp, vp, tables, lens_p),
            lambda: ref.paged_decode_attention_ref(qp, kp, vp, tables,
                                                   lens_p),
            None, *_paged_work(qp, kp, lens_p, owned, isz)))
        if dt is torch.float32:
            rows += [_row(*spec) for spec in specs]
    return rows, keys


def fam_prompts(arch) -> list[int]:
    """Phase 8's prompt lengths for ``arch``: 4 drawn from the seed, and
    for gemma2-9b the 4,100-token one that passes its window."""
    lens = prompt_lens(FAM_PROMPTS, FAM_REQS)
    return lens + [G2_LONG] if arch == "gemma2-9b" else lens


def phase_kernels_families(dev) -> tuple[list[dict], dict]:
    """The attention kernels at phase 8's new shapes, float32 and
    bfloat16 against their plain versions, one kernels-line row each
    (float32), timed at a call its path makes:

    * flash D = 256, H = 16, K = 8, softcap 50 at gemma2-9b's 4,100-token
      prefill, its local layers (window 4,096) and its global ones;
      D = 128, H = 32, K = 8 at llama3-8b's longest prompt; D = 64, H =
      24, K = 8 (G = 3) at granite-moe-3b-a800m's;
    * decode D = 256 over gemma2's solo cache of the long request (4,112
      slots, 4,104 keys: 4,096 live under the window), local and
      global; D = 128 over llama3's solo cache;
    * paged decode D = 256 at gemma2's serve tick (4 rows, tables of 257
      pages, the long row and three short ones), local; D = 128 at
      llama3's tick;
    * phase 9's llama3-405b (H = 128, K = 8, D = 128: G = 16, two blocks
      of 8 q-heads a kv head in both decode kernels): flash at its
      longest prompt, decode over its solo cache, paged at its tick.

    Checked besides (no row): the same decode and paged calls without a
    window or with softcap 0, granite's G = 3 decode and tick, each
    window edge (lengths 0, 1, window - 1, window, window + 1), and
    decode and paged decode at D = 256 with G = 8 and 12 (the merge in
    passes).  The library call is SDPA, or where a row has a softcap
    ``flex_attention`` (``_flex_lib``).  Returns the rows and each row's
    (path, kernel, call shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    rows, keys = [], {}
    g2, l3, gr = FAM_ARCHS
    l405 = L405_ARCH
    S_short = max(fam_prompts(l3))
    T_long = dense_T(G2_LONG, FAM_NEW)
    T_short = dense_T(S_short, FAM_NEW)
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        isz = torch.tensor([], dtype=dt).element_size()
        specs = []
        # -- flash ------------------------------------------------------
        for name, path, S_, window, softcap, flex_mask in (
                ("flash_attention_d256_local", g2, G2_LONG, G2_WINDOW,
                 G2_SOFTCAP, _g2_prefill_local),
                ("flash_attention_d256_global", g2, G2_LONG, 0, G2_SOFTCAP,
                 _g2_prefill_global),
                ("flash_attention_d128", l3, S_short, 0, 0.0, None),
                ("flash_attention_g3", gr, S_short, 0, 0.0, None),
                ("flash_attention_d128_g16", l405, S_short, 0, 0.0, None)):
            H_, K_, D_ = FAM_GEOM[path]
            keys[name] = (path, "flash_attention",
                          (1, S_, S_, H_, K_, D_, True, window))
            kw = dict(window=window, softcap=softcap)
            q = rnd(1, S_, H_, D_).to(dt)
            k, v = rnd(1, S_, K_, D_).to(dt), rnd(1, S_, K_, D_).to(dt)
            what = f"{path} prefill: S={S_} H={H_} K={K_} D={D_} {kw}"
            got = ops.flash_attention(q, k, v, **kw)
            err = _check("flash_attention", dname, what, got,
                         ref.flash_attention_ref(q, k, v, **kw))
            if dt is torch.bfloat16 and S_ == G2_LONG:  # a share of 17 M
                _flips(what, got, q, k, v, **kw)       # outputs, not of 45 k
            del got
            lib = None
            qh, kh_, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            if not softcap and not window:
                lib = (lambda q=qh, k=kh_, v=vh:
                       F.scaled_dot_product_attention(
                           q, k, v, is_causal=True, enable_gqa=True))
            elif dt is torch.float32:  # bf16 rows are checked, not kept
                lib = _flex_lib(name, qh, kh_, vh,
                                ref.flash_attention_ref(q, k, v, **kw),
                                flex_mask, S_, S_, dname)
            specs.append((
                name, "csrc/flash_attention.cu",
                "src/repro/kernels/flash_attention.py:93", "flash_fwd", err,
                lambda q=q, k=k, v=v, kw=kw: ops.flash_attention(q, k, v, **kw),
                lambda q=q, k=k, v=v, kw=kw: ref.flash_attention_ref(
                    q, k, v, **kw),
                lib, *_flash_work(1, S_, S_, H_, K_, D_, True, isz, window),
                dname, 20 if S_ == G2_LONG else 200))
        # window edges of the windowed flash at D = 256 (S = 600, window
        # 256, ragged) and a non-causal window
        H_, K_, D_ = FAM_GEOM[g2]
        q, k, v = rnd(1, 600, H_, D_).to(dt), rnd(1, 600, K_, D_).to(dt), \
            rnd(1, 600, K_, D_).to(dt)
        for kw in (dict(window=256, softcap=G2_SOFTCAP), dict(window=1),
                   dict(window=256, causal=False)):
            _check("flash_attention", dname, f"D=256 S=600 {kw}",
                   ops.flash_attention(q, k, v, **kw),
                   ref.flash_attention_ref(q, k, v, **kw))

        # -- decode: gemma2's long solo cache, local and global; llama3's
        #    and granite's short ones -------------------------------------
        for name, path, T_, n_len, window, softcap, flex_mask in (
                ("decode_attention_d256_local", g2, T_long, G2_DECODE_LEN,
                 G2_WINDOW, G2_SOFTCAP, _g2_decode_local),
                ("decode_attention_d256_global", g2, T_long, G2_DECODE_LEN,
                 0, G2_SOFTCAP, _g2_decode_global),
                ("decode_attention_d128", l3, T_short,
                 S_short + FAM_NEW // 2, 0, 0.0, None),
                (None, gr, T_short, S_short + FAM_NEW // 2, 0, 0.0, None),
                ("decode_attention_d128_g16", l405, T_short,
                 S_short + FAM_NEW // 2, 0, 0.0, None)):
            H_, K_, D_ = FAM_GEOM[path]
            qd = rnd(1, H_, D_).to(dt)
            kd, vd = rnd(1, T_, K_, D_).to(dt), rnd(1, T_, K_, D_).to(dt)
            ld = torch.tensor([n_len], dtype=torch.int32, device=dev)
            kw = dict(window=window, softcap=softcap)
            err = _check("decode_attention", dname,
                         f"{path} solo decode: H={H_} K={K_} D={D_} T={T_} "
                         f"length {n_len} {kw} n_split "
                         f"{ops.decode_splits(T_, 1, K_, H_ // K_, n_sm, window)}",
                         ops.decode_attention(qd, kd, vd, ld, **kw),
                         ref.decode_attention_ref(qd, kd, vd, ld, **kw))
            if name is None:
                continue
            keys[name] = (path, "decode_attention",
                          (1, T_, H_, K_, D_, window))
            lib = None
            if not softcap:
                mask = (torch.arange(T_, device=dev)[None] < ld[:, None])[
                    :, None, None, :]
                lib = (lambda q=qd, k=kd, v=vd, m=mask:
                       F.scaled_dot_product_attention(
                           q[:, :, None], k.transpose(1, 2),
                           v.transpose(1, 2), attn_mask=m, enable_gqa=True))
            elif dt is torch.float32:
                lib = _flex_lib(name, qd[:, :, None].contiguous(),
                                kd.transpose(1, 2).contiguous(),
                                vd.transpose(1, 2).contiguous(),
                                ref.decode_attention_ref(qd, kd, vd, ld, **kw),
                                flex_mask, 1, T_, dname)
            specs.append((
                name, "csrc/decode_attention.cu",
                "src/repro/kernels/decode_attention.py:70", "decode_fwd", err,
                lambda q=qd, k=kd, v=vd, l_=ld, kw=kw: ops.decode_attention(
                    q, k, v, l_, **kw),
                lambda q=qd, k=kd, v=vd, l_=ld, kw=kw:
                    ref.decode_attention_ref(q, k, v, l_, **kw),
                lib, *_decode_work(qd, kd, ld, isz, window), dname))
        # the window's edges in one batch, over gemma2's geometry
        H_, K_, D_ = FAM_GEOM[g2]
        w = 256
        lens = torch.tensor([0, 1, w - 1, w, w + 1, 600, 1000],
                            dtype=torch.int32, device=dev)
        qd = rnd(len(lens), H_, D_).to(dt)
        kd, vd = (rnd(len(lens), 1000, K_, D_).to(dt) for _ in range(2))
        for kw in (dict(window=w), dict(window=w, softcap=G2_SOFTCAP)):
            _check("decode_attention", dname,
                   f"D=256 window edges lengths {lens.tolist()} {kw}",
                   ops.decode_attention(qd, kd, vd, lens, **kw),
                   ref.decode_attention_ref(qd, kd, vd, lens, **kw))

        # D = 256 with more q-heads a block (G = 8; G = 12, a block of 8
        # and one of 4) than the merge has a thread for each output float4:
        # the merge runs in passes
        for H_, K_ in ((16, 2), (12, 1)):
            mk = (lambda *sh: rnd(*sh).to(dt))
            _decode_edges(mk, dname, dev, H_, K_, 256, 1000)
            _paged_edges(mk, dname, dev, H_, K_, 256)

        # -- paged decode: gemma2's tick (local), llama3's and granite's --
        for name, path, cache, window, softcap in (
                ("paged_decode_attention_d256_local", g2, G2_CACHE,
                 G2_WINDOW, G2_SOFTCAP),
                (None, g2, G2_CACHE, 0, G2_SOFTCAP),
                ("paged_decode_attention_d128", l3, FAM_CACHE[l3], 0, 0.0),
                (None, gr, FAM_CACHE[gr], 0, 0.0),
                ("paged_decode_attention_d128_g16", l405, FAM_CACHE[l405], 0,
                 0.0)):
            H_, K_, D_ = FAM_GEOM[path]
            n_max = cache // PAGE
            P = FAM_ROWS * n_max + 1
            row_lens = [n + FAM_NEW // 2 for n in fam_prompts(path)]
            lens_p = torch.tensor(sorted(row_lens, reverse=True)[:FAM_ROWS],
                                  dtype=torch.int32, device=dev)
            qp = rnd(FAM_ROWS, H_, D_).to(dt)
            kp, vp = (rnd(P, PAGE, K_, D_).to(dt) for _ in range(2))
            perm = torch.randperm(P - 1, generator=g, device=dev) + 1
            tables = perm[:FAM_ROWS * n_max].reshape(FAM_ROWS, n_max).to(
                torch.int32)
            junk = torch.randint(-50, P + 50, (FAM_ROWS, n_max), generator=g,
                                 device=dev, dtype=torch.int32)
            owned = torch.arange(n_max, device=dev)[None] * PAGE < lens_p[:, None]
            tables = torch.where(owned, tables, junk).contiguous()
            kw = dict(window=window, softcap=softcap)
            err = _check("paged_decode_attention", dname,
                         f"{path} tick: H={H_} K={K_} D={D_} {n_max} pages a "
                         f"row, lengths {lens_p.tolist()} {kw}",
                         ops.paged_decode_attention(qp, kp, vp, tables,
                                                    lens_p, **kw),
                         ref.paged_decode_attention_ref(qp, kp, vp, tables,
                                                        lens_p, **kw))
            if name is None:
                continue
            keys[name] = (path, "paged_decode_attention",
                          (FAM_ROWS, n_max, PAGE, H_, K_, D_, window))
            specs.append((
                name, "csrc/decode_attention.cu",
                "src/repro/kernels/paged_decode_attention.py:77",
                "paged_decode_fwd", err,
                lambda q=qp, k=kp, v=vp, t=tables, l_=lens_p, kw=kw:
                    ops.paged_decode_attention(q, k, v, t, l_, **kw),
                lambda q=qp, k=kp, v=vp, t=tables, l_=lens_p, kw=kw:
                    ref.paged_decode_attention_ref(q, k, v, t, l_, **kw),
                None, *_paged_work(qp, kp, lens_p, owned, isz, window),
                dname))
        if dt is torch.float32:
            rows += [_row(*spec) for spec in specs]
        del specs
    return rows, keys


def _mla_work(q_lat, lens, n_rows, pages_read) -> tuple[int, float]:
    """MLA's paged decode call: its bytes (each live key's ckv and kr
    once, each row's q_lat, q_pe and output, the table entries of the
    pages read and the lengths) and FLOPs (the scores against ckv || kr
    and the weighted sum of ckv, each head and live key)."""
    B, H, r = q_lat.shape
    rope = MLA_ROPE
    live = int(lens.clamp_min(0).sum())
    nbytes = (4 * live * (r + rope) + 4 * n_rows * H * (2 * r + rope)
              + 4 * pages_read + 4 * n_rows)
    return nbytes, 2.0 * H * live * (2 * r + rope)


#: dots-vlm1.ocr's tick: 64 rows in tables of 200 pages of 16
MLA_OCR_ROWS, MLA_OCR_PAGES = 64, 200


def mla_ocr_lengths() -> list[int]:
    """The lengths of dots-vlm1.ocr's tick: 36 of the 64 rows live (as
    the cell's traced runs hold on average), 1,100-3,200 keys, spread
    over the rows; the rest 0."""
    live = sorted(set(range(0, MLA_OCR_ROWS, 16))
                  | set(range(1, MLA_OCR_ROWS, 2)))[:36]
    lens = [0] * MLA_OCR_ROWS
    for i, row in enumerate(live):
        lens[row] = 1100 + 60 * i
    return lens


def phase_kernels_mla(dev) -> tuple[list[dict], dict]:
    """MLA's absorbed paged decode (``paged_mla_decode``) against its
    plain version, float32 (the kernel's only instance), each timed row
    with its bound, plain and library columns: phase 9's deepseek-v3-671b
    tick (4 rows, H = 128, r = 512, rope = 64, tables of 16 pages of 16,
    lengths across page boundaries: each prompt's length plus half the
    new tokens, garbage table entries past a row's pages) and
    dots-vlm1.ocr's (``paged_mla_decode_ocr``: 64 rows, 36 live of
    1,100-3,200 keys, 200 pages of 16; no path of this script runs it);
    and, checked besides, rows of length 0 and 1, a page boundary +- 1
    and a full table.  The library call is SDPA over the row's keys
    gathered beforehand (ckv || kr as one kv head, ckv as the value)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    H_, r, rope = 128, 512, MLA_ROPE
    scale = (128 + 64) ** -0.5

    def case(lens, n_max):
        B = len(lens)
        P = B * n_max + 1
        q_lat = torch.randn(B, H_, r, generator=g, device=dev)
        q_pe = torch.randn(B, H_, rope, generator=g, device=dev)
        ckv = torch.randn(P, PAGE, r, generator=g, device=dev)
        kr = torch.randn(P, PAGE, rope, generator=g, device=dev)
        perm = torch.randperm(P - 1, generator=g, device=dev) + 1
        tables = perm[:B * n_max].reshape(B, n_max).to(torch.int32)
        lens_t = torch.tensor(lens, dtype=torch.int32, device=dev)
        junk = torch.randint(-50, P + 50, (B, n_max), generator=g,
                             device=dev, dtype=torch.int32)
        owned = torch.arange(n_max, device=dev)[None] * PAGE < lens_t[:, None]
        tables = torch.where(owned, tables, junk).contiguous()
        return (q_lat, q_pe, ckv, kr, tables, lens_t), int(owned.sum())

    n_max = FAM_CACHE[L405_ARCH] // PAGE
    lens = [n + FAM_NEW // 2 for n in prompt_lens(FAM_PROMPTS, FAM_REQS)]
    args, pages = case(lens, n_max)
    err = _check("paged_mla_decode", "float32",
                 f"phase 9's tick: H={H_} r={r} rope={rope} {n_max} pages a "
                 f"row, lengths {lens}",
                 ops.paged_mla_decode(*args, scale=scale),
                 ref.paged_mla_decode_ref(*args, scale=scale))
    eargs, _ = case([0, 1, PAGE - 1, PAGE, PAGE + 1, n_max * PAGE], n_max)
    _check("paged_mla_decode", "float32", "edges",
           ops.paged_mla_decode(*eargs, scale=scale),
           ref.paged_mla_decode_ref(*eargs, scale=scale))
    ocr_lens = mla_ocr_lengths()
    ocr_args, ocr_pages = case(ocr_lens, MLA_OCR_PAGES)
    ocr_err = _check("paged_mla_decode", "float32",
                     f"dots-vlm1.ocr's tick: {MLA_OCR_ROWS} rows, "
                     f"{sum(n > 0 for n in ocr_lens)} live of 1,100-3,200 "
                     f"keys, {MLA_OCR_PAGES} pages a row",
                     ops.paged_mla_decode(*ocr_args, scale=scale),
                     ref.paged_mla_decode_ref(*ocr_args, scale=scale))

    def sdpa(args):
        """SDPA over each row's keys gathered beforehand, the row's heads
        as the queries of its one key head (GQA's expansion would copy
        the keys 128 times)."""
        q_lat, q_pe, ckv, kr, tables, lens_t = args
        T_ = tables.shape[1] * PAGE
        idx = tables.long().clamp(0, ckv.shape[0] - 1)
        keys = torch.cat([ckv[idx], kr[idx]], -1).reshape(len(lens_t), 1,
                                                          T_, r + rope)
        vals = ckv[idx].reshape(len(lens_t), 1, T_, r)
        mask = (torch.arange(T_, device=dev)[None] < lens_t[:, None])[
            :, None, None, :]
        qq = torch.cat([q_lat, q_pe], -1)[:, None]
        return lambda: F.scaled_dot_product_attention(
            qq, keys, vals, attn_mask=mask, scale=scale)[:, 0]

    keys_ = {"paged_mla_decode": (DS_ARCH, "paged_mla_decode",
                                  (len(lens), n_max, PAGE, H_, r, rope)),
             "paged_mla_decode_ocr": ((DS_ARCH,), "paged_mla_decode",
                                      (MLA_OCR_ROWS, MLA_OCR_PAGES, PAGE, H_,
                                       r, rope))}
    # device time: every kernel of a call (the kernel, and its split
    # merge where the row's keys split)
    rows = []
    for name, a, err_, n_pages, iters in (
            ("paged_mla_decode", args, err, pages, 200),
            ("paged_mla_decode_ocr", ocr_args, ocr_err, ocr_pages, 50)):
        rows.append(_row(
            name, "csrc/mla_decode.cu",
            "none (the JAX package runs MLA as plain products)", "", err_,
            lambda a=a: ops.paged_mla_decode(*a, scale=scale),
            lambda a=a: ref.paged_mla_decode_ref(*a, scale=scale),
            sdpa(a), *_mla_work(a[0], a[5], len(a[5]), n_pages),
            iters=iters))
    return rows, keys_


def _tile_work(q, tables, lens, tile, ps_loc, P_loc, K_, D_, isz,
               window=0) -> tuple[int, float]:
    """A tile-mode call's bytes (q, o, the lse, the k and v of the live keys
    the tile holds, the table entries of the rows' live spans, the
    lengths) and FLOPs over those keys: key t < lengths[b] (>= lengths[b]
    - window under a window) is the tile's where its page (clamped into
    the pool) lies in [p0, p0 + P_loc) and its slot in [s0, s0 +
    ps_loc)."""
    import torch

    p0, n_pages, s0, ps = tile
    B, H_, _ = q.shape
    n_max = tables.shape[1]
    t = torch.arange(n_max * ps, device=q.device)
    n = lens.long()[:, None]
    live = t[None] < n
    if window:
        live &= t[None] >= n - window
    page = tables.long().clamp(0, n_pages - 1).repeat_interleave(ps, dim=1)
    slot = (t % ps)[None]
    held = live & (page >= p0) & (page < p0 + P_loc) & (slot >= s0) & \
        (slot < s0 + ps_loc)
    keys = int(held.sum())
    spans = int(live.reshape(B, n_max, ps).any(-1).sum())
    nbytes = (2 * q.numel() * isz + 4 * B * H_ + 2 * keys * K_ * D_ * isz
              + 4 * spans + 4 * B)
    return nbytes, 4 * D_ * H_ * keys


#: phase 2's tile-mode rows: (row, the kernel checker's case, the phase 15
#: path whose launches it reads; None: no path on one card runs it)
TILE_ROWS = (("paged_decode_attention_tile_h14",
              "internvl2-1b/paged-tile-rank", "internvl2-1b"),
             ("paged_decode_attention_tile_d256_local",
              "gemma2-9b/paged-tile-local-rank", "gemma2-9b"),
             ("paged_decode_attention_tile_page_range",
              "internvl2-1b/paged-tile-page-range", None))


def phase_kernels_paged_tile(dev) -> tuple[list[dict], dict]:
    """The paged kernel's tile mode at phase 15's rank tiles, float32 and
    bfloat16 against its plain version (o, and the log-sum-exp where the
    tile holds a live key: -inf on the same rows), one kernels-line row
    each (float32), timed at phase 15's first tick (its tables and
    lengths): (a) internvl2-1b's tick on a rank of (1, 2), 4 rows, H = 14,
    K = 2, D = 64, slots 8-15 of every page; (b) gemma2-9b's local layer,
    D = 256, window 4,096 from mid-page, softcap 50, slots 0-7; (c)
    internvl2-1b's tick on a page range, pages 35-69 and slots 4-7 of 16,
    as a (2, 4) mesh lays the pool out: no path on one card runs it, so
    this row is what holds the page-ownership path on the card.  The
    tiles are the kernel checker's cases.  No one call computes the tile
    function; SDPA over the tile's pre-gathered live keys is logged as a
    yardstick where there is no softcap.  Returns the rows and each row's
    (path, kernel, call shape)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.analysis import kernel_check as kc
    from repro_torch.kernels import ops, ref

    g = torch.Generator(device=dev).manual_seed(SEED + 9)
    rows, keys = [], {}
    zoo = {c.name: c for c in kc.zoo_cases()}
    for dt in (torch.float32, torch.bfloat16):
        dname = str(dt).split(".")[1]
        isz = torch.tensor([], dtype=dt).element_size()
        for name, case_name, arch in TILE_ROWS:
            case = zoo[case_name]
            kw = dict(case.kwargs)
            tile = kw["tile"]
            cfg = _pm_cfg("internvl2-1b" if arch is None else arch)
            n_pages, _, tables, lens = _pm_layout(cfg, _pm_requests(cfg))
            B_, H_, D_ = case.shape("q")
            P_loc, ps_loc, K_, _ = case.shape("k_pages")
            if (n_pages, tables.shape) != (tile[1], case.shape(
                    "block_tables")):
                fail(f"{name}: phase 15's pool ({n_pages} pages, tables "
                     f"{tables.shape}) is not the checker's {case_name}")
            tables = torch.from_numpy(tables).to(dev)
            lens = torch.tensor(lens, dtype=torch.int32, device=dev) + 1
            q = torch.randn(B_, H_, D_, generator=g, device=dev).to(dt)
            kp, vp = (torch.randn(P_loc, ps_loc, K_, D_, generator=g,
                                  device=dev).to(dt) for _ in range(2))
            o, lse = ops.paged_decode_attention(q, kp, vp, tables, lens,
                                                **kw)
            wo, wl = ref.paged_decode_attention_ref(q, kp, vp, tables, lens,
                                                    **kw)
            torch.cuda.synchronize()
            live = torch.isfinite(wl)
            if not torch.equal(torch.isfinite(lse), live):
                fail(f"{name} {dname}: the kernel's -inf log-sum-exps "
                     f"{(~torch.isfinite(lse)).nonzero().tolist()} are not "
                     f"the plain version's {(~live).nonzero().tolist()}")
            what = (f"tile {tile} of {P_loc} pages x {ps_loc} slots, H={H_} "
                    f"K={K_} D={D_}, lengths {lens.tolist()} window "
                    f"{kw['window']} softcap {kw['softcap']}; rows with no "
                    f"live key {(~live).all(-1).nonzero()[:, 0].tolist()}")
            err = _check("paged_decode_attention", dname, f"{what}: o", o, wo)
            _check("paged_decode_attention", dname, f"{what}: lse",
                   torch.where(live, lse, 0.0), torch.where(live, wl, 0.0))
            if arch is not None:
                keys[name] = (f"{arch}-paged-mesh", "paged_decode_attention",
                              (B_, tables.shape[1], ps_loc, H_, K_, D_,
                               kw["window"], P_loc, tile[3]))
            else:  # no path on one card: 0 on phase 15's
                keys[name] = (tuple(f"{a}-paged-mesh" for a in PM_ARCHS),
                              "paged_decode_attention",
                              (B_, tables.shape[1], ps_loc, H_, K_, D_,
                               kw["window"], P_loc, tile[3]))
            if dt is not torch.float32:
                continue
            rows.append(_row(
                name, "csrc/decode_attention.cu",
                "src/repro/kernels/paged_decode_attention.py:77",
                "paged_decode_fwd", err,
                lambda q=q, k=kp, v=vp, t=tables, l_=lens, kw=kw:
                    ops.paged_decode_attention(q, k, v, t, l_, **kw),
                lambda q=q, k=kp, v=vp, t=tables, l_=lens, kw=kw:
                    ref.paged_decode_attention_ref(q, k, v, t, l_, **kw),
                None, *_tile_work(q, tables, lens, tile, ps_loc, P_loc, K_,
                                  D_, isz, kw["window"])))
            if kw["softcap"]:
                continue
            # a yardstick: SDPA over the tile's keys gathered beforehand
            p0, n_max = tile[0], tables.shape[1]
            pg = tables.long().clamp(0, tile[1] - 1) - p0
            held = ((pg >= 0) & (pg < P_loc)).repeat_interleave(ps_loc, 1)
            t_ = (torch.arange(n_max, device=dev)[:, None] * tile[3] + tile[2]
                  + torch.arange(ps_loc, device=dev)[None]).reshape(-1)
            mask = (held & (t_[None] < lens[:, None].long()))[:, None, None]
            loc = pg.clamp(0, P_loc - 1)
            kg, vg = (x[loc].reshape(B_, n_max * ps_loc, K_, D_).transpose(
                1, 2) for x in (kp, vp))
            log(f"[kernels] {name} float32: SDPA over the tile's pre-gathered "
                "keys (gather not timed) "
                f"{time_ms(lambda: F.scaled_dot_product_attention(q[:, :, None], kg, vg, attn_mask=mask, enable_gqa=True)):.4f} ms")
    return rows, keys


# --------------------------------------------------------------------------
# phase 3: serve at full width
# --------------------------------------------------------------------------

GB = 1024**3


def _deployment(dev, cfg, bf16=False, compute=None):
    """Phase 3's deployment: a stand-in vision encoder shared by the
    caption, ocr and classify tasks, the generative head ``cfg`` with
    float32 weights from seed 0 at float32 compute; with ``bf16`` (phase
    16) the same draws cast to bfloat16 and the bundle built with the
    default compute, bfloat16, or with ``compute``.  Returns
    (deployment, bundle, params)."""
    import torch

    from repro_torch.common.pytree import tree_map
    from repro_torch.core.cluster import ClusterSpec, DeviceSpec
    from repro_torch.core.module import ModelSpec, ModuleSpec
    from repro_torch.models.api import build_model
    from repro_torch.s2m3 import Deployment

    if compute is None and not bf16:
        compute = torch.float32
    bundle = build_model(cfg) if compute is None else \
        build_model(cfg, compute_dtype=compute)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    params = bundle.init(gen, torch.float32, dev)
    if bf16:
        params = tree_map(lambda t: t.to(torch.bfloat16), params)
    d = cfg.d_model
    w_enc = 0.1 * torch.randn(d, d, generator=gen, device=dev)
    w_cls = 0.05 * torch.randn(d, 1000, generator=gen, device=dev)
    enc = ModuleSpec("pix-enc", "encoder", "vision", d * d,
                     bytes_per_param=4.0,
                     flops_per_query=2.0 * cfg.n_image_tokens * d * d)
    head = ModuleSpec("vlm-head", "head", "task", bundle.param_count(),
                      bytes_per_param=2.0 if bf16 else 4.0, generative=True,
                      flops_per_query=2.0 * bundle.param_count(),
                      kv_bytes_per_token=bundle.kv_bytes_per_token())
    cls = ModuleSpec("cls-head", "head", "task", d * 1000,
                     bytes_per_param=4.0, flops_per_query=2.0 * d * 1000)
    builders = {
        "pix-enc": lambda: (lambda p, x: torch.tanh(x @ p), w_enc),
        "vlm-head": lambda: (bundle, params),
        "cls-head": lambda: (lambda p, e: e["vision"].mean(-2) @ p, w_cls),
    }
    cluster = ClusterSpec(devices=[DeviceSpec(f"dev{i}", 40 * GB, 5e13)
                                   for i in range(2)])
    dep = (Deployment(cluster)
           .add_model(ModelSpec("caption", "captioning", (enc,), head),
                      builders)
           .add_model(ModelSpec("ocr", "ocr", (enc,), head))
           .add_model(ModelSpec("classify", "classification", (enc,), cls))
           .plan("greedy"))
    return dep, bundle, params


def _workload(cfg, Request):
    import numpy as np

    rng = np.random.default_rng(SEED)
    tasks = ["caption", "ocr", "classify", "caption", "ocr", "caption",
             "classify", "ocr"]
    reqs = []
    for rid, task in enumerate(tasks):
        img = (0.1 * rng.standard_normal((cfg.n_image_tokens, cfg.d_model))
               ).astype(np.float32)
        if task == "classify":
            reqs.append(Request(rid, task, "dev0", inputs={"vision": img}))
            continue
        n = int(rng.integers(4, PROMPT_MAX + 1))
        prompt = tuple(int(t) for t in rng.integers(0, cfg.vocab_size, n))
        reqs.append(Request(rid, task, "dev0", prompt=prompt,
                            max_new_tokens=int(rng.integers(16, MAX_NEW_MAX + 1)),
                            temperature=0.0, inputs={"vision": img},
                            slo_deadline=60.0))
    return reqs


SERVE_KW = dict(decode_rows=ROWS, page_size=PAGE, max_seq_len=512,
                decode_pages=N_PAGES)
# serve() vs submit() and card vs CPU, on float32 logits: the same math
# in another order (batched vs batch-1 GEMMs, paged vs dense attention)
LOGIT_TOL = 2e-4


@contextlib.contextmanager
def record_logits(store: dict):
    """Keep a copy of every logits row a token is chosen from, keyed by
    rid (the seed of the request's sampling generator), on the decode
    stream (serve) and the solo path (submit) alike.  A tick's logits
    exist only on the eager step (the CUDA graph keeps its picks alone),
    so the decode stream takes it while recording: ``_graph_vs_eager``
    serves the graph's ticks."""
    from repro_torch.serving import decode, sampler

    select = sampler.select_token
    pick = decode.pick_tokens
    engages = vars(decode.DecodeStream)["graph_engages"]

    def recording(logits, generator=None, **kw):
        store.setdefault(generator.initial_seed(), []).append(
            logits.detach().clone())
        return select(logits, generator, **kw)

    def picking(logits, live):
        for row, seq in live:
            if seq.request.temperature <= 0.0:      # sampled: recording()
                store.setdefault(seq.rng.initial_seed(), []).append(
                    logits[row].detach().clone())
        return pick(logits, live)

    decode.select_token = sampler.select_token = recording
    decode.pick_tokens = picking
    decode.DecodeStream.graph_engages = staticmethod(lambda rt, live: False)
    try:
        yield
    finally:
        decode.select_token = sampler.select_token = select
        decode.pick_tokens = pick
        decode.DecodeStream.graph_engages = engages


def _graph_vs_eager(tag, arch, serve, eager, n_layers,
                    kernel="paged_decode_attention") -> None:
    """The served path again on the decode tick's CUDA graph: ``serve()``
    serves the requests of a recorded run (``record_logits``: the eager
    step) once more on the same weights and returns (results, its decode
    stream).  Checked: every request's tokens == the eager ticks', one
    capture and every later tick a replay, and the launches of the paged
    ``kernel`` the replays count == ticks x layers."""
    import numpy as np
    import torch

    from repro_torch.kernels import ops

    before = ops.LAUNCHES[kernel]
    results, stream = serve()
    torch.cuda.synchronize()
    paged = ops.LAUNCHES[kernel] - before
    for r in results:
        a, b = np.asarray(r.output), np.asarray(eager[r.rid])
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"{arch} rid {r.rid}: graph tokens {a.tolist()} != eager "
                 f"{b.tolist()}")
    steps = stream.decode_steps
    if (stream.graph_captures, stream.graph_replays) != (1, steps - 1):
        fail(f"{arch}: {stream.graph_captures} graph captures and "
             f"{stream.graph_replays} replays over {steps} ticks (want 1 "
             f"and {steps - 1})")
    if paged != steps * n_layers:
        fail(f"{arch}: {paged} paged launches counted over {steps} ticks, "
             f"want {steps * n_layers}")
    log(f"[{tag}] {arch} graph == eager: {len(results)} requests' tokens "
        f"equal; {steps} ticks, 1 capture, {stream.graph_replays} replays; "
        f"paged launches {paged} == ticks x {n_layers} layers")


def _model_steps(bundle, params, batch, device):
    """Prefill, then three steps each of paged and dense decode (one
    live row and one dead row on the page pool); the logits, on the CPU."""
    import torch

    from repro_torch.serving.kvcache import insert_pages

    cfg = bundle.cfg
    S = batch["tokens"].shape[1]
    L = (cfg.n_image_tokens if cfg.has_vision_stub else 0) + S
    ps = 16
    n_pages = -(-(L + 3) // ps)
    dense = bundle.init_cache(1, n_pages * ps, torch.float32, device)
    logits, dense = bundle.prefill(
        params, {k: v.to(device) for k, v in batch.items()}, dense)
    outs = [logits.cpu()]
    pages = list(range(n_pages, 0, -1))              # shuffled pool pages
    pool = insert_pages(
        bundle.init_paged_cache(n_pages + 1, ps, torch.float32, device),
        dense, pages, L)
    tables = torch.tensor([pages + [-7], [0] * (n_pages + 1)],
                          dtype=torch.int32, device=device)
    for i in range(3):
        lens = torch.tensor([L + i, 0], dtype=torch.int32, device=device)
        tok = torch.tensor([[i + 3], [0]], dtype=torch.int32, device=device)
        logits, pool = bundle.paged_decode_step(params, tok, pool, tables,
                                                lens)
        outs.append(logits[:1].cpu())
        logits, dense = bundle.decode_step(params, tok[:1], dense, lens[:1])
        outs.append(logits.cpu())
    return outs


def phase_reference(dev):
    """The same weights through the kernels on the card and through the
    plain versions on the CPU (which the CPU tests hold to the JAX
    package): prefill, paged and dense decode logits agree.  Once at
    smoke size, once at internvl2-1b's full width with depth cut to 2
    layers (all three kernels at the path's head geometry)."""
    import torch

    from repro_torch.common.config import get_config
    from repro_torch.common.pytree import tree_map
    from repro_torch.models.api import build_model

    for label, cfg in (
            ("smoke", get_config("internvl2-1b", smoke=True)),
            ("full width, 2 layers",
             get_config("internvl2-1b").with_overrides(n_layers=2))):
        b = build_model(cfg, compute_dtype=torch.float32)
        p_cpu = b.init(torch.Generator().manual_seed(SEED), device="cpu")
        g = torch.Generator().manual_seed(SEED + 1)
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (1, 7),
                                         generator=g, dtype=torch.int32),
                 "image_embeds": 0.1 * torch.randn(
                     1, cfg.n_image_tokens, cfg.d_model, generator=g)}
        want = _model_steps(b, p_cpu, batch, "cpu")
        got = _model_steps(b, tree_map(lambda t: t.to(dev), p_cpu), batch,
                           dev)
        worst = max(_err(a, c) for a, c in zip(got, want))
        ok = worst <= LOGIT_TOL
        log(f"[reference] internvl2-1b {label}: card (kernels) vs CPU "
            f"(plain versions), prefill + 3 paged + 3 dense decode steps: "
            f"max |dlogit| {worst:.3e} (tol {LOGIT_TOL:g}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"internvl2-1b {label} on the card disagrees with the CPU")


def phase_serve(dev) -> dict:
    import numpy as np
    import torch

    from repro_torch.common.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.s2m3 import Request

    phase_reference(dev)
    cfg = get_config("internvl2-1b")
    t0 = time.perf_counter()
    dep, bundle, _ = _deployment(dev, cfg)
    dep.materialize()
    torch.cuda.synchronize()
    log(f"[serve] internvl2-1b full: {bundle.param_count():,} parameters "
        f"({bundle.param_count() * 4 / 1e9:.2f} GB f32), {cfg.n_layers} "
        f"layers, d_model {cfg.d_model}, H {cfg.n_heads}, K "
        f"{cfg.n_kv_heads}; built in {time.perf_counter() - t0:.1f} s")
    reqs = _workload(cfg, Request)
    gen_reqs = [r for r in reqs if r.prompt is not None]
    # warm-up (cuBLAS handles, allocator): one short solo request
    warm = gen_reqs[0]
    dep.submit(Request(99, warm.model, "dev0", prompt=warm.prompt,
                       max_new_tokens=2, inputs=warm.inputs))
    torch.cuda.synchronize()

    # ---- the main path: counts from 0, serve(), then submit() --------
    # (every step's logits kept for the check below: one device copy each)
    served_logits, solo_logits = {}, {}
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t_serve = time.perf_counter()
    with record_logits(served_logits):
        results = dep.serve(reqs, **SERVE_KW)
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t_serve
    solo = {}
    t_submit = time.perf_counter()
    with record_logits(solo_logits):
        for r in gen_reqs:
            solo[r.rid] = dep.submit(r)
    torch.cuda.synchronize()
    t_submit = time.perf_counter() - t_submit
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches = dict(ops.LAUNCHES)
    shapes = f32_shapes()
    log(f"[serve] launches by call shape: "
        f"{ {k: v for k, v in shapes.items() if v} }")

    sched = dep.scheduler
    stream = sched.decode["vlm-head"]
    stats = sched.stats_dict()
    log(f"[serve] serve(): {len(results)} requests in {t_serve:.3f} s; "
        f"submit() x{len(gen_reqs)} in {t_submit:.3f} s")
    log(f"[serve] vlm-head stats: {json.dumps(stats['vlm-head'])}")
    log(f"[serve] pix-enc stats: {json.dumps(stats['pix-enc'])}")

    # serve() == submit(): the tokens, and the logits of every step (the
    # random-weight model may repeat one token, so tokens alone would
    # not show a row that read another row's pages, length or position)
    by_rid = {r.rid: r for r in results}
    for r in gen_reqs:
        a, b = np.asarray(by_rid[r.rid].output), np.asarray(solo[r.rid].output)
        lg_a = torch.stack(served_logits[r.rid])
        lg_b = torch.stack(solo_logits[r.rid])
        top2 = lg_b.topk(2, dim=-1).values
        gaps = top2[:, 0] - top2[:, 1]
        if a.shape != b.shape or not np.array_equal(a, b):
            diff = next((i for i in range(min(len(a), len(b)))
                         if a[i] != b[i]), min(len(a), len(b)))
            gap = gaps[min(diff, len(gaps) - 1)].item()
            fail(f"rid {r.rid}: serve tokens {a.tolist()} != submit "
                 f"{b.tolist()} (first at step {diff}, submit's top-2 "
                 f"logit gap there {gap:.3e})")
        dlogit = _err(lg_a, lg_b)
        log(f"[serve] rid {r.rid} {r.model}: {len(a)} tokens, serve == "
            f"submit: {a.tolist()}; max |dlogit| over {len(lg_a)} steps "
            f"{dlogit:.3e} (tol {LOGIT_TOL:g}; |logit| up to "
            f"{lg_b.abs().max().item():.3f}, top-2 gap "
            f"{gaps.min().item():.3e}..{gaps.max().item():.3e})")
        if dlogit > LOGIT_TOL:
            fail(f"rid {r.rid}: serve logits differ from submit's by "
                 f"{dlogit:.3e}")
    for r in reqs:
        if r.prompt is None:
            out = by_rid[r.rid].output
            if tuple(out.shape) != (1000,) or not bool(torch.isfinite(out).all()):
                fail(f"classify rid {r.rid}: output {tuple(out.shape)}")
            solo_out = dep.submit(r).output
            err = _err(out, solo_out)
            if err > LOGIT_TOL:
                fail(f"classify rid {r.rid}: serve vs submit {err:.3e}")
            log(f"[serve] rid {r.rid} classify: logits (1000,) finite, "
                f"serve vs submit max err {err:.3e}")

    # scheduler invariants
    if sched.cross_task_decode_batches < 1:
        fail("no decode batch spanned two tasks")
    if stats["pix-enc"]["cross_task_batches"] < 1:
        fail("no pix-enc batch spanned two tasks")
    if stream.pool.n_live_pages != 1:
        fail(f"page pool not drained: {stream.pool.n_live_pages} pages live")
    sched.check_invariants()
    sim = dep.simulate(reqs)
    for r in results:
        if r.devices != sim.routes[r.rid]:
            fail(f"rid {r.rid}: route {r.devices} != simulated "
                 f"{sim.routes[r.rid]}")
    log(f"[serve] cross_task_decode_batches {sched.cross_task_decode_batches}, "
        f"pix-enc cross-task batches {stats['pix-enc']['cross_task_batches']}, "
        "pool drained to the dummy page, routes == simulate()")

    # launch counts: every attention call went through a kernel
    n_l = cfg.n_layers
    submit_steps = sum(len(solo[r.rid].output) - 1 for r in gen_reqs)
    want = dict.fromkeys(ops.LAUNCHES, 0)    # no SSD / sLSTM launch here
    want.update({"paged_decode_attention": stream.decode_steps * n_l,
                 "flash_attention": (stream.prefills + len(gen_reqs)) * n_l,
                 "decode_attention": submit_steps * n_l})
    log(f"[serve] kernel launches {launches}, expected {want}")
    if launches != want:
        fail(f"kernel launches {launches} != expected {want}")

    # the tick's CUDA graph on the main path: the same requests again
    def graph_serve():
        out = dep.serve(reqs, **SERVE_KW)
        return ([r for r in out if r.rid in solo],
                dep.scheduler.decode["vlm-head"])

    _graph_vs_eager("serve", "internvl2-1b", graph_serve,
                    {rid: by_rid[rid].output for rid in solo}, n_l)
    rates = _serve_rates(dep, gen_reqs, dep.scheduler.decode["vlm-head"],
                         submit_steps, t_submit, peak_gb, "serve")
    return ({"launches": launches, "shapes": shapes, "rates": rates}, dep,
            gen_reqs)


def _serve_rates(dep, gen_reqs, stream, submit_steps, t_submit, peak_gb,
                 tag) -> dict:
    """The end-to-end numbers of a serve() run, from its trace (time to
    first token, decode tokens/s and ms a tick), and of the submit()
    run beside it (solo tokens/s); logged under ``tag``."""
    import numpy as np

    trace = dep.trace()
    if trace.validate() != []:
        fail(f"trace malformed: {trace.validate()[:3]}")
    ttft, ticks = [], {}
    for r in gen_reqs:
        spans = trace.spans_for(r.rid)
        root = trace.tree(r.rid)
        pre = next(s for s in spans if s.phase == "prefill")
        ttft.append(pre.t1 - root.t0)
        for s in spans:
            if s.phase == "decode_tick":
                ticks[(s.t0, s.t1)] = s.t1 - s.t0
    rates = {"ttft_mean_ms": 1e3 * float(np.mean(ttft)),
             "ttft_max_ms": 1e3 * max(ttft),
             "tick_ms": 1e3 * float(np.mean(list(ticks.values()))),
             "tok_s": stream.decode_tokens / sum(ticks.values()),
             "solo_tok_s": (submit_steps + len(gen_reqs)) / t_submit,
             "peak_gb": peak_gb}
    log(f"[{tag}] time to first token: mean {rates['ttft_mean_ms']:.1f} ms, "
        f"p50 {1e3 * np.median(ttft):.1f} ms, max {rates['ttft_max_ms']:.1f}"
        " ms")
    log(f"[{tag}] decode: {stream.decode_tokens} tokens over {len(ticks)} "
        f"ticks, {rates['tok_s']:.1f} tokens/s, {rates['tick_ms']:.2f} ms "
        f"per tick (mean rows {stream.decode_tokens / len(ticks):.2f})")
    log(f"[{tag}] submit() solo decode: {rates['solo_tok_s']:.1f} tokens/s;"
        f" peak {peak_gb:.2f} GB allocated over serve() and submit()")
    return rates


def phase_profile(dep, gen_reqs) -> None:
    """Where a serve() run's time goes: the same generative requests
    (8 new tokens each) under ``torch.profiler``; device busy share =
    summed kernel time / wall time.  The profiler slows the host, so the
    busy share read here is a lower bound for an unprofiled run."""
    import dataclasses

    import torch
    from torch.profiler import ProfilerActivity, profile

    reqs = [dataclasses.replace(r, rid=100 + r.rid, max_new_tokens=8)
            for r in gen_reqs]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dep.serve(reqs, **SERVE_KW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log("[profile] the profiler saw no device kernels: device time "
            "not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    ticks = dep.scheduler.decode["vlm-head"].decode_steps
    log(f"[profile] serve() of {len(reqs)} requests x 8 tokens: wall "
        f"{wall * 1e3:.1f} ms, {len(kern)} kernels, device busy "
        f"{busy * 1e3:.1f} ms ({100 * busy / wall:.1f}%), {ticks} decode "
        f"ticks, {len(kern) / max(ticks, 1):.0f} kernels per tick "
        "(prefills included)")
    by_name: dict[str, list[float]] = {}
    for e in kern:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:8]
    for name, ts in top:
        log(f"[profile]   {sum(ts) / 1e3:8.2f} ms  {len(ts):6d} x  "
            f"{name[:90]}")


# --------------------------------------------------------------------------
# phase 5: the recurrent families at full width
# --------------------------------------------------------------------------

# depth cut for the card-vs-CPU check: xlstm-1.3b one group (7 mLSTM + 1
# sLSTM), zamba2-7b one superblock (6 Mamba2 + the shared attention
# block) and one tail Mamba2 block
REC_CUT = {"xlstm-1.3b": 8, "zamba2-7b": 7}
# decode step vs a fresh prefill over the same tokens, full depth: the
# recurrent step and the chunked prefill compute one function with
# other groupings of the same sums (chunked vs per-step decay products,
# mLSTM's two stabilisers); the reference's own smoke test holds the two
# to 5e-4 (tests/test_models_smoke.py:104), and so does this phase
DECODE_TOL = 5e-4


def expected_launches(cfg, n_prefills: int, n_steps: int) -> dict:
    """Kernel launches of n_prefills prefills and n_steps decode steps:
    one sLSTM launch per sLSTM block per call, the cluster kernel in
    prefill and the one-step kernel in decode (xLSTM); one SSD launch per
    Mamba2 block per prefill and one attention launch per shared-block
    call (zamba2)."""
    from repro_torch.kernels import ops

    want = dict.fromkeys(ops.LAUNCHES, 0)
    if cfg.family == "ssm":
        n_slstm = cfg.n_layers // (cfg.mlstm_to_slstm + 1)
        want["slstm_scan"] = n_slstm * n_prefills
        want["slstm_scan_s1"] = n_slstm * n_steps
    else:
        n_attn = cfg.n_layers // cfg.n_mamba_per_super
        want["ssd_intra_chunk"] = cfg.n_layers * n_prefills
        want["flash_attention"] = n_attn * n_prefills
        want["decode_attention"] = n_attn * n_steps
    return want


def expected_ssd_shapes(cfg, prompts, ranks: int = 1) -> dict:
    """SSD launches by call shape (batch, chunks, L, heads) of one prefill
    of each prompt: a prompt of S tokens runs as chunks of L = min(chunk,
    S), padded to a multiple of L; one launch per Mamba2 block, on a
    rank's 1 / ``ranks`` of the heads."""
    want: dict = {}
    if cfg.family == "ssm":
        return want
    H = cfg.mamba_expand * cfg.d_model // cfg.mamba_head_dim // ranks
    for S in prompts:
        L = min(cfg.mamba_chunk, S)
        key = (1, -(-S // L), L, H)
        want[key] = want.get(key, 0) + cfg.n_layers
    return want


def _fresh_prefill(bundle, params, tokens, dev, frames=None):
    """The last-token logits of one prefill over ``tokens`` (after an
    encoder-decoder's audio ``frames``, where given)."""
    import torch

    cache = bundle.init_cache(1, -(-(len(tokens) + 1) // 8) * 8,
                              torch.float32, dev)
    batch = {"tokens": torch.tensor([tokens], dtype=torch.int32, device=dev)}
    if frames is not None:
        batch["audio_frames"] = torch.as_tensor(frames, device=dev)[None]
    logits, _ = bundle.prefill(params, batch, cache)
    return logits[0]


def _host_mem_gb() -> float:
    """The host's ``MemTotal`` (``/proc/meminfo``), in GB."""
    for line in Path("/proc/meminfo").read_text().splitlines():
        if line.startswith("MemTotal:"):
            return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


def _card_vs_cpu(dev, cfg, batch, cache_T, tag, label) -> None:
    """The same weights (seed 0, drawn on the card a leaf at a time, kept
    on the host) through the kernels on the card and through the plain
    versions on the CPU (which the CPU tests hold to the JAX package): a
    prefill of ``batch`` into a dense cache of cache_T, then 3 decode
    steps; fails past ``LOGIT_TOL``."""
    import torch

    from repro_torch.common.pytree import tree_map
    from repro_torch.models.api import build_model

    b = build_model(cfg, compute_dtype=torch.float32)
    p_cpu = b.init(torch.Generator(device=dev).manual_seed(SEED),
                   device="cpu")
    L = batch["tokens"].shape[1]
    outs = {}
    for device in ("cpu", dev):
        p = p_cpu if device == "cpu" else tree_map(lambda t: t.to(dev), p_cpu)
        cache = b.init_cache(1, cache_T, torch.float32, device)
        logits, cache = b.prefill(
            p, {k: v.to(device) for k, v in batch.items()}, cache)
        got = [logits.cpu()]
        for i in range(3):
            logits, cache = b.decode_step(
                p, torch.tensor([[i + 5]], dtype=torch.int32, device=device),
                cache, torch.tensor([L + i], dtype=torch.int32, device=device))
            got.append(logits.cpu())
        outs[str(device)] = got
        del p, cache
    worst = max(_err(a, c) for a, c in zip(outs["cpu"], outs[str(dev)]))
    ok = worst <= LOGIT_TOL
    log(f"[{tag}] {cfg.name} {label}, {b.param_count():,} parameters "
        f"({b.param_count() * 4 / 1e9:.2f} GB f32; host MemTotal "
        f"{_host_mem_gb():.1f} GB): card "
        f"(kernels) vs CPU (plain versions), prefill of {L} + 3 decode "
        f"steps: max |dlogit| {worst:.3e} (tol {LOGIT_TOL:g}) "
        f"{'ok' if ok else 'MISMATCH'}")
    if not ok:
        fail(f"{cfg.name} {label} on the card disagrees with the CPU")


def phase_recurrent_reference(dev, arch):
    """Card == CPU at full width with depth cut: a 130-token prefill (one
    full chunk and a ragged one) and 3 decode steps."""
    import torch

    from repro_torch.common.config import get_config

    cfg = get_config(arch).with_overrides(n_layers=REC_CUT[arch])
    toks = torch.randint(0, cfg.vocab_size, (1, 130),
                         generator=torch.Generator().manual_seed(SEED + 1),
                         dtype=torch.int32)
    _card_vs_cpu(dev, cfg, {"tokens": toks}, 136, "recurrent",
                 f"full width, {cfg.n_layers} layers")


def _profile_decode(arch, bundle, params, cache, L0, dev, steps=3):
    """Where a solo decode step's time goes: ``steps`` dense decode steps
    from position L0 under ``torch.profiler``; device busy = summed
    kernel time / wall time (a lower bound, as the profiler slows the
    host)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tok = torch.tensor([[1]], dtype=torch.int32, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            bundle.decode_step(params, tok, cache, torch.tensor(
                [L0 + i], dtype=torch.int32, device=dev))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        log(f"[profile] {arch}: the profiler saw no device kernels: "
            "device time not measured")
        return
    busy = sum(e.time_range.elapsed_us() for e in kern) / 1e6
    log(f"[profile] {arch}: {steps} decode steps under the profiler: "
        f"wall {1e3 * wall:.1f} ms, {len(kern) // steps} kernels per step, "
        f"device busy {1e3 * busy:.1f} ms ({100 * busy / wall:.1f}%)")
    by_name: dict[str, list[float]] = {}
    for e in kern:
        by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    for name, ts in sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:6]:
        log(f"[profile]   {sum(ts) / 1e3:8.2f} ms  {len(ts):6d} x  "
            f"{name[:90]}")


def phase_recurrent(dev) -> dict[str, dict]:
    """Each recurrent family at its published widths and depth through
    the port's serve entry point; returns each arch's main-path launches:
    by kernel and by call shape."""
    import gc

    import torch

    from repro_torch.common.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests, serve_arch

    counts = {}
    for arch in ("xlstm-1.3b", "zamba2-7b"):
        phase_recurrent_reference(dev, arch)
        cfg = get_config(arch)
        reqs = make_requests(cfg, len(REC_PROMPTS), REC_NEW,
                             prompt_lens=REC_PROMPTS, seed=SEED)
        logits: dict = {}
        # ---- the main path: counts from 0, serve_arch -> submit() ------
        ops.reset_launches()
        torch.cuda.synchronize()
        with record_logits(logits):
            run = serve_arch(cfg, reqs, device=dev)  # weights from seed 0
        torch.cuda.synchronize()
        launches = dict(ops.LAUNCHES)
        shapes = f32_shapes()
        ssd_shapes = shapes["ssd_intra_chunk"]
        log(f"[recurrent] {arch} launches by call shape: "
            f"{ {k: v for k, v in shapes.items() if v} }")
        rt = next(iter(run.engine.decoders.values()))
        bundle, params = rt.bundle, rt.params
        n = bundle.param_count()
        log(f"[recurrent] {arch}: {n:,} parameters ({n * 4 / 1e9:.2f} GB "
            f"f32), {cfg.n_layers} layers, d_model {cfg.d_model}; served "
            f"{len(reqs)} requests (prompts {list(REC_PROMPTS)}, "
            f"{REC_NEW} new tokens) through serve_arch -> "
            f"Deployment.submit() in {run.seconds:.3f} s")

        steps = 0
        for r, req in zip(run.results, reqs):
            lg = torch.stack(logits[r.rid])
            if len(r.output) != REC_NEW or len(lg) != REC_NEW:
                fail(f"{arch} rid {r.rid}: {len(r.output)} tokens, "
                     f"{len(lg)} logit rows")
            if not bool(torch.isfinite(lg).all()):
                fail(f"{arch} rid {r.rid}: non-finite logits")
            steps += len(r.output) - 1
            # decode == prefill: step k's logits against a fresh prefill
            # of prompt + the first k tokens (its last token at position
            # len(prompt) + k - 1); the 126-token prompt's steps 1-3 reach
            # positions 126-128, across the 128-token chunk boundary
            toks = [int(t) for t in r.output]
            ks = (1, 2, 3) if len(req.prompt) == 126 else (1,)
            worst = 0.0
            for k in ks:
                fresh = _fresh_prefill(bundle, params,
                                       list(req.prompt) + toks[:k], dev)
                worst = max(worst, _err(fresh, lg[k]))
            top2 = lg.topk(2, dim=-1).values
            gaps = top2[:, 0] - top2[:, 1]
            ok = worst <= DECODE_TOL
            log(f"[recurrent] {arch} rid {r.rid} prompt {len(req.prompt)}: "
                f"tokens {toks}; decode step(s) {list(ks)} (positions "
                f"{[len(req.prompt) + k - 1 for k in ks]}) vs fresh prefill "
                f"max |dlogit| {worst:.3e} (tol {DECODE_TOL:g}) "
                f"{'ok' if ok else 'MISMATCH'}; |logit| up to "
                f"{lg.abs().max().item():.3f}, top-2 gap "
                f"{gaps.min().item():.3e}..{gaps.max().item():.3e}")
            if not ok:
                fail(f"{arch} rid {r.rid}: decode disagrees with prefill")

        want = expected_launches(cfg, len(reqs), steps)
        log(f"[recurrent] {arch} kernel launches {launches}, expected {want}")
        if launches != want:
            fail(f"{arch}: kernel launches {launches} != expected {want}")
        want_ssd = expected_ssd_shapes(cfg, REC_PROMPTS)
        log(f"[recurrent] {arch} SSD launches by (B, nc, L, H) {ssd_shapes}, "
            f"expected {want_ssd}")
        if ssd_shapes != want_ssd:
            fail(f"{arch}: SSD launches {ssd_shapes} != expected {want_ssd}")
        counts[arch] = {"launches": launches, "shapes": shapes}

        # prefill time of the longest prompt (warm), decode rate of the run
        batch = {"tokens": torch.tensor([reqs[-1].prompt], dtype=torch.int32,
                                        device=dev)}
        cache = bundle.init_cache(1, S_REC + 8, torch.float32, dev)
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            bundle.prefill(params, batch, cache)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        _profile_decode(arch, bundle, params, cache, S_REC, dev)
        decode_s = sum(s.t1 - s.t0 for r in run.results for s in r.timeline
                       if s.phase == "decode")
        log(f"[recurrent] {arch}: prefill of {S_REC} tokens "
            f"{1e3 * min(times):.1f} ms (best of 3, warm; "
            f"{', '.join(f'{1e3 * t:.1f}' for t in times)}); solo decode "
            f"{steps} steps in {decode_s:.3f} s, {steps / decode_s:.1f} "
            f"tokens/s ({1e3 * decode_s / steps:.2f} ms per token); peak "
            f"device memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        del run, rt, bundle, params, cache, logits
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return counts


# --------------------------------------------------------------------------
# phase 6: the paper's multi-task scenario (mini-clip towers)
# --------------------------------------------------------------------------

def phase_scenario(dev) -> dict:
    """``repro_torch.examples.multi_task_serving`` on the card: retrieval,
    classification and VQA on the shared mini-clip towers through plan,
    materialize, verify, simulate + submit, split == monolithic, a
    9-request serve() burst with cross-task batches, the SLO rows, the
    trace, compare() and evict + replan.  Before it, the towers through
    the flash kernel on the card against the plain versions on the CPU.
    Returns the main-path launches: by kernel and by call shape."""
    import tempfile

    import torch

    from repro_torch.common.pytree import tree_map
    from repro_torch.configs.s2m3_zoo import get_clip_config
    from repro_torch.examples import multi_task_serving as ex
    from repro_torch.kernels import ops
    from repro_torch.models import clip as C
    from repro_torch.serving.engine import S2M3Engine

    ccfg = get_clip_config(CLIP)
    patches, ids = ex.make_inputs(ccfg)
    p_cpu = C.init_clip(torch.Generator().manual_seed(SEED), ccfg, "cpu")
    p_cpu["logit_scale"] = torch.tensor(2.0)      # exercise exp(scale)
    p_dev = tree_map(lambda t: t.to(dev), p_cpu)
    x_cpu = (torch.from_numpy(patches), torch.from_numpy(ids))
    x_dev = tuple(t.to(dev) for t in x_cpu)
    for what, fn in (
            ("encode_image", lambda p, x: C.encode_image(p["vision"], x[0],
                                                        ccfg)),
            ("encode_text", lambda p, x: C.encode_text(p["text"], x[1], ccfg)),
            ("clip_forward", lambda p, x: C.clip_forward(p, *x, ccfg))):
        err = _err(fn(p_dev, x_dev).cpu(), fn(p_cpu, x_cpu))
        ok = err <= LOGIT_TOL
        log(f"[scenario] {CLIP} {what}: card (flash kernel) vs CPU (plain "
            f"version) max |diff| {err:.3e} (tol {LOGIT_TOL:g}) "
            f"{'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{CLIP} {what} on the card disagrees with the CPU")

    # ---- the main path: counts from 0, the whole scenario ---------------
    # the engine's module calls, by module, counted around apply_module
    module_calls: dict = {}
    apply_module = S2M3Engine.apply_module

    def counted(self, module_name, *args, **kw):
        module_calls[module_name] = module_calls.get(module_name, 0) + 1
        return apply_module(self, module_name, *args, **kw)

    ops.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    S2M3Engine.apply_module = counted
    try:
        with tempfile.TemporaryDirectory() as tmp:
            trace_path = Path(tmp) / "multi_task_trace.json"
            out = ex.main(device=dev, trace_path=trace_path)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = dict(ops.LAUNCHES)
            shapes = f32_shapes()
            trace_bytes = trace_path.stat().st_size
    finally:
        S2M3Engine.apply_module = apply_module
    dep = out["deployment"]

    # the CPU test's checks (tests/test_torch_clip.py)
    for sim, real in out["routes"]:
        if sim != real:
            fail(f"scenario: simulated route {sim} != real {real}")
    if out["verify"] != []:
        fail(f"scenario: verify() found {out['verify']}")
    if out["tampered_finding"].code != "plan/memory-overflow":
        fail(f"scenario: tampered ledger gave {out['tampered_finding']}")
    if out["split_diff"] != 0.0:
        fail(f"scenario: split != monolithic by {out['split_diff']:.3e}")
    if out["batched_diff"] > LOGIT_TOL:
        fail(f"scenario: batched != solo by {out['batched_diff']:.3e}")
    if out["cross_task_batches"] < 1:
        fail("scenario: no cross-task encoder batch")
    if [r["model"] for r in out["slo"]] != ["classify", "retrieval", "vqa"] \
            or any(r["requests"] != 3 for r in out["slo"]):
        fail(f"scenario: SLO rows {out['slo']}")
    drift = out["drift"]
    if drift.n_route_divergences != 0 or drift.routes_checked == 0:
        fail(f"scenario: compare() {drift.summary()}")
    if trace_bytes == 0:
        fail("scenario: empty trace file")
    if out["evicted"] != ["mini-lm"] or \
            "dev0" in out["after_replan"].devices.values():
        fail(f"scenario: evict {out['evicted']}, after replan "
             f"{out['after_replan'].devices}")
    # exact launches: each tower call runs one flash kernel a layer (the
    # towers' calls through apply_module; main() adds one monolithic pass);
    # the vision tower's are the non-causal calls over its patches, the
    # text tower's the causal ones over its tokens
    calls = {m: module_calls.get(m, 0) + 1 for m in ("mini-vit", "mini-trf")}
    want_tower = {"vision": ccfg.vision_layers * calls["mini-vit"],
                  "text": ccfg.text_layers * calls["mini-trf"]}
    tower_of = {(CLIP_PATCHES, False): "vision", (CLIP_TEXT, True): "text"}
    by_tower = dict.fromkeys(want_tower, 0)
    for (_, S_, T_, H_, K_, D_, causal, window), n in shapes[
            "flash_attention"].items():
        tower = tower_of.get((S_, causal))
        if tower is None or (T_, H_, K_, D_, window) != (
                S_, CLIP_HEADS, CLIP_HEADS, CLIP_D, 0):
            fail(f"scenario: flash at no tower's shape {S_, T_, H_, K_, D_}")
        by_tower[tower] += n
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["flash_attention"] = sum(want_tower.values())
    log(f"[scenario] {CLIP} on {dev}: routes == simulate(), verify() clean, "
        f"tampered ledger -> {out['tampered_finding'].code}, split == "
        f"monolithic (max |diff| {out['split_diff']:.1e}), batched vs solo "
        f"{out['batched_diff']:.3e}, {out['cross_task_batches']} cross-task "
        f"batches, compare() {drift.routes_checked} routes / "
        f"{drift.n_route_divergences} divergences, trace {trace_bytes} B, "
        f"evict + replan ok; {seconds:.3f} s")
    log(f"[scenario] tower calls {calls} (x {ccfg.vision_layers} / "
        f"{ccfg.text_layers} layers); kernel launches {launches}, expected "
        f"{want}; flash by tower {by_tower}, expected {want_tower}; by "
        f"shape {shapes['flash_attention']}")
    if launches != want or by_tower != want_tower:
        fail(f"scenario: kernel launches {launches}, by tower {by_tower} != "
             f"expected {want}, {want_tower}")
    return {"launches": launches, "shapes": shapes}


# --------------------------------------------------------------------------
# phase 7: tinyllama-1.1b and whisper-tiny at full width
# --------------------------------------------------------------------------

def _decode_vs_prefill(arch, bundle, params, reqs, results, logits, dev,
                       ks, frames_of=None, tag="phase7") -> list[int]:
    """Step k's logits against a fresh prefill of the prompt and the first
    k tokens, for each k in ``ks``; returns each request's decode steps."""
    import torch

    steps = []
    for req, r in zip(reqs, results):
        lg = torch.stack(logits[r.rid])
        toks = [int(t) for t in r.output]
        if len(toks) != len(lg) or not bool(torch.isfinite(lg).all()):
            fail(f"{arch} rid {r.rid}: {len(toks)} tokens, {len(lg)} finite "
                 "logit rows expected")
        steps.append(len(toks) - 1)
        frames = None if frames_of is None else frames_of(req)
        worst = max(_err(_fresh_prefill(bundle, params,
                                        list(req.prompt) + toks[:k], dev,
                                        frames), lg[k])
                    for k in ks if k < len(toks))
        ok = worst <= DECODE_TOL
        log(f"[{tag}] {arch} rid {r.rid} prompt {len(req.prompt)}: tokens "
            f"{toks}; decode steps {list(ks)} vs fresh prefill max |dlogit| "
            f"{worst:.3e} (tol {DECODE_TOL:g}) {'ok' if ok else 'MISMATCH'}")
        if not ok:
            fail(f"{arch} rid {r.rid}: decode disagrees with prefill")
    return steps


def _prefill_ms(bundle, params, batch, T, dev):
    """Three warm prefills of ``batch`` into one dense cache of T: their
    times (ms) and the filled cache."""
    import torch

    cache = bundle.init_cache(1, T, torch.float32, dev)
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        bundle.prefill(params, batch, cache)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return times, cache


def phase_tinyllama(dev) -> dict:
    """tinyllama-1.1b at its published width and depth (22 layers, random
    float32 weights from seed 0) through ``launch.serve.serve_arch``: 6
    greedy requests through the paged scheduler (serve()), then each
    again through the solo path (submit()).  Checked: tokens and every
    step's logits serve == submit, decode == a fresh prefill, exact
    launches, by kernel and by call shape (each prefill's flash at its
    prompt, each solo step's decode at its request's cache, each tick's
    paged decode at the pool's table); before it, card == CPU at full
    width with 2 layers.  Returns the main-path launches: by kernel and
    by call shape."""
    import numpy as np
    import torch

    from repro_torch.common.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests, serve_arch

    cfg = get_config(TL_ARCH)
    g = torch.Generator().manual_seed(SEED + 1)
    _card_vs_cpu(dev, cfg.with_overrides(n_layers=2),
                 {"tokens": torch.randint(0, cfg.vocab_size, (1, 9),
                                          generator=g, dtype=torch.int32)},
                 32, "phase7", "full width, 2 layers")

    lens = prompt_lens(TL_PROMPTS, TL_REQS)
    reqs = make_requests(cfg, TL_REQS, TL_NEW, prompt_lens=lens, seed=SEED)
    served, solo = {}, {}
    # ---- the main path: counts from 0, serve(), then submit() ----------
    ops.reset_launches()
    torch.cuda.synchronize()
    with record_logits(served):
        run = serve_arch(cfg, reqs, device=dev, max_batch=TL_ROWS,
                         cache_len=TL_CACHE)
    rt = next(iter(run.engine.decoders.values()))
    t_submit = time.perf_counter()
    with record_logits(solo):
        solo_res = {r.rid: run.engine.generate(r) for r in reqs}
    torch.cuda.synchronize()
    t_submit = time.perf_counter() - t_submit
    launches = dict(ops.LAUNCHES)
    shapes = f32_shapes()
    n = rt.bundle.param_count()
    log(f"[phase7] {TL_ARCH}: {n:,} parameters ({n * 4 / 1e9:.2f} GB f32), "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, H {cfg.n_heads}, K "
        f"{cfg.n_kv_heads}; serve() of {len(reqs)} requests (prompts "
        f"{lens}, {TL_NEW} new tokens) in {run.seconds:.3f} s, submit() x"
        f"{len(reqs)} in {t_submit:.3f} s")

    for r in run.results:
        a, b = np.asarray(r.output), np.asarray(solo_res[r.rid].output)
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"{TL_ARCH} rid {r.rid}: serve tokens {a.tolist()} != "
                 f"submit {b.tolist()}")
        dlogit = _err(torch.stack(served[r.rid]), torch.stack(solo[r.rid]))
        log(f"[phase7] {TL_ARCH} rid {r.rid}: serve == submit over {len(a)} "
            f"tokens, max |dlogit| {dlogit:.3e} (tol {LOGIT_TOL:g})")
        if dlogit > LOGIT_TOL:
            fail(f"{TL_ARCH} rid {r.rid}: serve logits differ from submit's "
                 f"by {dlogit:.3e}")
    req_steps = _decode_vs_prefill(TL_ARCH, rt.bundle, rt.params, reqs,
                                   [solo_res[r.rid] for r in reqs], solo,
                                   dev, (1, TL_NEW - 1))
    steps = sum(req_steps)
    n_l, hkd = cfg.n_layers, (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update({"flash_attention": 2 * len(reqs) * n_l,
                 "paged_decode_attention": run.decode_steps * n_l,
                 "decode_attention": steps * n_l})
    # by shape: serve() and submit() each prefill a prompt once, one
    # flash a layer; each solo step decodes over its request's cache;
    # every tick decodes the pool's rows through one table width
    want_shapes = {k: {} for k in ops.SHAPE_LAUNCHES}
    for S_, n_steps in zip(lens, req_steps):
        for kernel, key, n in (
                ("flash_attention", (1, S_, S_, *hkd, True, 0), 2 * n_l),
                ("decode_attention", (1, dense_T(S_, TL_NEW), *hkd, 0),
                 n_steps * n_l)):
            want_shapes[kernel][key] = want_shapes[kernel].get(key, 0) + n
    want_shapes["paged_decode_attention"] = {
        (TL_ROWS, TL_NMAX, PAGE, *hkd, 0): run.decode_steps * n_l}
    log(f"[phase7] {TL_ARCH} kernel launches {launches}, expected {want}; "
        f"by shape {shapes}, expected {want_shapes}")
    if launches != want or shapes != want_shapes:
        fail(f"{TL_ARCH}: kernel launches {launches}, by shape {shapes} != "
             f"expected {want}, {want_shapes}")
    _graph_vs_eager("phase7", TL_ARCH, lambda: _graph_run(serve_arch(
        cfg, reqs, device=dev, params=rt.params, max_batch=TL_ROWS,
        cache_len=TL_CACHE)), {r.rid: r.output for r in run.results}, n_l)

    # rates: the serve() ticks, the solo decode spans, a warm prefill
    trace = run.scheduler.tracer.trace
    ticks, ttft = {}, []
    for r in reqs:
        spans = trace.spans_for(r.rid)
        root = trace.tree(r.rid)
        ttft.append(next(s for s in spans if s.phase == "prefill").t1 - root.t0)
        for s in spans:
            if s.phase == "decode_tick":
                ticks[(s.t0, s.t1)] = s.t1 - s.t0
    stats = run.scheduler.stats_dict()[cfg.name]
    decode_s = sum(ticks.values())
    solo_s = sum(s.t1 - s.t0 for r in solo_res.values() for s in r.timeline
                 if s.phase == "decode")
    batch = {"tokens": torch.tensor([reqs[int(np.argmax(lens))].prompt],
                                    dtype=torch.int32, device=dev)}
    pre, cache = _prefill_ms(rt.bundle, rt.params, batch,
                             dense_T(max(lens), TL_NEW), dev)
    _profile_decode(TL_ARCH, rt.bundle, rt.params, cache, max(lens), dev)
    log(f"[phase7] {TL_ARCH}: prefill of {max(lens)} tokens "
        f"{min(pre):.1f} ms (best of 3, warm; {', '.join(f'{t:.1f}' for t in pre)}); "
        f"TTFT mean {1e3 * np.mean(ttft):.1f} ms, max {1e3 * max(ttft):.1f} "
        f"ms; serve() decode {stats['decode_tokens']} tokens over "
        f"{len(ticks)} ticks, {stats['decode_tokens'] / decode_s:.1f} "
        f"tokens/s, {1e3 * decode_s / len(ticks):.2f} ms per tick; solo "
        f"decode {steps} steps, {steps / solo_s:.1f} tokens/s "
        f"({1e3 * solo_s / steps:.2f} ms per token)")
    return {"launches": launches, "shapes": shapes}


def _graph_run(run):
    """A ``serve_arch`` run as ``_graph_vs_eager`` takes it."""
    return run.results, next(iter(run.scheduler.decode.values()))


def phase_whisper(dev) -> dict:
    """whisper-tiny at its published width and depth (4 + 4 layers,
    1500 encoder frames, random float32 weights from seed 0) through
    ``launch.serve.serve_arch`` (solo prefill and dense decode per
    request through ``Deployment.submit()``).  Checked: card == CPU at
    full depth, decode == a fresh prefill (frames included), exact
    launches: 12 flash a prefill (4 encoder, 4 self, 4 cross) and 8
    decode a step (4 self, 4 cross), each counted at its call shape.
    Returns the main-path launches: by kernel and by call shape."""
    import torch

    from repro_torch.common.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests, serve_arch

    cfg = get_config(W_ARCH)
    lens = prompt_lens(W_PROMPTS, W_REQS)
    reqs = make_requests(cfg, W_REQS, W_NEW, prompt_lens=lens, seed=SEED)
    _card_vs_cpu(dev, cfg, {"tokens": torch.tensor([reqs[0].prompt],
                                                   dtype=torch.int32),
                            "audio_frames": torch.from_numpy(
                                reqs[0].inputs["audio"])[None]},
                 32, "phase7", "full width and depth")

    logits: dict = {}
    # ---- the main path: counts from 0, serve_arch -> submit() ----------
    ops.reset_launches()
    torch.cuda.synchronize()
    with record_logits(logits):
        run = serve_arch(cfg, reqs, device=dev)
    launches = dict(ops.LAUNCHES)
    shapes = f32_shapes()
    rt = next(iter(run.engine.decoders.values()))
    n = rt.bundle.param_count()
    log(f"[phase7] {W_ARCH}: {n:,} parameters ({n * 4 / 1e6:.1f} MB f32), "
        f"{cfg.n_encoder_layers} + {cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim}, "
        f"{cfg.encoder_seq} frames; served {len(reqs)} requests (prompts "
        f"{lens}, {W_NEW} new tokens) through serve_arch -> "
        f"Deployment.submit() in {run.seconds:.3f} s")
    req_steps = _decode_vs_prefill(W_ARCH, rt.bundle, rt.params, reqs,
                                   run.results, logits, dev, (1, W_NEW - 1),
                                   frames_of=lambda q: q.inputs["audio"])
    steps = sum(req_steps)
    n_l, hkd = cfg.n_layers, (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    T_enc = cfg.encoder_seq
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update({"flash_attention": (cfg.n_encoder_layers + 2 * n_l)
                 * len(reqs),
                 "decode_attention": 2 * n_l * steps})
    # by shape: a prefill runs the encoder (S = T = frames, non-causal),
    # then a layer's self (causal, over the prompt) and cross (the
    # prompt against the frames) flash; a step a layer's self decode
    # over its request's cache and its cross decode over the frames
    want_shapes = {k: {} for k in ops.SHAPE_LAUNCHES}
    for S_, n_steps in zip(lens, req_steps):
        for kernel, key, n in (
                ("flash_attention", (1, T_enc, T_enc, *hkd, False, 0),
                 cfg.n_encoder_layers),
                ("flash_attention", (1, S_, S_, *hkd, True, 0), n_l),
                ("flash_attention", (1, S_, T_enc, *hkd, False, 0), n_l),
                ("decode_attention", (1, dense_T(S_, W_NEW), *hkd, 0),
                 n_steps * n_l),
                ("decode_attention", (1, T_enc, *hkd, 0), n_steps * n_l)):
            want_shapes[kernel][key] = want_shapes[kernel].get(key, 0) + n
    log(f"[phase7] {W_ARCH} kernel launches {launches}, expected {want}; "
        f"by shape {shapes}, expected {want_shapes}")
    if launches != want or shapes != want_shapes:
        fail(f"{W_ARCH}: kernel launches {launches}, by shape {shapes} != "
             f"expected {want}, {want_shapes}")
    pre_s = [s.t1 - s.t0 for r in run.results for s in r.timeline
             if s.phase == "prefill"]
    solo_s = sum(s.t1 - s.t0 for r in run.results for s in r.timeline
                 if s.phase == "decode")
    batch = {"tokens": torch.tensor([reqs[0].prompt], dtype=torch.int32,
                                    device=dev),
             "audio_frames": torch.from_numpy(reqs[0].inputs["audio"]
                                              ).to(dev)[None]}
    pre, cache = _prefill_ms(rt.bundle, rt.params, batch, 32, dev)
    _profile_decode(W_ARCH, rt.bundle, rt.params, cache,
                    len(reqs[0].prompt), dev)
    log(f"[phase7] {W_ARCH}: prefill ({cfg.encoder_seq} frames + "
        f"{len(reqs[0].prompt)} "
        f"tokens) {min(pre):.1f} ms (best of 3, warm; "
        f"{', '.join(f'{t:.1f}' for t in pre)}; in submit() "
        f"{', '.join(f'{1e3 * t:.1f}' for t in pre_s)}); solo decode {steps} "
        f"steps, {steps / solo_s:.1f} tokens/s ({1e3 * solo_s / steps:.2f} "
        "ms per token)")
    return {"launches": launches, "shapes": shapes}


# --------------------------------------------------------------------------
# phase 8: gemma2-9b, llama3-8b, granite-moe-3b-a800m at full width
# --------------------------------------------------------------------------

def _family_expected(cfg, lens, req_steps, ticks, cache_len):
    """Exact launches of phase 8's main path, by kernel and by call shape:
    serve() and submit() each prefill a prompt once (one flash a layer at
    its prompt length), each solo step decodes over its request's dense
    cache, each tick over the pool's tables; a local layer's calls carry
    the window, a global one's 0."""
    from repro_torch.kernels import ops

    H_, K_, D_ = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pat = cfg.attn_pattern or ("global",)
    per = len(pat)
    windows = {}
    for kind in pat:
        w = cfg.sliding_window if kind == "local" else 0
        windows[w] = windows.get(w, 0) + cfg.n_layers // per
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want.update({"flash_attention": 2 * len(lens) * cfg.n_layers,
                 "decode_attention": sum(req_steps) * cfg.n_layers,
                 "paged_decode_attention": ticks * cfg.n_layers})
    shapes = {k: {} for k in ops.SHAPE_LAUNCHES}

    def add(kernel, key, n):
        shapes[kernel][key] = shapes[kernel].get(key, 0) + n

    for w, n_l in windows.items():
        for S_, n_steps in zip(lens, req_steps):
            add("flash_attention", (1, S_, S_, H_, K_, D_, True, w), 2 * n_l)
            add("decode_attention", (1, dense_T(S_, FAM_NEW), H_, K_, D_, w),
                n_steps * n_l)
        add("paged_decode_attention",
            (FAM_ROWS, cache_len // PAGE, PAGE, H_, K_, D_, w), ticks * n_l)
    return want, shapes


def phase_family(dev, cfg, cpu_layers=2, tag="phase8") -> dict:
    """An attention family at its published width (random float32
    weights from seed 0) through ``launch.serve.serve_arch``: phase 8's
    gemma2-9b, llama3-8b and granite-moe-3b-a800m and phase 9's
    llama3-405b at a cut depth (``cfg``'s).  Its requests go through
    the paged scheduler (serve()), then each through the solo path
    (submit()).  Checked: tokens and every step's logits serve ==
    submit, decode == a fresh prefill (gemma2's long request at
    positions past its window), exact launches by kernel and by call
    shape (local and global apart); before it, card == CPU at full width
    with ``cpu_layers`` layers.  Prints the prefill time, serve() and
    solo rates, device busy over 3 decode steps and the peak device
    memory.  Returns the main-path launches: by kernel and by call
    shape."""
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests, serve_arch

    arch = cfg.name
    g = torch.Generator().manual_seed(SEED + 1)
    _card_vs_cpu(dev, cfg.with_overrides(n_layers=cpu_layers),
                 {"tokens": torch.randint(0, cfg.vocab_size, (1, 9),
                                          generator=g, dtype=torch.int32)},
                 32, tag, f"full width, {cpu_layers} layers")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    lens = fam_prompts(arch)
    cache_len = FAM_CACHE[arch]
    reqs = make_requests(cfg, len(lens), FAM_NEW, prompt_lens=lens,
                         seed=SEED)
    served, solo = {}, {}
    # ---- the main path: counts from 0, serve(), then submit() ----------
    ops.reset_launches()
    torch.cuda.synchronize()
    with record_logits(served):
        run = serve_arch(cfg, reqs, device=dev, max_batch=FAM_ROWS,
                         cache_len=cache_len)
    rt = next(iter(run.engine.decoders.values()))
    t_submit = time.perf_counter()
    with record_logits(solo):
        solo_res = {r.rid: run.engine.generate(r) for r in reqs}
    torch.cuda.synchronize()
    t_submit = time.perf_counter() - t_submit
    launches = dict(ops.LAUNCHES)
    shapes = f32_shapes()
    n = rt.bundle.param_count()
    log(f"[{tag}] {arch}: {n:,} parameters ({n * 4 / 1e9:.2f} GB f32), "
        f"{cfg.n_layers} layers, d_model {cfg.d_model}, H {cfg.n_heads}, K "
        f"{cfg.n_kv_heads}, head dim {cfg.head_dim}"
        + (f", window {cfg.sliding_window} on its local layers"
           if cfg.attn_pattern else "")
        + (f", {cfg.n_experts} experts (padded to {cfg.expert_pad_to}) "
           f"top-{cfg.experts_top_k}" if cfg.family == "moe" else "")
        + f"; serve() of {len(reqs)} requests (prompts {lens}, {FAM_NEW} "
        f"new tokens, rows of {cache_len}) in {run.seconds:.3f} s, submit() "
        f"x{len(reqs)} in {t_submit:.3f} s")

    for req, r in zip(reqs, run.results, strict=True):
        a, b = np.asarray(r.output), np.asarray(solo_res[r.rid].output)
        if a.shape != b.shape or not np.array_equal(a, b):
            fail(f"{arch} rid {r.rid}: serve tokens {a.tolist()} != "
                 f"submit {b.tolist()}")
        lg_a, lg_b = torch.stack(served[r.rid]), torch.stack(solo[r.rid])
        if not bool(torch.isfinite(lg_b).all()):
            fail(f"{arch} rid {r.rid}: non-finite logits")
        dlogit = _err(lg_a, lg_b)
        log(f"[{tag}] {arch} rid {r.rid} prompt {len(req.prompt)}: "
            f"serve == submit over {len(a)} tokens, max |dlogit| "
            f"{dlogit:.3e} (tol {LOGIT_TOL:g}; |logit| up to "
            f"{lg_b.abs().max().item():.3f})")
        if dlogit > LOGIT_TOL:
            fail(f"{arch} rid {r.rid}: serve logits differ from submit's by "
                 f"{dlogit:.3e}")
    req_steps = _decode_vs_prefill(arch, rt.bundle, rt.params, reqs,
                                   [solo_res[r.rid] for r in reqs], solo,
                                   dev, (1, FAM_NEW - 1), tag=tag)
    want, want_shapes = _family_expected(cfg, lens, req_steps,
                                         run.decode_steps, cache_len)
    log(f"[{tag}] {arch} kernel launches {launches}, expected {want}; "
        f"by shape {shapes}, expected {want_shapes}")
    if launches != want or shapes != want_shapes:
        fail(f"{arch}: kernel launches {launches}, by shape {shapes} != "
             f"expected {want}, {want_shapes}")

    # rates: the serve() ticks, the solo decode spans, a warm prefill
    trace = run.scheduler.tracer.trace
    ticks, ttft = {}, []
    for r in reqs:
        spans = trace.spans_for(r.rid)
        ttft.append(next(s for s in spans if s.phase == "prefill").t1
                    - trace.tree(r.rid).t0)
        for sp in spans:
            if sp.phase == "decode_tick":
                ticks[(sp.t0, sp.t1)] = sp.t1 - sp.t0
    stats = run.scheduler.stats_dict()[cfg.name]
    decode_s = sum(ticks.values())
    steps = sum(req_steps)
    solo_s = sum(sp.t1 - sp.t0 for r in solo_res.values()
                 for sp in r.timeline if sp.phase == "decode")
    longest = reqs[int(np.argmax(lens))]
    batch = {"tokens": torch.tensor([longest.prompt], dtype=torch.int32,
                                    device=dev)}
    pre, cache = _prefill_ms(rt.bundle, rt.params, batch,
                             dense_T(max(lens), FAM_NEW), dev)
    _profile_decode(arch, rt.bundle, rt.params, cache, max(lens), dev)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"[{tag}] {arch}: prefill of {max(lens)} tokens {min(pre):.1f} ms "
        f"(best of 3, warm; {', '.join(f'{t:.1f}' for t in pre)}); TTFT "
        f"mean {1e3 * np.mean(ttft):.1f} ms, max {1e3 * max(ttft):.1f} ms; "
        f"serve() decode {stats['decode_tokens']} tokens over {len(ticks)} "
        f"ticks, {stats['decode_tokens'] / decode_s:.1f} tokens/s, "
        f"{1e3 * decode_s / len(ticks):.2f} ms per tick; solo decode "
        f"{steps} steps, {steps / solo_s:.1f} tokens/s "
        f"({1e3 * solo_s / steps:.2f} ms per token; weight-read floor "
        f"{n * 4 / hbm_bytes_s() * 1e3:.2f} ms); peak device memory "
        f"{peak:.1f} GB")
    _graph_vs_eager(tag, arch, lambda: _graph_run(serve_arch(
        cfg, reqs, device=dev, params=rt.params, max_batch=FAM_ROWS,
        cache_len=cache_len)), {r.rid: r.output for r in run.results},
        cfg.n_layers)
    del run, rt, cache, served, solo, solo_res
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return {"launches": launches, "shapes": shapes}


def phase_deepseek(dev) -> dict:
    """deepseek-v3-671b at its published width with depth cut to one
    dense and one MoE layer (random float32 weights from seed 0) through
    ``launch.serve.serve_arch``: MLA's latent cache pages, so the
    requests go through the paged scheduler (serve(): the absorbed
    decode through ``paged_mla_decode``), then each through the solo
    path (submit(): the dense latent cache, plain products).  Checked:
    tokens and every step's logits serve == submit, finite logits,
    decode == a fresh prefill at steps 1 and FAM_NEW - 1, exact launches
    (``paged_mla_decode`` once a layer a tick, at the tick's call shape;
    no other kernel), the tick's CUDA graph == the eager ticks, and the
    peak device memory below the weights plus one expert leaf (the dense
    MoE reads each expert leaf in place); before it, card == CPU at full
    width with 2 layers and DS_CPU_EXPERTS of the 256 experts.  Prints
    the prefill time, serve() and solo tokens/s beside the weight-read
    floor, the latent cache's bytes a token, device busy over 3 decode
    steps and the peak."""
    import gc

    import numpy as np
    import torch

    from repro_torch.common.config import get_config
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests, serve_arch
    from repro_torch.layers.initializers import spec_param_count
    from repro_torch.models.api import build_model

    cfg = get_config(DS_ARCH).with_overrides(**DS_CUT)
    g = torch.Generator().manual_seed(SEED + 1)
    ops.reset_launches()
    _card_vs_cpu(dev, cfg.with_overrides(n_experts=DS_CPU_EXPERTS),
                 {"tokens": torch.randint(0, cfg.vocab_size, (1, 9),
                                          generator=g, dtype=torch.int32)},
                 32, "phase9",
                 f"full width, {cfg.n_layers} layers, {DS_CPU_EXPERTS} of "
                 f"{cfg.n_experts} experts (a cut for the host)")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    lens = prompt_lens(FAM_PROMPTS, FAM_REQS)
    cache_len = FAM_CACHE[L405_ARCH]
    reqs = make_requests(cfg, len(lens), FAM_NEW, prompt_lens=lens,
                         seed=SEED)
    served, solo = {}, {}
    ops.reset_launches()
    with record_logits(served):
        run = serve_arch(cfg, reqs, device=dev, max_batch=FAM_ROWS,
                         cache_len=cache_len)
    if run.scheduler is None:
        fail(f"{DS_ARCH}: served solo; MLA's latent cache pages")
    rt = next(iter(run.engine.decoders.values()))
    b = rt.bundle
    t_submit = time.perf_counter()
    with record_logits(solo):
        solo_res = {r.rid: run.engine.generate(r) for r in reqs}
    torch.cuda.synchronize()
    t_submit = time.perf_counter() - t_submit
    launches = dict(ops.LAUNCHES)
    shapes = f32_shapes()
    n = b.param_count()
    n_mtp = spec_param_count(b.specs["mtp"])
    n_embed = spec_param_count(b.specs["embed"])
    leaf = b.specs["stages"]["moe"]["blocks"]["moe"]["wi_gate"]
    leaf_bytes = 4 * int(np.prod(leaf.shape[1:]))
    log(f"[phase9] {DS_ARCH}: {n:,} parameters ({n * 4 / 1e9:.2f} GB f32; "
        f"the full model "
        f"{build_model(get_config(DS_ARCH)).param_count():,}), "
        f"{cfg.n_layers} "
        f"layers ({cfg.first_dense_layers} dense), d_model {cfg.d_model}, "
        f"H {cfg.n_heads}, q_lora {cfg.q_lora_rank}, kv_lora "
        f"{cfg.kv_lora_rank}, qk {cfg.qk_nope_dim} + {cfg.qk_rope_dim}, v "
        f"{cfg.v_head_dim}, {cfg.n_experts} experts of {cfg.moe_d_ff} "
        f"top-{cfg.experts_top_k} + {cfg.n_shared_experts} shared, dense "
        f"d_ff {cfg.dense_d_ff}, MTP weights {n_mtp:,} (carried, not run); "
        f"serve() of {len(reqs)} requests (prompts {lens}, {FAM_NEW} new "
        f"tokens, rows of {cache_len}) in {run.seconds:.3f} s, submit() "
        f"x{len(reqs)} in {t_submit:.3f} s")
    for req, r in zip(reqs, run.results, strict=True):
        a_, b_ = np.asarray(r.output), np.asarray(solo_res[r.rid].output)
        if a_.shape != b_.shape or not np.array_equal(a_, b_):
            fail(f"{DS_ARCH} rid {r.rid}: serve tokens {a_.tolist()} != "
                 f"submit {b_.tolist()}")
        lg_a, lg_b = torch.stack(served[r.rid]), torch.stack(solo[r.rid])
        if not bool(torch.isfinite(lg_b).all()):
            fail(f"{DS_ARCH} rid {r.rid}: non-finite logits")
        dlogit = _err(lg_a, lg_b)
        log(f"[phase9] {DS_ARCH} rid {r.rid} prompt {len(req.prompt)}: "
            f"serve == submit over {len(a_)} tokens, max |dlogit| "
            f"{dlogit:.3e} (tol {LOGIT_TOL:g}; |logit| up to "
            f"{lg_b.abs().max().item():.3f})")
        if dlogit > LOGIT_TOL:
            fail(f"{DS_ARCH} rid {r.rid}: serve logits differ from submit's "
                 f"by {dlogit:.3e}")
    req_steps = _decode_vs_prefill(DS_ARCH, b, rt.params, reqs,
                                   [solo_res[r.rid] for r in reqs], solo,
                                   dev, (1, FAM_NEW - 1), tag="phase9")
    ticks = run.decode_steps
    n_max = cache_len // PAGE
    want = dict.fromkeys(ops.LAUNCHES, 0)
    want["paged_mla_decode"] = ticks * cfg.n_layers
    want_shapes = {k: {} for k in ops.SHAPE_LAUNCHES}
    want_shapes["paged_mla_decode"] = {
        (FAM_ROWS, n_max, PAGE, cfg.n_heads, cfg.kv_lora_rank,
         cfg.qk_rope_dim): ticks * cfg.n_layers}
    log(f"[phase9] {DS_ARCH} kernel launches {launches}, expected {want}; "
        f"by shape {shapes}, expected {want_shapes}")
    if launches != want or shapes != want_shapes:
        fail(f"{DS_ARCH}: kernel launches {launches}, by shape {shapes} != "
             f"expected {want}, {want_shapes}")

    trace = run.scheduler.tracer.trace
    tick_s = {}
    for r in reqs:
        for sp in trace.spans_for(r.rid):
            if sp.phase == "decode_tick":
                tick_s[(sp.t0, sp.t1)] = sp.t1 - sp.t0
    stats = run.scheduler.stats_dict()[cfg.name]
    solo_s = sum(sp.t1 - sp.t0 for r in solo_res.values()
                 for sp in r.timeline if sp.phase == "decode")
    steps = sum(req_steps)
    longest = reqs[int(np.argmax(lens))]
    batch = {"tokens": torch.tensor([longest.prompt], dtype=torch.int32,
                                    device=dev)}
    pre, cache = _prefill_ms(b, rt.params, batch, dense_T(max(lens), FAM_NEW),
                             dev)
    _profile_decode(DS_ARCH, b, rt.params, cache, max(lens), dev)
    cache_floats = sum(int(np.prod(ws.shape)) for ws in
                       tree_leaves(b.cache_specs(1, 1))) // cfg.n_layers
    read = (n - n_embed - n_mtp) * 4
    log(f"[phase9] {DS_ARCH}: prefill of {max(lens)} tokens "
        f"{min(pre):.1f} ms (best of 3, warm; "
        f"{', '.join(f'{t:.1f}' for t in pre)}); serve() decode "
        f"{stats['decode_tokens']} tokens over {len(tick_s)} ticks, "
        f"{stats['decode_tokens'] / sum(tick_s.values()):.1f} tokens/s, "
        f"{1e3 * sum(tick_s.values()) / len(tick_s):.2f} ms per tick; solo "
        f"decode {steps} steps, {steps / solo_s:.1f} tokens/s "
        f"({1e3 * solo_s / steps:.2f} ms per token; weight-read floor "
        f"{read / hbm_bytes_s() * 1e3:.2f} ms: {read / 1e9:.2f} GB a step, "
        f"the embedding table and the MTP block unread); latent cache "
        f"{cache_floats} floats ({4 * cache_floats} B) a token and layer")
    _graph_vs_eager("phase9", DS_ARCH, lambda: _graph_run(serve_arch(
        cfg, reqs, device=dev, params=rt.params, max_batch=FAM_ROWS,
        cache_len=cache_len)), {r.rid: r.output for r in run.results},
        cfg.n_layers, kernel="paged_mla_decode")
    peak = torch.cuda.max_memory_allocated()
    log(f"[phase9] {DS_ARCH}: peak device memory {peak / 1e9:.2f} GB "
        f"(weights {n * 4 / 1e9:.2f} GB, one expert leaf "
        f"{leaf_bytes / 1e9:.2f} GB)")
    if peak >= n * 4 + leaf_bytes:
        fail(f"{DS_ARCH}: peak {peak / 1e9:.2f} GB reaches the weights plus "
             "one expert leaf: an expert leaf was copied")
    del run, rt, b, cache, served, solo, solo_res
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return {"launches": launches, "shapes": shapes}


# --------------------------------------------------------------------------
# phase 10: the analysis passes against the card
# --------------------------------------------------------------------------

def _plans_agree(dev, cases, n_sm) -> None:
    """The Python plans the kernel checker reads against the built
    kernels' own: ``ops.flash_plan`` against ``flash_attention_plan`` at
    every head dim and dtype (and both refusing D = 96), and each case's
    SSD and sLSTM prefill plan against ``ssd_intra_chunk_info`` /
    ``slstm_prefill_info`` (shared memory, threads; the blocks an SM the
    SSD planner counts against the card's occupancy; clusters the card
    holds at once against the heads), and each paged MLA plan against
    ``paged_mla_decode_info`` (threads, shared memory, blocks an SM)."""
    import ctypes

    from repro_torch.analysis import kernel_check as kc
    from repro_torch.kernels import build, ops

    out = (ctypes.c_int * 4)()
    lib = build.load("flash_attention")
    for dt, code in ops._DTYPES.items():
        for D in ops.HEAD_DIMS:
            if lib.flash_attention_plan(D, code, out) != 0:
                fail(f"flash_attention_plan has no {dt} plan for D={D}")
            p = ops.flash_plan(D, dt)
            if (p.bq, p.bk, p.threads, p.smem) != tuple(out):
                fail(f"ops.flash_plan({D}, {dt}) = {p}, the kernel's "
                     f"{tuple(out)}")
        if lib.flash_attention_plan(96, code, out) == 0:
            fail(f"flash_attention_plan has a {dt} plan for D=96; "
                 "ops.flash_plan has none")
    log(f"[phase10] ops.flash_plan == flash_attention_plan at D in "
        f"{ops.HEAD_DIMS}, float32 and bfloat16; both refuse D=96")
    info = (ctypes.c_int * 3)()
    n_ssd = n_sl = n_tile = n_mla = 0
    for case in cases:
        lp = kc.launch_plan(case, n_sm)
        if lp.kernel == "ssd_tile_kernel":
            p = lp.plan
            L = case.shape("x")[2 if case.entry == "ssd_intra_chunk" else 1]
            L = min(L, case.kwargs.get("chunk", L))
            P, N = case.shape("x")[-1], case.shape("Bm")[-1]
            if build.load("ssd_scan").ssd_intra_chunk_info(
                    L, P, N, p.tr, p.ns, info) != 0:
                fail(f"{case.name}: ssd_intra_chunk_info refuses the plan")
            got = (info[0], info[1], info[2])
            if got != (p.smem, p.threads, p.blocks_per_sm):
                fail(f"{case.name}: SSD plan (smem, threads, blocks an SM) "
                     f"{(p.smem, p.threads, p.blocks_per_sm)}, the card's "
                     f"{got}")
            n_ssd += 1
        elif lp.kernel == "slstm_prefill_kernel":
            p = lp.plan
            H_, hd = case.shape("R")[1:3]
            if build.load("slstm_scan").slstm_prefill_info(
                    hd, p.cluster, p.reg_slots, p.rows, info) != 0:
                fail(f"{case.name}: slstm_prefill_info refuses the plan")
            if (info[0], info[1]) != (p.smem, p.threads):
                fail(f"{case.name}: sLSTM plan (smem, threads) "
                     f"{(p.smem, p.threads)}, the card's "
                     f"{(info[0], info[1])}")
            if info[2] < H_:
                fail(f"{case.name}: the card holds {info[2]} clusters of "
                     f"{p.cluster}, fewer than the {H_} heads")
            n_sl += 1
        elif lp.kernel == "paged_mla_decode_kernel":
            if build.load("mla_decode").paged_mla_decode_info(info) != 0:
                fail(f"{case.name}: paged_mla_decode_info failed")
            if (info[0], info[1]) != (lp.threads, lp.smem) or \
                    info[2] != lp.blocks_per_sm:
                fail(f"{case.name}: the MLA plan's {lp.threads} threads, "
                     f"{lp.smem} B and {lp.blocks_per_sm} blocks an SM, "
                     f"the card's {tuple(info)}")
            n_mla += 1
        elif lp.tile is not None:
            D_ = case.shape("q")[2]
            if build.load("decode_attention").paged_decode_tile_info(
                    D_, 0, info) != 0:
                fail(f"{case.name}: paged_decode_tile_info refuses D={D_}")
            if info[0] != lp.threads or info[1] < lp.blocks_per_sm:
                fail(f"{case.name}: the tile plan's {lp.threads} threads "
                     f"and {lp.blocks_per_sm} blocks an SM, the card's "
                     f"{info[0]} and {info[1]}")
            log(f"[phase10] {case.name}: the tile plan (grid {lp.grid}, "
                f"{lp.threads} threads, {lp.blocks_per_sm} blocks an SM, "
                f"{lp.workspace} B workspace, tile {lp.tile}) against "
                f"paged_decode_tile_info: {info[0]} threads, {info[1]} "
                f"blocks an SM, {info[2]} B static shared memory")
            n_tile += 1
    log(f"[phase10] the checker's SSD plans at {n_ssd} cases equal "
        f"ssd_intra_chunk_info (smem, threads, blocks an SM), its sLSTM "
        f"prefill plans at {n_sl} equal slstm_prefill_info, its paged "
        f"tile plans at {n_tile} agree with paged_decode_tile_info, its MLA "
        f"plans at {n_mla} equal paged_mla_decode_info")


def _ssd_vs_f64(case, args, got) -> float:
    """Hold an SSD case's kernel outputs to the plain version in float64:
    max |kernel - f64| <= SSD_F64_MULTIPLE * max |plain f32 - f64| +
    SSD_F64_FLOOR, output by output, where the float32 plain version is
    the same chunked algorithm (``ssd_intra_chunk_ref``; for
    ``ssd_chunked`` the wrapper's own CPU path on host copies, whose
    intra-chunk part is the plain version).  Returns the worst share of
    the bound."""
    import torch

    from repro_torch.kernels import ops, ref

    if case.entry == "ssd_intra_chunk":
        f64 = ref.ssd_intra_chunk_ref(*args, dtype=torch.float64)
        f32 = ref.ssd_intra_chunk_ref(*args)
    else:
        f64 = ref.ssd_scan_ref(*args, dtype=torch.float64)
        f32 = ops.ssd_chunked(*(t.cpu() for t in args), **case.kwargs)
    worst, parts = 0.0, []
    for i, (k, p, t) in enumerate(zip(got, f32, f64)):
        t = t.cpu()
        if not bool(torch.isfinite(k).all()):
            fail(f"{case.name}: output[{i}] is not finite")
        e_k = (k.double().cpu() - t).abs().max().item()
        e_p = (p.double().cpu() - t).abs().max().item()
        limit = SSD_F64_MULTIPLE * e_p + SSD_F64_FLOOR
        if e_k > limit:
            fail(f"{case.name}: output[{i}] {e_k:.3e} from float64, above "
                 f"{SSD_F64_MULTIPLE} x the float32 plain version's "
                 f"{e_p:.3e} + {SSD_F64_FLOOR}")
        worst = max(worst, e_k / limit)
        parts.append(f"[{i}] kernel {e_k:.3e}, plain f32 {e_p:.3e}")
    log(f"[phase10] {case.name}: {case.entry} "
        f"{[tuple(t.shape) for t in got]} float32 launched, max |diff| from "
        f"float64: {'; '.join(parts)}; {worst:.2f} of {SSD_F64_MULTIPLE} x "
        f"plain + {SSD_F64_FLOOR} ok")
    return worst


def phase_analysis(dev) -> None:
    """Phase 10: ``check_kernels(device=...)`` over the zoo's served
    shapes (no ERROR; its plans equal the kernels' own); every case it
    passes launched once at its full shape in float32 with seeded inputs
    (the meta contract's shapes and dtypes; the plain version at
    ``TOL["float32"]``, SSD by ``_ssd_vs_f64``); every case it marks ERROR
    raised by its wrapper, with the error type of its code; phase 3's
    deployment and phase 6's scenario verified with ``kernels=True,
    model_check=True`` before they materialize (no ERROR, a complete
    model check within ``mc_budget=10``); ``python -m
    repro_torch.analysis --self`` exits 0."""
    import gc
    import os

    import torch

    from repro_torch.analysis import errors, format_report
    from repro_torch.analysis import kernel_check as kc
    from repro_torch.common.config import get_config
    from repro_torch.examples import multi_task_serving as ex
    from repro_torch.kernels import ops

    t0 = time.perf_counter()
    n_sm = ops.sm_count(dev)
    cases = kc.zoo_cases()
    diags = kc.check_kernels(device=dev)
    if errors(diags):
        fail(f"check_kernels on the card:\n{format_report(errors(diags))}")
    warned = [d.entity for d in diags if d.code == "kernel/occupancy"]
    log(f"[phase10] check_kernels(device={dev}) at {n_sm} SMs: "
        f"{len(cases)} cases, {len(diags)} findings, 0 errors, warnings "
        f"{warned or 'none'}")
    _plans_agree(dev, cases, n_sm)

    # every clean case, once, at its full shape
    g = torch.Generator(device=dev).manual_seed(SEED)
    worst = 0.0
    held = []
    ops.WORK_HOOKS.append(lambda name, flops, moved, peak: held.append(peak))
    for case in cases:
        args = case.inputs(g)
        meta = kc.leaves(getattr(ops, case.entry)(*case.meta_args(),
                                                   **case.kwargs))
        held.clear()
        got = kc.leaves(getattr(ops, case.entry)(*args, **case.kwargs))
        torch.cuda.synchronize()
        lp = kc.launch_plan(case, n_sm)
        if lp.workspace:
            # the split-KV kernels: the wrapper's outputs and workspace as
            # it reports them, against the plan's workspace
            want_b = sum(t.numel() * t.element_size() for t in got) + \
                lp.workspace
            if held != [want_b]:
                fail(f"{case.name}: the wrapper held {held} B, the plan's "
                     f"outputs and workspace {want_b}")
        if len(got) != len(meta):
            fail(f"{case.name}: {len(got)} outputs, the checker read "
                 f"{len(meta)}")
        for i, (a, m) in enumerate(zip(got, meta)):
            if a.shape != m.shape or a.dtype != m.dtype:
                fail(f"{case.name}: output[{i}] {tuple(a.shape)} {a.dtype}, "
                     f"the checker read {tuple(m.shape)} {m.dtype}")
        if case.entry in SSD_ENTRIES:
            ratio = _ssd_vs_f64(case, args, got)
        else:
            want = kc.leaves(kc.plain(case, args))
            if len(want) != len(got):
                fail(f"{case.name}: the plain version gives {len(want)} "
                     f"outputs, the kernel {len(got)}")
            errs = [_within(a, b, "float32") for a, b in zip(got, want)]
            err, ratio = max(e for e, _ in errs), max(r for _, r in errs)
            if ratio > 1.0:
                fail(f"{case.name}: max |diff| {err:.3e} vs the plain "
                     f"version, {ratio:.2f} of (atol, rtol) "
                     f"{TOL['float32']}")
            log(f"[phase10] {case.name}: {case.entry} "
                f"{[tuple(t.shape) for t in got]} float32 launched, max "
                f"|diff| vs plain {err:.3e}, {ratio:.2f} of (atol, rtol) "
                f"{TOL['float32']} ok")
            del want
        worst = max(worst, ratio)
        del args, got
    ops.WORK_HOOKS.pop()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[phase10] {len(cases)} clean cases launched at their full shapes: "
        f"worst {worst:.2f} of its tolerance")

    # every ERROR case raises in its wrapper
    bad = kc.error_cases()
    for case in bad:
        codes = {d.code for d in errors(kc.check_case(case, n_sm=n_sm))}
        if codes != {kc.ERROR_CODES[case.name]}:
            fail(f"{case.name}: the checker gave {codes}, expected "
                 f"{kc.ERROR_CODES[case.name]}")
        args = case.inputs(g)
        raised = None
        try:
            getattr(ops, case.entry)(*args, **case.kwargs)
        except ops.KernelPlanError as err:
            raised = err
        torch.cuda.synchronize()
        if raised is None:
            fail(f"{case.name}: flagged {codes} but launched")
        want = {c: cls for cls, c in kc.PLAN_CODES}[kc.ERROR_CODES[case.name]]
        if type(raised) is not want:
            fail(f"{case.name}: the checker gave {codes}, the wrapper "
                 f"raised {type(raised).__name__}, not {want.__name__}")
        log(f"[phase10] {case.name}: {sorted(codes)[0]}; the wrapper raised "
            f"{type(raised).__name__}: {raised}")
        del args

    # phase 3's deployment and phase 6's scenario, before they materialize
    for name, make in (
            ("phase 3 internvl2-1b",
             lambda: _deployment(dev, get_config("internvl2-1b"))[0]),
            ("phase 6 scenario",
             lambda: ex.build_deployment(dev, materialize=False)[0])):
        dep = make()
        if dep.materialized:
            fail(f"{name}: materialized before verify")
        t = time.perf_counter()
        vd = dep.verify(kernels=True, model_check=True, mc_budget=10.0)
        secs = time.perf_counter() - t
        mc = [d for d in vd if d.code.startswith("modelcheck/")]
        if errors(vd) or [d.code for d in mc] != ["modelcheck/clean"]:
            fail(f"{name}: verify gave {format_report(vd)}")
        log(f"[phase10] {name}: verify(kernels=True, model_check=True) "
            f"{len(vd)} findings, 0 errors, in {secs:.2f} s; "
            f"{mc[0].message}")
        del dep
        gc.collect()
        torch.cuda.empty_cache()

    t = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--self", "--device",
         "cuda", "--mc-budget", "10"], cwd=ROOT, capture_output=True,
        text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
    if out.returncode != 0:
        fail(f"python -m repro_torch.analysis --self exited "
             f"{out.returncode}:\n{out.stdout[-3000:]}\n{out.stderr[-3000:]}")
    log(f"[phase10] python -m repro_torch.analysis --self --device cuda: "
        f"exit 0 in {time.perf_counter() - t:.1f} s; "
        f"{out.stdout.strip().splitlines()[-1]}")
    log(f"[phase10] {len(cases)} clean and {len(bad)} ERROR cases, two "
        f"deployments verified, the CLI: {time.perf_counter() - t0:.1f} s")

# --------------------------------------------------------------------------
# phase 11: training
# --------------------------------------------------------------------------

def _train_batches(cfg, seq, batch, dev, n):
    from repro_torch.training.data import DataConfig, TokenStream
    from repro_torch.training.train_step import batch_to_tensors

    data = TokenStream(DataConfig(seq_len=seq, global_batch=batch,
                                  vocab_size=cfg.vocab_size))
    return [batch_to_tensors(b, dev) for _, b in zip(range(n), data)]


def _train_steps(bundle, state, tcfg, batches, label):
    """Run ``make_train_step`` over ``batches``, each step timed with CUDA
    events; prints each step's loss and grad norm and fails on a value
    that is not finite.  Returns (losses, step ms)."""
    import math

    import torch

    from repro_torch.training.train_step import make_train_step

    step = make_train_step(bundle, tcfg)
    losses, ms = [], []
    for i, batch in enumerate(batches):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        state, m = step(state, batch)
        end.record()
        end.synchronize()
        ms.append(start.elapsed_time(end))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        log(f"[phase11] {label} step {int(state['step'])}: loss {loss:.4f}, "
            f"grad norm {gnorm:.4f}, lr {float(m['lr']):.3e}, {ms[-1]:.1f} ms")
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"{label}: step {int(state['step'])} gave loss {loss}, "
                 f"grad norm {gnorm}")
        losses.append(loss)
    return losses, ms


def _rel_l2(got, want) -> float:
    d = (got.float() - want.float()).norm().item()
    n = want.float().norm().item()
    return d / n if n else d


def _guard_cases(dev):
    """(wrapper name, call, floating inputs) for each of the six kernel
    wrappers at a small shape every kernel has a plan for."""
    import torch

    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(SEED + 11)

    def rnd(*shape):
        return torch.randn(shape, generator=g).to(dev)

    def i32(*vals):
        return torch.tensor(vals, dtype=torch.int32).to(dev)

    return [
        ("flash_attention", ops.flash_attention,
         [rnd(1, 8, 2, 16), rnd(1, 8, 2, 16), rnd(1, 8, 2, 16)]),
        ("decode_attention", lambda q, k, v: ops.decode_attention(
            q, k, v, i32(5)), [rnd(1, 2, 16), rnd(1, 8, 2, 16),
                               rnd(1, 8, 2, 16)]),
        ("paged_decode_attention", lambda q, kp, vp: ops.paged_decode_attention(
            q, kp, vp, i32(0, 2).reshape(1, 2), i32(6)),
         [rnd(1, 2, 16), rnd(4, 4, 2, 16), rnd(4, 4, 2, 16)]),
        ("ssd_intra_chunk", ops.ssd_intra_chunk,
         [rnd(1, 1, 8, 2, 16), rnd(1, 1, 8, 16), rnd(1, 1, 8, 16),
          rnd(1, 1, 8, 2).abs(), rnd(2)]),
        ("ssd_chunked", lambda *a: ops.ssd_chunked(*a, chunk=8),
         [rnd(1, 8, 2, 16), rnd(1, 8, 16), rnd(1, 8, 16), rnd(1, 8, 2).abs(),
          rnd(2)]),
        ("slstm_scan", ops.slstm_scan, [rnd(1, 3, 4, 32),
                                        0.1 * rnd(4, 2, 16, 16)]),
    ]


def _profile_train_step(bundle, state, tcfg, batch, step_ms) -> None:
    """One more train step under ``torch.profiler``: its kernels' summed
    device time beside the step's median time (the device's busy share),
    and the kernels that take the most of it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.training.train_step import make_train_step

    step = make_train_step(bundle, tcfg)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch)
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.time_range.elapsed_us() for e in ev) / 1e3
    by_name: dict[str, float] = {}
    for e in ev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[phase11] profiled step: {len(ev)} device events, {busy:.1f} ms "
        f"busy beside a {step_ms:.1f} ms step ({busy / step_ms:.1%}); top: "
        + "; ".join(f"{n[:60]} {us / 1e3:.1f} ms" for n, us in top))


def phase_training(dev) -> dict:
    """Training on the card.  (a) tinyllama-1.1b at full width and depth
    (float32) takes ``TRAIN_STEPS`` steps of ``make_train_step`` on the
    synthetic ``TokenStream`` (the train launcher's seq and batch, lr and
    warmup), remat "none", then ``TRAIN_FULL_STEPS`` more with remat
    "full": each step's loss and grad norm, all finite, the mean of the
    last 5 losses at least ``TRAIN_MARGIN`` below the first; step ms, tokens/s
    and peak GB of each policy beside the 6 N tokens floor.  (c) The
    trained weights' loss on the next batch through the kernels
    (``attn_impl="kernel"``, under no_grad) == the plain path's, with
    exactly one flash launch a layer, at the training shape: the main
    path of this phase.  (b) At full width cut to 2 layers: the loss and
    every gradient leaf card == CPU, one AdamW update from the same
    gradients card == CPU, two microbatches == one on the card.  (d) Each
    kernel wrapper raises on a card input that requires grad and
    launches under no_grad.  (e) A checkpoint written by ``save_async``
    while the run goes on, restored into fresh weights, steps as the
    run does.  Returns the main-path launches of (c)."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.common.config import TrainConfig, get_config
    from repro_torch.common.pytree import tree_leaves, tree_map
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import adamw_update, init_state
    from repro_torch.training.train_step import (
        loss_and_grads, make_train_step, microbatch_grads,
    )

    t0 = time.perf_counter()
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 is on: the float32 checks need FMA units")
    cfg = get_config(TRAIN_ARCH)
    tcfg = TrainConfig(**TRAIN_TCFG)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    batches = _train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, dev,
                             TRAIN_STEPS + TRAIN_FULL_STEPS + 1)

    # (a) full width and depth
    gc.collect()
    torch.cuda.empty_cache()
    bundle = build_model(cfg, remat="none", compute_dtype=torch.float32)
    n_params = bundle.param_count()
    state = init_state(bundle.init(torch.Generator(device=dev)
                                   .manual_seed(SEED), device=dev), tcfg)
    state_gb = 4 * 4 * n_params / 1e9          # params, grads, m, v in f32
    floor_s = 6 * n_params * tokens / 67e12
    rates = {}
    losses = []
    for remat, lo, hi in (("none", 0, TRAIN_STEPS),
                          ("full", TRAIN_STEPS,
                           TRAIN_STEPS + TRAIN_FULL_STEPS)):
        b_r = build_model(cfg, remat=remat, compute_dtype=torch.float32)
        if remat != "none":
            # the gradients alone (no optimizer), their time and peak
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            grads = loss_and_grads(b_r, state["params"], batches[lo])[2]
            torch.cuda.synchronize()
            log(f"[phase11] remat {remat}: loss and gradients alone "
                f"{(time.perf_counter() - t) * 1e3:.1f} ms, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            del grads
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ls, ms = _train_steps(b_r, state, tcfg, batches[lo:hi],
                              f"{TRAIN_ARCH} remat {remat}")
        losses += ls
        warm = sorted(ms[1:])
        med = warm[len(warm) // 2]
        rates[remat] = (med, tokens / med * 1e3,
                        torch.cuda.max_memory_allocated() / 1e9)
        log(f"[phase11] {TRAIN_ARCH} ({n_params:,} parameters, B={TRAIN_BATCH} "
            f"S={TRAIN_SEQ}) remat {remat}: step {med:.1f} ms (median of "
            f"steps 2-{len(ms)}; first {ms[0]:.1f} ms), {tokens / med * 1e3:,.0f} "
            f"tokens/s, peak {rates[remat][2]:.2f} GB (state alone "
            f"{state_gb:.2f} GB); floor 6 N tokens at 67 TFLOP/s "
            f"{floor_s * 1e3:.1f} ms, the step {med / (floor_s * 1e3):.2f}x it")
        if remat == "none":
            # the gradients alone before the full-remat steps, and where
            # one step's time goes (one more step, under the profiler)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            grads = loss_and_grads(b_r, state["params"], batches[hi])[2]
            torch.cuda.synchronize()
            log(f"[phase11] remat none: loss and gradients alone "
                f"{(time.perf_counter() - t) * 1e3:.1f} ms, peak "
                f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
            del grads
            _profile_train_step(b_r, state, tcfg, batches[hi], med)
    first, last5 = losses[0], sum(losses[TRAIN_STEPS - 5:TRAIN_STEPS]) / 5
    log(f"[phase11] {TRAIN_ARCH} loss: first {first:.4f}, mean of steps "
        f"{TRAIN_STEPS - 4}-{TRAIN_STEPS} {last5:.4f}, fell {first - last5:.4f} "
        f"(needs at least {TRAIN_MARGIN})")
    if not first - last5 >= TRAIN_MARGIN:
        fail(f"{TRAIN_ARCH}: the loss fell {first - last5:.4f} in "
             f"{TRAIN_STEPS} steps, less than {TRAIN_MARGIN}")

    # (c) the kernels' path on the trained weights: the main path
    batch = batches[-1]
    with torch.no_grad():
        l_xla, _ = bundle.loss_fn(state["params"], batch)
        kbundle = build_model(cfg, attn_impl="kernel",
                              compute_dtype=torch.float32)
        torch.cuda.synchronize()
        ops.reset_launches()
        l_ker, _ = kbundle.loss_fn(state["params"], batch)
        torch.cuda.synchronize()
    launches = dict(ops.LAUNCHES)
    shapes = f32_shapes()
    key = (TRAIN_BATCH, TRAIN_SEQ, TRAIN_SEQ, TL_H, TL_K, D, True, 0)
    want = {k: 0 for k in launches}
    want["flash_attention"] = cfg.n_layers
    d = abs(float(l_ker) - float(l_xla))
    log(f"[phase11] kernel-path loss {float(l_ker):.6f} vs plain "
        f"{float(l_xla):.6f}: |diff| {d:.3e} (tolerance 2e-4 + 2e-4 |plain|); "
        f"launches {launches}; flash at {key}: "
        f"{shapes['flash_attention'].get(key, 0)} of {cfg.n_layers}")
    if d > 2e-4 + 2e-4 * abs(float(l_xla)):
        fail("the kernels' loss disagrees with the plain path's")
    if launches != want or shapes["flash_attention"] != {key: cfg.n_layers}:
        fail(f"kernel-path loss launches {launches} / {shapes} != {want} at "
             f"{key}")
    del state, bundle, kbundle, batches, batch
    gc.collect()
    torch.cuda.empty_cache()

    # (b) card == CPU at full width, 2 layers
    cfg2 = cfg.with_overrides(n_layers=TRAIN_CPU_LAYERS)
    b2 = build_model(cfg2, remat="none", compute_dtype=torch.float32)
    p_gpu = b2.init(torch.Generator(device=dev).manual_seed(SEED + 1),
                    device=dev)
    p_cpu = tree_map(lambda t: t.cpu(), p_gpu)
    (bg,) = _train_batches(cfg2, TRAIN_SEQ, TRAIN_CPU_BATCH, dev, 1)
    bc = {k: v.cpu() for k, v in bg.items()}
    lg, _, gg = loss_and_grads(b2, p_gpu, bg)
    lc, _, gc_ = loss_and_grads(b2, p_cpu, bc)
    d = abs(float(lg) - float(lc))
    worst = max(_rel_l2(a.cpu(), b) for a, b in zip(tree_leaves(gg),
                                                     tree_leaves(gc_)))
    log(f"[phase11] {TRAIN_ARCH} at {TRAIN_CPU_LAYERS} layers, B="
        f"{TRAIN_CPU_BATCH} S={TRAIN_SEQ}: loss card {float(lg):.6f} vs CPU "
        f"{float(lc):.6f} (|diff| {d:.3e}); gradients' worst relative L2 "
        f"{worst:.3e} over {len(tree_leaves(gg))} leaves (needs <= 1e-4)")
    if d > 2e-4 + 2e-4 * abs(float(lc)) or not worst <= 1e-4:
        fail("training at 2 layers: the card disagrees with the CPU")
    st_g = adamw_update(init_state(tree_map(torch.clone, p_gpu), tcfg),
                        tree_map(lambda t: t.to(dev), gc_), tcfg)[0]
    st_c = adamw_update(init_state(tree_map(torch.clone, p_cpu), tcfg),
                        gc_, tcfg)[0]
    worst = max(_err(a.cpu(), b) for part in ("params", "m", "v")
                for a, b in zip(tree_leaves(st_g[part]),
                                tree_leaves(st_c[part])))
    log(f"[phase11] one AdamW update from the same gradients: card vs CPU "
        f"max |diff| {worst:.3e} over params, m and v (needs <= 2e-4)")
    if not worst <= 2e-4:
        fail("adamw_update: the card disagrees with the CPU")
    del st_g, st_c, p_cpu, gc_
    l2, _, g2 = microbatch_grads(b2, p_gpu, bg, 2)
    worst = max(_rel_l2(a, b) for a, b in zip(tree_leaves(g2),
                                              tree_leaves(gg)))
    log(f"[phase11] microbatches=2 vs 1 on the card: loss {float(l2):.6f} vs "
        f"{float(lg):.6f}; gradients' worst relative L2 {worst:.3e} (needs "
        f"<= 1e-4)")
    if abs(float(l2) - float(lg)) > 2e-4 * abs(float(lg)) or not worst <= 1e-4:
        fail("microbatched gradients disagree with the full batch's")
    st = init_state(p_gpu, TrainConfig(microbatches=2, **TRAIN_TCFG))
    make_train_step(b2, TrainConfig(microbatches=2, **TRAIN_TCFG))(st, bg)
    del b2, p_gpu, gg, g2, st
    gc.collect()
    torch.cuda.empty_cache()

    # (d) the guard
    for name, fn, inputs in _guard_cases(dev):
        before = sum(ops.LAUNCHES.values())
        for i in range(len(inputs)):
            args = [t.clone().requires_grad_(j == i)
                    for j, t in enumerate(inputs)]
            try:
                fn(*args)
            except ops.NoBackwardError:
                continue
            fail(f"{name}: input {i} requires grad and the wrapper did not "
                 "raise NoBackwardError")
        with torch.no_grad():
            fn(*[t.clone().requires_grad_(True) for t in inputs])
        torch.cuda.synchronize()
        n = sum(ops.LAUNCHES.values()) - before
        log(f"[phase11] guard {name}: NoBackwardError for each of its "
            f"{len(inputs)} floating inputs under grad; {n} launch under "
            "no_grad")
        if n != 1:
            fail(f"{name}: {n} launches under no_grad, not 1")

    # (e) a checkpoint written while the run goes on
    scfg = get_config(TRAIN_ARCH, smoke=True)
    sb = build_model(scfg, compute_dtype=torch.float32)
    stcfg = TrainConfig(**TRAIN_TCFG)
    sbatches = _train_batches(scfg, 32, 4, dev, TRAIN_CKPT_STEP + 1)
    step = make_train_step(sb, stcfg)
    run = init_state(sb.init(torch.Generator(device=dev).manual_seed(SEED),
                             device=dev), stcfg)
    for b in sbatches[:TRAIN_CKPT_STEP]:
        run, _ = step(run, b)
    tmp = Path(tempfile.mkdtemp(prefix="phase11_ckpt_"))
    try:
        writer = ckpt.save_async(run, tmp, step=TRAIN_CKPT_STEP)
        run, m_run = step(run, sbatches[-1])   # in place, while it writes
        writer.join()
        fresh = init_state(sb.init(torch.Generator(device=dev)
                                   .manual_seed(SEED + 99), device=dev),
                           stcfg)
        resumed = ckpt.restore(fresh, tmp)
        resumed, m_res = step(resumed, sbatches[-1])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    worst = max(_err(a, b) for a, b in zip(tree_leaves(resumed),
                                           tree_leaves(run)))
    log(f"[phase11] checkpoint at step {TRAIN_CKPT_STEP} (save_async), "
        f"restored into fresh weights, one step: loss {float(m_res['loss']):.6f} "
        f"vs the uninterrupted run's {float(m_run['loss']):.6f}; state max "
        f"|diff| {worst:.3e} (needs <= 2e-4); step {int(resumed['step'])}")
    if int(resumed["step"]) != TRAIN_CKPT_STEP + 1 or not worst <= 2e-4 or \
            abs(float(m_res["loss"]) - float(m_run["loss"])) > 2e-4:
        fail("the restarted run disagrees with the uninterrupted one")
    if tmp.exists():
        fail(f"phase 11 left {tmp} behind")
    log(f"[phase11] training in {time.perf_counter() - t0:.1f} s; "
        f"rates {rates}")
    return {"launches": launches, "shapes": shapes, "rates": rates}


def _whole(x):
    """A DTensor gathered whole on every rank (``sharding.local_as``: the
    c10d all-gather, which gloo takes on CUDA tensors, where DTensor's own
    ``full_tensor`` crashes the process); a plain tensor as it is."""
    if not hasattr(x, "full_tensor"):
        return x
    from torch.distributed.tensor import Replicate

    from repro_torch.common.sharding import local_as

    return local_as(x, x.device_mesh, [Replicate()] * x.device_mesh.ndim)


@contextlib.contextmanager
def _comm_counted(calls, kind):
    """With a list ``calls``, the block under ``CommDebugMode``, its
    collectives by kind appended as (``kind``, counts); else nothing."""
    if calls is None:
        yield
        return
    from torch.distributed.tensor.debug import CommDebugMode

    with CommDebugMode() as comm:
        yield
    calls.append((kind, _comm_kinds(comm)))


def _dist_generate(bundle, params, prompt, new, dev, calls=None):
    """One greedy request solo on a (sharded) bundle: prefill, then new - 1
    decode steps.  Returns (tokens, each step's logits on the host,
    prefill s, each decode step's s).  With a list ``calls``, each call
    (its logits gathered included) runs under ``CommDebugMode`` and its
    collectives by kind are appended as ("prefill" | "decode", counts)."""
    import torch

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    T = dense_T(len(prompt), new)
    cache = bundle.init_cache(1, T, torch.float32, dev)
    sync()
    t0 = time.perf_counter()
    with _comm_counted(calls, "prefill"):
        lg, cache = bundle.prefill(
            params, {"tokens": torch.tensor([prompt], dtype=torch.int32,
                                            device=dev)}, cache)
        lg = _whole(lg)
    sync()
    pre_s = time.perf_counter() - t0
    logits, toks, steps = [lg[0].cpu()], [int(lg[0].argmax())], []
    for i in range(new - 1):
        t0 = time.perf_counter()
        with _comm_counted(calls, "decode"):
            lg, cache = bundle.decode_step(
                params, torch.tensor([[toks[-1]]], dtype=torch.int32,
                                     device=dev),
                cache, torch.tensor([len(prompt) + i], dtype=torch.int32,
                                    device=dev))
            lg = _whole(lg)
        sync()
        steps.append(time.perf_counter() - t0)
        logits.append(lg[0].cpu())
        toks.append(int(lg[0].argmax()))
    return toks, logits, pre_s, steps


def _dist_worker(rank, world, init, backend, dev_type, shape, cfg, rules,
                 opts, extras, out):
    """One rank of phase 12, in a spawned process: its process group
    (``backend``, a file rendezvous), the mesh, the model (each weight
    leaf drawn whole from seed 0 on the card, this rank's slice kept),
    then the main path under ``CommDebugMode`` with the kernel counts
    from 0: phase 8's requests served solo.  Then a warm prefill timed;
    with ``extras`` also decode == a fresh prefill at the no-drop
    capacity and the model cut to ``DIST_CPU_LAYERS`` layers.  Writes
    its results to ``out``/rank<r>.pt."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode

    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.common.sharding import local_mesh
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.api import build_model

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        mesh = local_mesh(shape, device=dev.type)
        b = build_model(cfg, mesh=mesh, rules=rules, **opts,
                        compute_dtype=torch.float32)
        params = b.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
        res = {"held": sum(t.to_local().numel() * t.to_local().element_size()
                           for t in tree_leaves(params))}
        lens = fam_prompts(cfg.name)
        reqs = make_requests(cfg, len(lens), FAM_NEW, prompt_lens=lens,
                             seed=SEED)
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        dist.barrier()
        ops.reset_launches()
        t0 = time.perf_counter()
        with CommDebugMode() as comm:
            runs = [_dist_generate(b, params, list(r.prompt), FAM_NEW, dev)
                    for r in reqs]
        res["wall"] = time.perf_counter() - t0
        res["launches"] = dict(ops.LAUNCHES)
        res["shapes"] = f32_shapes()
        res["comm"] = {str(k): int(v)
                       for k, v in comm.get_comm_counts().items()}
        res["tokens"] = [r[0] for r in runs]
        res["logits"] = [torch.stack(r[1]) for r in runs]
        res["prefill_s"] = [r[2] for r in runs]
        res["step_s"] = [t for r in runs for t in r[3]]
        longest = list(reqs[lens.index(max(lens))].prompt)
        res["warm_prefill_s"] = [
            _dist_generate(b, params, longest, 1, dev)[2] for _ in range(3)]
        if dev.type == "cuda":
            res["peak"] = torch.cuda.max_memory_allocated()
        if extras:
            # decode == a fresh prefill where no token is dropped
            b5 = build_model(cfg, mesh=mesh, rules=rules,
                             moe_capacity_factor=cfg.n_experts
                             / cfg.experts_top_k, **opts, compute_dtype=torch.float32)
            for key, bb in (("decode_vs_prefill", b5),
                            ("decode_vs_prefill_default_cf", b)):
                toks, lg, _, _ = _dist_generate(bb, params, longest, 2, dev)
                fresh = _dist_generate(bb, params, longest + toks[:1], 1,
                                       dev)[1]
                res[key] = _err(lg[1], fresh[0])
            del params
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            cfg2 = cfg.with_overrides(n_layers=DIST_CPU_LAYERS)
            b2 = build_model(cfg2, mesh=mesh, rules=rules, **opts,
                             compute_dtype=torch.float32)
            p2 = b2.init(torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
            res["cut"] = _dist_generate(b2, p2, longest, FAM_NEW, dev)[:2]
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _start_ranks(world, backend, dev, shape, cfg, rules, opts, extras,
                 tmp, tag):
    """Start ``_dist_worker`` on ``world`` spawned ranks (``_start``)."""
    return _start(_dist_worker, world, tmp, tag, backend, dev.type, shape,
                  cfg, rules, opts, extras)


def _spawn(worker, world, tmp, tag, *args):
    """Run ``worker(rank, world, init, *args, out)`` on ``world`` spawned
    ranks, joined within ``DIST_TIMEOUT`` (killed past it); returns each
    rank's results, which it saves to ``out``/rank<r>.pt."""
    return _start(worker, world, tmp, tag, *args)()


def _start(worker, world, tmp, tag, *args):
    """``_spawn``'s ranks started; returns the function that joins them
    (within ``DIST_TIMEOUT`` from their start) and loads their results,
    so the caller can work meanwhile."""
    import torch
    import torch.multiprocessing as mp

    out = Path(tmp) / tag
    out.mkdir()
    ctx = mp.start_processes(
        worker, nprocs=world, join=False, start_method="spawn",
        args=(world, str(Path(tmp) / f"{tag}.init"), *args, str(out)))
    deadline = time.monotonic() + DIST_TIMEOUT

    def join():
        while not ctx.join(timeout=max(0.1, deadline - time.monotonic())):
            if time.monotonic() > deadline:
                for proc in ctx.processes:
                    proc.kill()
                fail(f"{tag}: the ranks did not end within {DIST_TIMEOUT} s")
        return [torch.load(out / f"rank{r}.pt") for r in range(world)]

    return join


def _dist_expected(cfg, lens, with_decode):
    """One rank's exact launches on phase 12's main path: one flash a
    layer at each prompt's prefill (the whole q, k and v on every rank:
    the heads are replicated), one decode launch a layer at each step
    over the request's dense cache (none with the shardmap decode)."""
    from repro_torch.kernels import ops

    H_, K_, D_, L = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    want = dict.fromkeys(ops.LAUNCHES, 0)
    shapes = {k: {} for k in ops.SHAPE_LAUNCHES}
    for S_ in lens:
        key = (1, S_, S_, H_, K_, D_, True, 0)
        shapes["flash_attention"][key] = \
            shapes["flash_attention"].get(key, 0) + L
        want["flash_attention"] += L
        if with_decode:
            key = (1, dense_T(S_, FAM_NEW), H_, K_, D_, 0)
            n = (FAM_NEW - 1) * L
            shapes["decode_attention"][key] = \
                shapes["decode_attention"].get(key, 0) + n
            want["decode_attention"] += n
    return want, shapes


def phase_distributed(dev, cfg=None) -> None:
    """Phase 12: granite-moe-3b-a800m at full width, depth cut to
    ``DIST_LAYERS``, on a mesh
    (``cfg`` replaces it for a rehearsal on the CPU, where both runs use
    gloo).  (a) one rank over NCCL, mesh (1, 1), serving rules; (b) two
    ranks sharing the card over gloo, mesh (1, 2), the attnrep rules and
    the smattn options.  Checked: (a) and (b) give equal tokens and every
    step's logits within ``LOGIT_TOL``; (b) issues all_reduce and no other
    collective, exactly one a layer at a prefill (the expert psum) and
    four a layer at a decode step (the psum, then the max and two sums of
    the partial softmax); exact launches by call shape in each rank;
    (b)'s decode == a fresh prefill (no-drop capacity) within
    ``DECODE_TOL``; (b) cut to ``DIST_CPU_LAYERS`` layers == the mesh
    path on the CPU (a world of one, gloo) within ``LOGIT_TOL``.  Prints
    each rank's held weight bytes and peak memory, prefill ms, tokens/s
    and all_reduces a step beside the weight-read floor."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.common.config import get_config
    from repro_torch.common.sharding import local_mesh
    from repro_torch.launch.serve import make_requests
    from repro_torch.models.api import build_model

    cfg = cfg or get_config(DIST_ARCH).with_overrides(n_layers=DIST_LAYERS)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    lens = fam_prompts(cfg.name)
    tmp = tempfile.mkdtemp(prefix="phase12_")
    try:
        # (a) and (b) side by side on the card (their rates are printed,
        # not checked)
        joins = {
            "a": _start_ranks(1, "nccl" if dev.type == "cuda" else "gloo",
                              dev, (1, 1), cfg, DIST_SERVING, {}, False, tmp,
                              "phase12a"),
            "b": _start_ranks(2, "gloo", dev, (1, 2), cfg, DIST_ATTNREP,
                              DIST_SMATTN, True, tmp, "phase12b")}
        runs = {tag: join() for tag, join in joins.items()}
        n = build_model(cfg, compute_dtype=torch.float32).param_count()
        steps = len(lens) * (FAM_NEW - 1)
        for tag, ranks in runs.items():
            held = sum(r["held"] for r in ranks)
            floor_ms = held / hbm_bytes_s() * 1e3
            for rank, r in enumerate(ranks):
                comm = r["comm"]
                reduces = sum(v for k, v in comm.items()
                              if "allreduce" in k or "all_reduce" in k)
                decode_s = sum(r["step_s"])
                log(f"[phase12] ({tag}) rank {rank}/{len(ranks)}: "
                    f"{cfg.name} {cfg.n_layers} layers, {n:,} parameters, "
                    f"this rank holds {r['held'] / 1e9:.3f} GB of weights, "
                    f"peak {r.get('peak', 0) / 1e9:.2f} GB; "
                    f"main path {r['wall']:.2f} s: prefills "
                    f"{', '.join(f'{1e3 * t:.1f}' for t in r['prefill_s'])} "
                    f"ms (prompts {lens}), warm prefill of {max(lens)} "
                    f"{1e3 * min(r['warm_prefill_s']):.1f} ms (best of 3); "
                    f"{steps} decode steps {steps / decode_s:.2f} tokens/s "
                    f"({1e3 * decode_s / steps:.2f} ms a step; weight-read "
                    f"floor of the card {floor_ms:.2f} ms); collectives "
                    f"{comm}, {reduces} all_reduce")
                if tag == "b":
                    odd = {k: v for k, v in comm.items()
                           if "allreduce" not in k and "all_reduce" not in k}
                    want = len(lens) * cfg.n_layers * (1 + 4 * (FAM_NEW - 1))
                    log(f"[phase12] (b) rank {rank}: all_reduces "
                        f"{reduces}, expected {want} ({cfg.n_layers} a "
                        f"prefill, {4 * cfg.n_layers} a decode step)")
                    if odd or reduces != want:
                        fail(f"phase 12 (b) rank {rank}: collectives {comm}; "
                             f"only {want} all_reduce expected")
                want, want_shapes = _dist_expected(cfg, lens, tag == "a")
                log(f"[phase12] ({tag}) rank {rank} kernel launches "
                    f"{r['launches']}, expected {want}; by shape "
                    f"{r['shapes']}, expected {want_shapes}")
                if r["launches"] != want or r["shapes"] != want_shapes:
                    fail(f"phase 12 ({tag}) rank {rank}: launches "
                         f"{r['launches']} {r['shapes']} != {want} "
                         f"{want_shapes}")
        a, b0, b1 = runs["a"][0], runs["b"][0], runs["b"][1]
        worst = 0.0
        for i in range(len(lens)):
            if not (a["tokens"][i] == b0["tokens"][i] == b1["tokens"][i]):
                fail(f"phase 12 request {i}: tokens (a) {a['tokens'][i]} "
                     f"(b) {b0['tokens'][i]} {b1['tokens'][i]}")
            if not bool(torch.isfinite(a["logits"][i]).all()):
                fail(f"phase 12 request {i}: non-finite logits")
            worst = max(worst, _err(a["logits"][i], b0["logits"][i]),
                        _err(b0["logits"][i], b1["logits"][i]))
        log(f"[phase12] (a) == (b): {len(lens)} requests' tokens equal "
            f"({a['tokens']}), every step's logits max |dlogit| "
            f"{worst:.3e} (tol {LOGIT_TOL:g})")
        if worst > LOGIT_TOL:
            fail(f"phase 12: (a) and (b) logits differ by {worst:.3e}")
        dvp = max(r["decode_vs_prefill"] for r in runs["b"])
        log(f"[phase12] (b) decode step == fresh prefill of the longest "
            f"prompt + its first token at capacity factor "
            f"{cfg.n_experts / cfg.experts_top_k:g}: max |dlogit| {dvp:.3e} "
            f"(tol {DECODE_TOL:g}); at the default 1.25 "
            f"{max(r['decode_vs_prefill_default_cf'] for r in runs['b']):.3e}"
            " (not checked: capacity drops differ)")
        if dvp > DECODE_TOL:
            fail(f"phase 12 (b): decode differs from a fresh prefill by "
                 f"{dvp:.3e}")

        # (b) cut to DIST_CPU_LAYERS layers == the mesh path on the CPU
        cfg2 = cfg.with_overrides(n_layers=DIST_CPU_LAYERS)
        dist.init_process_group("gloo", init_method=f"file://{tmp}/cpu.init",
                                rank=0, world_size=1)
        try:
            mesh = local_mesh((1, 1), device="cpu")
            b2 = build_model(cfg2, mesh=mesh, rules=DIST_ATTNREP,
                             **DIST_SMATTN, compute_dtype=torch.float32)
            p2 = b2.init(torch.Generator(device=dev).manual_seed(SEED),
                         device="cpu")
            prompt = list(make_requests(cfg, len(lens), FAM_NEW,
                                        prompt_lens=lens, seed=SEED)
                          [lens.index(max(lens))].prompt)
            toks, logits, _, _ = _dist_generate(b2, p2, prompt, FAM_NEW,
                                                torch.device("cpu"))
        finally:
            dist.destroy_process_group()
        cut = max(_err(torch.stack(r["cut"][1]), torch.stack(logits))
                  for r in runs["b"])
        same = all(r["cut"][0] == toks for r in runs["b"])
        log(f"[phase12] (b) at {DIST_CPU_LAYERS} layers vs the CPU mesh path "
            f"(world of 1, gloo), prompt {len(prompt)} + {FAM_NEW - 1} "
            f"decode steps: tokens {'equal' if same else 'DIFFER'}, max "
            f"|dlogit| {cut:.3e} (tol {LOGIT_TOL:g})")
        if cut > LOGIT_TOL or not same:
            fail("phase 12: (b) disagrees with the CPU at "
                 f"{DIST_CPU_LAYERS} layers")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _counted(fn, *args, dev):
    """``fn(*args)`` under ``common.profiling.measure``; on the card also
    the bytes allocated at the call's peak above what was allocated
    before it (its arguments and the persistent buffers).  Returns
    (result, the report as a dict, that peak or None)."""
    import torch

    from repro_torch.common.profiling import measure

    base = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    out, rep = measure(fn, *args)
    peak = None
    if dev.type == "cuda":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    return out, {"flops": rep.flops, "count_by_op": dict(rep.count_by_op),
                 "bytes_by_op": dict(rep.bytes_by_op),
                 "memory": dict(rep.memory),
                 "kernel_flops": dict(rep.kernel_flops)}, peak


def _dry_serve_calls(bundle, params, cache, prompt, dev):
    """Phase 13 (a)'s two calls, each counted: a prefill of ``prompt``
    (token ids, or its length on meta tensors) into ``cache``, then one
    decode step of the greedy token.  The same code lays them out on
    meta tensors and runs them on the card.  Returns their reports and
    the card's peaks."""
    import torch

    S = prompt if isinstance(prompt, int) else len(prompt)
    i32 = dict(dtype=torch.int32, device=dev)
    tokens = (torch.empty((1, S), **i32) if dev.type == "meta"
              else torch.tensor([prompt], **i32))
    lengths = torch.tensor([S], **i32) if dev.type != "meta" else \
        torch.empty((1,), **i32)
    with torch.no_grad():
        (lg, cache), pre, pre_peak = _counted(
            bundle.prefill, params, {"tokens": tokens}, cache, dev=dev)
        tok = (torch.empty((1, 1), **i32) if dev.type == "meta" else
               lg.full_tensor().argmax(-1)[:, None].to(torch.int32))
        _, dec, dec_peak = _counted(bundle.decode_step, params, tok, cache,
                                    lengths, dev=dev)
    return {"prefill": pre, "decode": dec}, \
        {"prefill": pre_peak, "decode": dec_peak}


def _dry_serve_worker(rank, world, init, backend, dev_type, cfg, rules,
                      opts, prompt, out):
    """One rank of phase 13 (a): phase 12 (b)'s model on its mesh, the
    weights drawn from seed 0, a warm-up of the two calls, then the two
    calls counted with the kernel launches from 0."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.common.sharding import local_mesh
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        mesh = local_mesh((1, world), device=dev.type)
        b = build_model(cfg, mesh=mesh, rules=rules, **opts,
                        compute_dtype=torch.float32)
        params = b.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
        cache = b.init_cache(1, dense_T(len(prompt), FAM_NEW),
                             torch.float32, dev)
        _dry_serve_calls(b, params, cache, prompt, dev)     # warm-up
        dist.barrier()
        ops.reset_launches()
        reps, peaks = _dry_serve_calls(b, params, cache, prompt, dev)
        torch.save({"reps": reps, "peaks": peaks,
                    "launches": dict(ops.LAUNCHES),
                    "shapes": f32_shapes()},
                   Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _dry_train_worker(rank, world, init, backend, dev_type, cfg, out):
    """Phase 13 (b) on one rank: phase 11's tinyllama step (remat "none",
    the same weights from seed 0 and the same first batch) as DTensors on
    a (1, 1) mesh, counted; and the unsharded loss of the same weights
    and batch."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.common.config import TrainConfig
    from repro_torch.common.pytree import tree_map
    from repro_torch.common.sharding import local_mesh
    from repro_torch.models.api import build_model
    from repro_torch.training.optimizer import init_state
    from repro_torch.training.train_step import make_train_step

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{init}",
                            rank=rank, world_size=world)
    try:
        mesh = local_mesh((1, 1), device=dev.type)
        b = build_model(cfg, mesh=mesh, remat="none",
                        compute_dtype=torch.float32)
        params = b.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
        batch = _train_batches(cfg, TRAIN_SEQ, TRAIN_BATCH, dev, 1)[0]
        with torch.no_grad():
            plain, _ = build_model(cfg, remat="none",
                                   compute_dtype=torch.float32).loss_fn(
                tree_map(lambda t: t.to_local(), params), batch)
        tcfg = TrainConfig(**TRAIN_TCFG)
        state = init_state(params, tcfg)
        (_, metrics), rep, _ = _counted(make_train_step(b, tcfg), state,
                                        batch, dev=dev)
        peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" \
            else None
        torch.save({"rep": rep, "peak": peak, "plain": float(plain),
                    "loss": float(metrics["loss"].full_tensor()),
                    "batch": {k: (tuple(v.shape), v.dtype)
                              for k, v in batch.items()}},
                   Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _start_dry_cells(tmp):
    """Phase 13 (c)'s production cells, each in its own process through
    the dry-run CLI, all at once.  Returns (cell, process, log path)."""
    import os

    procs = []
    for arch, shape, multi_pod in DRY_CELLS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape] + (["--multi-pod"] if multi_pod else [])
        log_path = Path(tmp) / f"dry_{arch}_{shape}.log"
        with log_path.open("w") as fh:
            procs.append(((arch, shape, multi_pod), subprocess.Popen(
                cmd, cwd=ROOT, stdout=fh, stderr=subprocess.STDOUT,
                env={**os.environ, "PYTHONPATH": str(ROOT / "src")}),
                log_path))
    return procs


def _finish_dry_cells(procs, t_start) -> None:
    """Wait for phase 13 (c)'s cells (killed past ``DRY_CELL_TIMEOUT`` s
    from their start); each must exit 0 and write FLOPs and collective
    bytes above zero.  Prints each cell's predicted HBM a card, roofline
    terms and model/counted FLOPs."""
    from repro_torch.launch.dryrun import OUT_DIR, cell_name

    for (arch, shape, mp_), proc, log_path in procs:
        left = DRY_CELL_TIMEOUT - (time.perf_counter() - t_start)
        try:
            rc = proc.wait(timeout=max(1.0, left))
        except subprocess.TimeoutExpired:
            for _, p, _ in procs:
                p.kill()
                p.wait()
            fail(f"phase 13 (c): {arch} {shape} did not end within "
                 f"{DRY_CELL_TIMEOUT} s")
        name = cell_name(arch, shape, mp_)
        if rc != 0:
            fail(f"phase 13 (c): {name} exited {rc}:\n"
                 f"{log_path.read_text()[-3000:]}")
        rec = json.loads((OUT_DIR / f"{name}.json").read_text())
        flops, coll = rec["cost"]["flops"], rec["collectives"]["total_bytes"]
        rf = rec["roofline"]
        log(f"[phase13] (c) {name} in {time.perf_counter() - t_start:.1f} s "
            f"(lay out {rec['lower_s']} s, step {rec['compile_s']} s), "
            f"{rec['n_chips']} ranks; PREDICTED from the H100's published "
            f"figures, not measured: HBM {rec['hbm_per_device_gib']} GiB a "
            f"card (arguments {rec['memory']['argument_size_in_bytes']:,} "
            f"B, temp {rec['memory']['temp_size_in_bytes']:,} B), dot FLOPs "
            f"{flops:.4e} a card, bytes {rec['cost']['bytes']:.4e}, "
            f"collectives {coll:.4e} B {rec['collectives']['count_by_op']}"
            f" ({rec['collectives']['inter_node_bytes']:.4e} B across "
            f"nodes); roofline compute at the {rf['peak_dtype']} peak "
            f"{rf['t_compute_s']:.4e} s, memory "
            f"{rf['t_memory_s']:.4e} s, collective {rf['t_collective_s']:.4e}"
            f" s ({rf['dominant']}); model/counted FLOPs "
            f"{rec['model_vs_hlo_flops']:.4f}")
        if not (flops > 0 and coll > 0):
            fail(f"phase 13 (c): {name} counted FLOPs {flops}, collective "
                 f"bytes {coll}")


def _mem_ok(tag, predicted, measured) -> None:
    err = abs(predicted - measured) / measured
    log(f"[phase13] {tag}: predicted {predicted:,} B, card {measured:,} B "
        f"({100 * err:.2f} % apart, tol {100 * DRY_MEM_TOL:g} %)")
    if err > DRY_MEM_TOL:
        fail(f"phase 13 {tag}: predicted {predicted} B, card {measured} B")


def phase_dryrun(dev, serve_cfg=None, train_cfg=None) -> None:
    """Phase 13: the dry run (``launch.dryrun``: meta tensors over a fake
    process group) against the card (``serve_cfg``/``train_cfg`` replace
    the full configs for a rehearsal on the CPU, where the peaks are not
    checked).  (a) Phase 12 (b)'s granite on two gloo ranks sharing the
    card: a prefill of phase 8's longest prompt and one decode step, each
    counted by ``common.profiling`` on the card and laid out on meta over
    a fake group of 2: argument bytes, dot FLOPs and collectives by kind
    (count and bytes) equal, the predicted temp within ``DRY_MEM_TOL`` of
    the card's peak above its arguments; exact flash and decode launches
    by shape in each rank.  (b) Phase 11's tinyllama step as DTensors on
    one NCCL rank, mesh (1, 1): its loss == the unsharded loss of the
    same weights and batch (``LOGIT_TOL``), argument bytes equal, the
    predicted peak within ``DRY_MEM_TOL`` of ``max_memory_allocated``.
    (c) ``DRY_CELLS`` through the dry-run CLI, run meanwhile on the host."""
    import gc
    import shutil
    import tempfile

    import torch

    from repro_torch.common.config import TrainConfig, get_config
    from repro_torch.common.sharding import local_mesh
    from repro_torch.launch import dryrun
    from repro_torch.models.api import build_model
    from repro_torch.training.optimizer import state_specs
    from repro_torch.training.train_step import make_train_step

    t_phase = time.perf_counter()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix="phase13_")
    cells = _start_dry_cells(tmp)
    try:
        # (a) granite on two gloo ranks against a fake group of 2
        cfg = serve_cfg or get_config(DIST_ARCH).with_overrides(
            n_layers=DIST_LAYERS)
        lens = fam_prompts(DIST_ARCH)
        from repro_torch.launch.serve import make_requests

        prompt = list(make_requests(cfg, len(lens), FAM_NEW,
                                    prompt_lens=lens, seed=SEED)
                      [lens.index(max(lens))].prompt)
        ranks = _spawn(_dry_serve_worker, 2, tmp, "phase13a", "gloo",
                       dev.type, cfg, DIST_ATTNREP, DIST_SMATTN, prompt)
        with dryrun.fake_group(2):
            mesh = local_mesh((1, 2), device=dev.type)
            b = build_model(cfg, mesh=mesh, rules=DIST_ATTNREP,
                            **DIST_SMATTN, compute_dtype=torch.float32)
            meta = torch.device("meta")
            dry, _ = _dry_serve_calls(
                b, b.abstract_params(torch.float32),
                b.abstract(b.cache_specs(1, dense_T(len(prompt), FAM_NEW),
                                          torch.float32), torch.float32),
                len(prompt), meta)
        want, want_shapes = _dist_expected(cfg, [len(prompt)], False)
        for rank, r in enumerate(ranks):
            for call in ("prefill", "decode"):
                got, pred = r["reps"][call], dry[call]
                log(f"[phase13] (a) rank {rank} {call}: card dot FLOPs "
                    f"{got['flops']:.6e} (dry run {pred['flops']:.6e}), "
                    f"collectives {got['count_by_op']} {got['bytes_by_op']} "
                    f"(dry run {pred['count_by_op']} {pred['bytes_by_op']}), "
                    f"arguments {got['memory']['argument_size_in_bytes']:,} B "
                    f"(dry run {pred['memory']['argument_size_in_bytes']:,})")
                for key in ("flops", "count_by_op", "bytes_by_op"):
                    if got[key] != pred[key]:
                        fail(f"phase 13 (a) rank {rank} {call}: {key} "
                             f"{got[key]} on the card, {pred[key]} dry")
                if got["memory"]["argument_size_in_bytes"] != \
                        pred["memory"]["argument_size_in_bytes"]:
                    fail(f"phase 13 (a) rank {rank} {call}: arguments differ")
                if r["peaks"][call] is not None:
                    _mem_ok(f"(a) rank {rank} {call} temp",
                            pred["memory"]["temp_size_in_bytes"],
                            r["peaks"][call])
            log(f"[phase13] (a) rank {rank} kernel launches {r['launches']}"
                f", expected {want}; by shape {r['shapes']}, expected "
                f"{want_shapes}")
            if r["launches"] != want or r["shapes"] != want_shapes:
                fail(f"phase 13 (a) rank {rank}: launches {r['launches']} "
                     f"{r['shapes']} != {want} {want_shapes}")

        # (b) tinyllama's train step on one NCCL rank, mesh (1, 1)
        tcfg_ = train_cfg or get_config(TRAIN_ARCH)
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        (t,) = _spawn(_dry_train_worker, 1, tmp, "phase13b",
                      "nccl" if dev.type == "cuda" else "gloo", dev.type,
                      tcfg_)
        with dryrun.fake_group(1):
            mesh = local_mesh((1, 1), device=dev.type)
            b = build_model(tcfg_, mesh=mesh, remat="none",
                            compute_dtype=torch.float32)
            tcfg = TrainConfig(**TRAIN_TCFG)
            state = b.abstract(state_specs(b.specs, tcfg), torch.float32)
            batch = {k: torch.empty(shape, dtype=dt, device="meta")
                     for k, (shape, dt) in t["batch"].items()}
            _, pred, _ = _counted(make_train_step(b, tcfg), state, batch,
                                  dev=torch.device("meta"))
        got = t["rep"]
        d_loss = abs(t["loss"] - t["plain"])
        log(f"[phase13] (b) {tcfg_.name} train step on a (1, 1) mesh: loss "
            f"{t['loss']:.6f}, unsharded {t['plain']:.6f} (|d| {d_loss:.3e}, "
            f"tol {LOGIT_TOL:g}); card dot FLOPs {got['flops']:.6e} (dry run "
            f"{pred['flops']:.6e}); arguments "
            f"{got['memory']['argument_size_in_bytes']:,} B (dry run "
            f"{pred['memory']['argument_size_in_bytes']:,})")
        if d_loss > LOGIT_TOL:
            fail(f"phase 13 (b): loss {t['loss']} vs unsharded {t['plain']}")
        if got["memory"]["argument_size_in_bytes"] != \
                pred["memory"]["argument_size_in_bytes"]:
            fail("phase 13 (b): argument bytes differ")
        if t["peak"] is not None:
            _mem_ok("(b) peak", pred["memory"]["total_bytes"], t["peak"])

        _finish_dry_cells(cells, t_phase)
    finally:
        for _, proc, _ in cells:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)


# --------------------------------------------------------------------------
# phase 14: the recurrent families on a mesh
# --------------------------------------------------------------------------

def _comm_kinds(comm) -> dict:
    """``CommDebugMode``'s counts by kind: all_reduce, all_gather and
    all_to_all, the c10d and functional ops alike."""
    out = {"all_reduce": 0, "all_gather": 0, "all_to_all": 0}
    for op, n in comm.get_comm_counts().items():
        name = str(op).replace("_", "")
        kind = next((k for k in out if k.replace("_", "") in name), None)
        if kind is None:
            fail(f"phase 14: a collective of no expected kind: {op}")
        out[kind] += int(n)
    return out


def _mesh_comms(cfg, rules, dev_type) -> dict:
    """One rank's collectives by kind at a prefill and at a decode step of
    phase 14's layout (mesh (1, 2), ``rules``), derived from the code: the
    vocab-sharded embedding's psum; a Mamba2 block's two (``out_norm``'s
    sums, ``w_out``'s partial products); a shared-attention call's o-proj
    and MLP psums, k and v gathered over the heads into the sequence-
    sharded cache, and at a decode step the cache moved from sequence- to
    head-sharded for the decode kernel (an all_to_all on a CUDA mesh, an
    all-gather on the CPU's); an mLSTM block's three (q|k|v|i|f, the
    norm, ``w_down``); an sLSTM block's output and new state gathered over
    the heads where they split, its FFN's hidden psum where "mlp" splits
    it, else its norm's and ``ffn_up``'s psums over the heads' columns."""
    from repro_torch.common.sharding import merge_rules, spec_for

    rules = merge_rules(rules)
    sizes = {"data": 1, "model": 2}

    def split(shape, axes):
        return any(e is not None for e in spec_for(shape, axes, rules, sizes))

    d = cfg.d_model
    n = {"all_reduce": int(split((cfg.vocab_size, d), ("vocab", "embed"))),
         "all_gather": 0, "all_to_all": 0}
    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.n_mamba_per_super
        d_in = cfg.mamba_expand * d
        if not (split((d, d_in), (None, "ssm_inner"))
                and split((d, cfg.n_heads, cfg.head_dim), (None, "heads", None))
                and split((1, 8, 1, 1), (None, "cache_seq", None, None))):
            fail(f"phase 14: {rules} is not the layout _mesh_comms counts")
        n["all_reduce"] += 2 * cfg.n_layers + 2 * n_attn
        n["all_gather"] += 2 * n_attn
        pre, dec = dict(n), dict(n)
        dec["all_gather" if dev_type == "cpu" else "all_to_all"] += 2 * n_attn
        return {"prefill": pre, "decode": dec}
    groups = cfg.n_layers // (cfg.mlstm_to_slstm + 1)
    d_ff = int(cfg.slstm_proj_factor * d)
    heads = split((cfg.n_heads,), ("ssm_heads",))
    mlp = split((d, d_ff), (None, "mlp"))
    n["all_reduce"] += 3 * groups * cfg.mlstm_to_slstm
    n["all_reduce"] += groups * (1 if mlp or not heads else 2)
    n["all_gather"] += 2 * groups * heads
    return {"prefill": n, "decode": dict(n)}


def _mesh_expected(cfg, dev_type, T_of) -> tuple[dict, dict]:
    """One rank's exact kernel launches on phase 14's main path, by
    kernel and by call shape: zamba2's SSD once a Mamba2 block a prefill
    on 56 of 112 heads, flash once a shared-attention call a prefill and
    the decode kernel once a call a step, on 16 of 32 heads over the
    request's whole cache (``T_of(prompt)``); xlstm's sLSTM prefill and
    one-step kernels once an sLSTM block a call, on 2 of 4 heads.  None
    on the CPU, where the wrappers take their plain versions."""
    from repro_torch.kernels import ops

    want = dict.fromkeys(ops.LAUNCHES, 0)
    shapes = {k: {} for k in ops.SHAPE_LAUNCHES}
    if dev_type != "cuda":
        return want, shapes

    def add(kernel, key, n):
        want[kernel] += n
        shapes[kernel][key] = shapes[kernel].get(key, 0) + n

    if cfg.family == "hybrid":
        n_attn = cfg.n_layers // cfg.n_mamba_per_super
        H_, D_ = cfg.n_heads // 2, cfg.head_dim
        for key, n in expected_ssd_shapes(cfg, MESH_PROMPTS, ranks=2).items():
            add("ssd_intra_chunk", key, n)
        for S_ in MESH_PROMPTS:
            add("flash_attention", (1, S_, S_, H_, H_, D_, True, 0), n_attn)
            add("decode_attention", (1, T_of(S_), H_, H_, D_, 0),
                n_attn * MESH_STEPS)
    else:
        groups = cfg.n_layers // (cfg.mlstm_to_slstm + 1)
        H_ = cfg.n_heads // 2
        hd = cfg.d_model // cfg.n_heads
        for S_ in MESH_PROMPTS:
            add("slstm_scan", (1, S_, H_, hd), groups)
            add("slstm_scan_s1", (1, 1, H_, hd), groups * MESH_STEPS)
    return want, shapes


def _mesh_prompts(cfg) -> list[list[int]]:
    from repro_torch.launch.serve import make_requests

    return [list(r.prompt) for r in make_requests(
        cfg, len(MESH_PROMPTS), MESH_STEPS + 1,
        prompt_lens=list(MESH_PROMPTS), seed=SEED)]


def _rec_mesh_worker(rank, world, init, dev_type, cfg, rules, out):
    """One rank of phase 14 (a) or (b), in a spawned process: its gloo
    group (a file rendezvous), the (1, world) mesh, the model (each
    weight leaf drawn whole from seed 0 on the card, this rank's slice
    kept), then the main path with the kernel counts from 0, each call
    under ``CommDebugMode``: each prompt prefilled and stepped
    ``MESH_STEPS`` times.  Then the longest prompt's first step against a
    fresh prefill, and the model cut to ``MESH_CUT`` layers over the
    first prompt.  Writes its results to ``out``/rank<r>.pt."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.common.sharding import local_mesh
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        mesh = local_mesh((1, world), device=dev.type)
        b = build_model(cfg, mesh=mesh, rules=rules,
                        compute_dtype=torch.float32)
        params = b.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
        res = {"held": sum(t.to_local().numel() * t.to_local().element_size()
                           for t in tree_leaves(params))}
        prompts = _mesh_prompts(cfg)
        sync()
        dist.barrier()
        ops.reset_launches()
        calls = []
        t0 = time.perf_counter()
        runs = [_dist_generate(b, params, p, MESH_STEPS + 1, dev, calls)
                for p in prompts]
        res["wall"] = time.perf_counter() - t0
        res["launches"] = dict(ops.LAUNCHES)
        res["shapes"] = f32_shapes()
        res["calls"] = calls
        res["tokens"] = [r[0] for r in runs]
        res["logits"] = [torch.stack(r[1]) for r in runs]
        res["prefill_s"] = [r[2] for r in runs]
        res["step_s"] = [t for r in runs for t in r[3]]
        # the longest prompt's first decode step == a fresh prefill of
        # the prompt and its first token
        longest, toks = prompts[-1], runs[-1][0]
        fresh = _dist_generate(b, params, longest + toks[:1], 1, dev)[1][0]
        res["decode_vs_prefill"] = _err(runs[-1][1][1], fresh)
        sync()
        if dev.type == "cuda":
            res["peak"] = torch.cuda.max_memory_allocated()
        del params
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        cfg2 = cfg.with_overrides(n_layers=MESH_CUT[cfg.name])
        b2 = build_model(cfg2, mesh=mesh, rules=rules,
                         compute_dtype=torch.float32)
        p2 = b2.init(torch.Generator(device=dev).manual_seed(SEED),
                     device=dev)
        res["cut"] = _dist_generate(b2, p2, prompts[0], 2, dev)[:2]
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_recurrent_mesh(dev, cfgs=None) -> dict:
    """Phase 14: zamba2-7b and xlstm-1.3b at full width and depth on two
    gloo ranks sharing the card, mesh (1, 2), the serving rules (``cfgs``
    replaces the full configs for a rehearsal on the CPU).  For each: the
    unsharded bundle of the same weights in the main process first (then
    freed); the ranks' tokens equal to it and every step's logits within
    ``LOGIT_TOL``; decode == a fresh prefill within ``DECODE_TOL``; exact
    kernel launches by call shape in each rank; every prefill's and every
    decode step's collectives by kind equal to ``_mesh_comms`` (and the
    gather of its logits); the cut to ``MESH_CUT`` layers == the mesh
    path on the CPU (a world of one, gloo) within ``LOGIT_TOL``.  Prints each
    rank's held weights, peak memory, prefill ms and ms a decode step.
    Returns each arch's rank-0 launches by kernel and shape (the kernels
    line's per-rank rows)."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.common.config import get_config
    from repro_torch.common.sharding import local_mesh
    from repro_torch.models.api import build_model

    cfgs = cfgs or [get_config(a) for a in MESH_ARCHS]
    tmp = tempfile.mkdtemp(prefix="phase14_")
    paths = {}
    try:
        for cfg in cfgs:
            rules = MESH_RULES[cfg.name]
            prompts = _mesh_prompts(cfg)
            # the unsharded bundle on the same weights, then freed
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            b = build_model(cfg, compute_dtype=torch.float32)
            params = b.init(torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
            plain = [_dist_generate(b, params, p, MESH_STEPS + 1, dev)[:2]
                     for p in prompts]
            n_params = b.param_count()
            del b, params
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            join = _start(_rec_mesh_worker, 2, tmp, f"phase14_{cfg.name}",
                          dev.type, cfg, rules)
            # meanwhile on the host: the cut through the mesh path on the
            # CPU (a world of one, gloo)
            cfg2 = cfg.with_overrides(n_layers=MESH_CUT[cfg.name])
            dist.init_process_group(
                "gloo", init_method=f"file://{tmp}/{cfg.name}_cpu.init",
                rank=0, world_size=1)
            try:
                mesh = local_mesh((1, 1), device="cpu")
                b2 = build_model(cfg2, mesh=mesh, rules=rules,
                                 compute_dtype=torch.float32)
                p2 = b2.init(torch.Generator(device=dev).manual_seed(SEED),
                             device="cpu")
                cpu_toks, cpu_logits, _, _ = _dist_generate(
                    b2, p2, prompts[0], 2, torch.device("cpu"))
                del b2, p2
            finally:
                dist.destroy_process_group()
            ranks = join()
            comms = _mesh_comms(cfg, rules, dev.type)
            # each call of the main path also gathers its logits once
            per_call = {kind: {k: v + (k == "all_gather")
                               for k, v in want_.items()}
                        for kind, want_ in comms.items()}
            want, want_shapes = _mesh_expected(
                cfg, dev.type, lambda S_: dense_T(S_, MESH_STEPS + 1))
            peak_sum = 0
            for rank, r in enumerate(ranks):
                steps = len(r["step_s"])
                peak_sum += r.get("peak", 0)
                log(f"[phase14] {cfg.name} rank {rank}/2 (rules {rules}): "
                    f"{cfg.n_layers} layers, {n_params:,} parameters, this "
                    f"rank holds {r['held'] / 1e9:.3f} GB of weights, peak "
                    f"{r.get('peak', 0) / 1e9:.2f} GB (the weights' draw "
                    f"included); main path {r['wall']:.2f} s: prefills "
                    f"{', '.join(f'{1e3 * t:.1f}' for t in r['prefill_s'])} "
                    f"ms (prompts {list(MESH_PROMPTS)}), {steps} decode "
                    f"steps {1e3 * sum(r['step_s']) / steps:.1f} ms a step")
                total = {k: sum(c[k] for _, c in r["calls"])
                         for k in per_call["prefill"]}
                odd = [(kind, c) for kind, c in r["calls"]
                       if c != per_call[kind]]
                log(f"[phase14] {cfg.name} rank {rank} collectives over "
                    f"{len(r['calls'])} calls {total}; each prefill "
                    f"{comms['prefill']} and each decode step "
                    f"{comms['decode']} expected, + its logits' gather: "
                    f"{'every call as expected' if not odd else odd}")
                if odd:
                    fail(f"phase 14 {cfg.name} rank {rank}: calls' "
                         f"collectives {odd} != {per_call}")
                log(f"[phase14] {cfg.name} rank {rank} kernel launches "
                    f"{r['launches']}, expected {want}; by shape "
                    f"{ {k: v for k, v in r['shapes'].items() if v} }, "
                    f"expected { {k: v for k, v in want_shapes.items() if v} }")
                if r["launches"] != want or r["shapes"] != want_shapes:
                    fail(f"phase 14 {cfg.name} rank {rank}: launches "
                         f"{r['launches']} {r['shapes']} != {want} "
                         f"{want_shapes}")
            worst = 0.0
            for i, (toks, lg) in enumerate(plain):
                for rank, r in enumerate(ranks):
                    if r["tokens"][i] != toks:
                        fail(f"phase 14 {cfg.name} prompt {i} rank {rank}: "
                             f"tokens {r['tokens'][i]}, unsharded {toks}")
                    if not bool(torch.isfinite(r["logits"][i]).all()):
                        fail(f"phase 14 {cfg.name}: non-finite logits")
                    worst = max(worst, _err(r["logits"][i],
                                            torch.stack(lg)))
            log(f"[phase14] {cfg.name} mesh (1, 2) == unsharded: "
                f"{len(prompts)} prompts' tokens equal "
                f"({[t for t, _ in plain]}), every step's logits max "
                f"|dlogit| {worst:.3e} (tol {LOGIT_TOL:g})")
            if worst > LOGIT_TOL:
                fail(f"phase 14 {cfg.name}: mesh logits differ by {worst:.3e}")
            dvp = max(r["decode_vs_prefill"] for r in ranks)
            log(f"[phase14] {cfg.name} the {len(prompts[-1])}-token prompt's "
                f"first decode step == a fresh prefill of it + its token: max "
                f"|dlogit| {dvp:.3e} (tol {DECODE_TOL:g})")
            if dvp > DECODE_TOL:
                fail(f"phase 14 {cfg.name}: decode differs from a fresh "
                     f"prefill by {dvp:.3e}")
            log(f"[phase14] {cfg.name}: the two ranks' peaks sum to "
                f"{peak_sum / 1e9:.2f} GB (card {CARD_BYTES / 1e9:g} GB)")
            if peak_sum > CARD_BYTES:
                fail(f"phase 14 {cfg.name}: peaks sum to {peak_sum} B")

            # the cut against the mesh path on the CPU
            cut = max(_err(torch.stack(r["cut"][1]), torch.stack(cpu_logits))
                      for r in ranks)
            same = all(r["cut"][0] == cpu_toks for r in ranks)
            log(f"[phase14] {cfg.name} at {MESH_CUT[cfg.name]} layers, mesh "
                f"(1, 2) on the card vs the mesh path on the CPU (a world of "
                f"1), prompt {len(prompts[0])} + 1 decode step: tokens "
                f"{'equal' if same else 'DIFFER'}, max |dlogit| {cut:.3e} "
                f"(tol {LOGIT_TOL:g})")
            if cut > LOGIT_TOL or not same:
                fail(f"phase 14 {cfg.name}: the card disagrees with the CPU "
                     f"at {MESH_CUT[cfg.name]} layers")
            paths[f"{cfg.name}-mesh"] = {"launches": ranks[0]["launches"],
                                         "shapes": ranks[0]["shapes"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


# --------------------------------------------------------------------------
# phase 15: paged decode under a mesh
# --------------------------------------------------------------------------

def _pm_cfg(arch):
    from repro_torch.common.config import get_config

    cfg = get_config(arch)
    return cfg.with_overrides(n_layers=PM_LAYERS[arch]) \
        if arch in PM_LAYERS else cfg


def _pm_requests(cfg):
    """Phase 15's four requests: phase 8's prompts, gemma2-9b's fourth
    the 4,100-token one; a VLM's with its image prefix."""
    from repro_torch.launch.serve import make_requests

    lens = prompt_lens(FAM_PROMPTS, FAM_REQS)
    if cfg.name == "gemma2-9b":
        lens = lens[:3] + [G2_LONG]
    return make_requests(cfg, len(lens), FAM_NEW, prompt_lens=lens,
                         seed=SEED)


def _pm_layout(cfg, reqs):
    """The pool of phase 15 from ``serving.kvcache.PagePool``: page 0 the
    dead rows' dummy (as ``DecodeStream`` reserves it), then each
    request's pages for its sequence and the FAM_NEW - 1 tokens its ticks
    write.  Returns (n_pages, each request's pages, the (B, n_max) int32
    tables, each sequence's length)."""
    from repro_torch.serving.kvcache import PagePool

    n_img = cfg.n_image_tokens if cfg.has_vision_stub else 0
    lens = [n_img + len(r.prompt) for r in reqs]
    need = [-(-(n + FAM_NEW - 1) // PAGE) for n in lens]
    pool = PagePool(1 + sum(need), PAGE)
    pool.alloc("<dummy>", 1)
    pages = [pool.alloc(r.rid, n + FAM_NEW - 1) for r, n in zip(reqs, lens)]
    tables = pool.table_array([r.rid for r in reqs], max(need))
    return pool.n_pages, pages, tables, lens


def _pm_batch(cfg, req, dev, extra=()):
    """A request's one-row prefill batch (``extra`` tokens appended)."""
    import torch

    batch = {"tokens": torch.tensor([list(req.prompt) + list(extra)],
                                    dtype=torch.int32, device=dev)}
    if cfg.has_vision_stub:
        batch["image_embeds"] = torch.from_numpy(
            req.inputs["vision"][None]).to(dev)
    return batch


def _pm_generate(bundle, params, cfg, reqs, dev, calls=None):
    """Phase 15's path on a (sharded) bundle: each request prefilled alone
    into a one-row dense cache and copied into the page pool
    (``insert_pages``), then FAM_NEW - 1 batched paged ticks of every row,
    greedy.  Returns (each row's tokens, the logits (B, V) on the host:
    the prefills', then each tick's, each prefill's s, each tick's s).
    With a list ``calls`` each tick (its logits gathered included) runs
    under ``CommDebugMode``."""
    import torch

    from repro_torch.serving.kvcache import insert_pages

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    n_pages, pages, tables, lens = _pm_layout(cfg, reqs)
    pool = bundle.init_paged_cache(n_pages, PAGE, torch.float32, dev)
    first, pre_s = [], []
    for r, pg, n in zip(reqs, pages, lens):
        one = bundle.init_cache(1, len(pg) * PAGE, torch.float32, dev)
        sync()
        t0 = time.perf_counter()
        lg, one = bundle.prefill(params, _pm_batch(cfg, r, dev), one)
        insert_pages(pool, one, pg, n)
        lg = _whole(lg)
        sync()
        pre_s.append(time.perf_counter() - t0)
        first.append(lg[0].cpu())
        del one
    logits = [torch.stack(first)]
    toks = [[int(x.argmax())] for x in first]
    tables = torch.from_numpy(tables).to(dev)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    tick_s = []
    for _ in range(FAM_NEW - 1):
        tok = torch.tensor([[t[-1]] for t in toks], dtype=torch.int32,
                           device=dev)
        t0 = time.perf_counter()
        with _comm_counted(calls, "tick"):
            lg, pool = bundle.paged_decode_step(params, tok, pool, tables,
                                                lengths)
            lg = _whole(lg)
        sync()
        tick_s.append(time.perf_counter() - t0)
        logits.append(lg.cpu())
        for t, x in zip(toks, lg):
            t.append(int(x.argmax()))
        lengths = lengths + 1
    return toks, logits, pre_s, tick_s


def _pm_comms(cfg, rules) -> dict:
    """One rank's collectives by kind at a paged tick of phase 15's layout
    (mesh (1, 2), ``rules``), derived from the code: the vocab-sharded
    embedding's psum and the logits' gather where the vocabulary splits;
    per attention layer q, k and v gathered to every row and head
    (``_whole``: the pool holds every row's keys and every kv head), the
    combine's max and two sums (``paged_decode_attention_shardmap``), the
    o-proj's and the MLP's psums."""
    from repro_torch.common.sharding import merge_rules, spec_for

    rules = merge_rules(rules)
    sizes = {"data": 1, "model": 2}

    def split(shape, axes):
        return any(e is not None for e in spec_for(shape, axes, rules, sizes))

    d, L = cfg.d_model, cfg.n_layers
    if not (split((d, cfg.n_heads, cfg.head_dim), (None, "heads", None))
            and split((d, cfg.n_kv_heads, cfg.head_dim),
                      (None, "kv_heads", None))
            and split((d, cfg.d_ff), (None, "mlp"))
            and split((8, PAGE, 1, 1), (None, "cache_seq", None, None))):
        fail(f"phase 15: {rules} is not the layout _pm_comms counts")
    vocab = int(split((cfg.vocab_size, d), ("vocab", "embed")))
    return {"all_reduce": vocab + 5 * L, "all_gather": vocab + 3 * L,
            "all_to_all": 0}


def _pm_expected(cfg, reqs, n_pages, n_max, dev_type) -> tuple[dict, dict]:
    """One rank's exact launches on phase 15's main path, by kernel and by
    call shape: flash once a layer a prefill on the rank's heads (H / 2
    and K / 2; a local layer's with its window), the tile mode once a
    layer a tick over the rank's tile (every row, every head, 8 of 16
    slots of every page).  None on the CPU."""
    from repro_torch.kernels import ops

    want = dict.fromkeys(ops.LAUNCHES, 0)
    shapes = {k: {} for k in ops.SHAPE_LAUNCHES}
    if dev_type != "cuda":
        return want, shapes

    def add(kernel, key, n):
        want[kernel] += n
        shapes[kernel][key] = shapes[kernel].get(key, 0) + n

    H_, K_, D_ = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_img = cfg.n_image_tokens if cfg.has_vision_stub else 0
    pat = cfg.attn_pattern or ("global",)
    for kind in pat:
        w = cfg.sliding_window if kind == "local" else 0
        n = cfg.n_layers // len(pat)
        for r in reqs:
            S_ = n_img + len(r.prompt)
            add("flash_attention", (1, S_, S_, H_ // 2, K_ // 2, D_, True, w),
                n)
        add("paged_decode_attention",
            (len(reqs), n_max, PAGE // 2, H_, K_, D_, w, n_pages, PAGE),
            n * (FAM_NEW - 1))
    return want, shapes


def _pm_worker(rank, world, init, dev_type, cfg, reqs, out):
    """One rank of phase 15, in a spawned process: its gloo group (a file
    rendezvous), the (1, world) mesh, the model (each weight leaf drawn
    whole from seed 0 on the card, this rank's slice kept), the main path
    with the kernel counts from 0 (each tick under ``CommDebugMode``), then
    the longest request's first tick against a fresh prefill of it and
    its token, and internvl2-1b cut to PM_CPU_LAYERS.  Writes its results
    to ``out``/rank<r>.pt."""
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    import torch.distributed as dist

    import repro_torch  # noqa: F401  (sets the float32 matmul precision)
    from repro_torch.common.pytree import tree_leaves
    from repro_torch.common.sharding import local_mesh
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    dev = torch.device(dev_type, 0) if dev_type == "cuda" else \
        torch.device("cpu")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=f"file://{init}", rank=rank,
                            world_size=world)
    try:
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()
        mesh = local_mesh((1, world), device=dev.type)
        b = build_model(cfg, mesh=mesh, rules=PM_RULES,
                        compute_dtype=torch.float32)
        params = b.init(torch.Generator(device=dev).manual_seed(SEED),
                        device=dev)
        res = {"held": sum(t.to_local().numel() * t.to_local().element_size()
                           for t in tree_leaves(params))}
        # this rank's tile of a layer's pool leaf: (pages, slots, K, D)
        pool = b.init_paged_cache(_pm_layout(cfg, reqs)[0], PAGE,
                                  device=dev, dtype=torch.float32)
        res["tile"] = tuple(tree_leaves(pool)[0].to_local().shape[1:])
        del pool
        if dev.type == "cuda":
            torch.cuda.synchronize()
        dist.barrier()
        ops.reset_launches()
        calls = []
        t0 = time.perf_counter()
        toks, logits, pre_s, tick_s = _pm_generate(b, params, cfg, reqs, dev,
                                                   calls)
        res["wall"] = time.perf_counter() - t0
        res["launches"] = dict(ops.LAUNCHES)
        res["shapes"] = f32_shapes()
        res.update(calls=calls, tokens=toks, logits=logits, prefill_s=pre_s,
                   tick_s=tick_s)
        # the longest request's first tick == a fresh prefill of its prompt
        # and its first token
        i = max(range(len(reqs)), key=lambda j: len(reqs[j].prompt))
        n_img = cfg.n_image_tokens if cfg.has_vision_stub else 0
        T = dense_T(n_img + len(reqs[i].prompt) + 1, 0)
        fresh, _ = b.prefill(params, _pm_batch(cfg, reqs[i], dev,
                                               toks[i][:1]),
                             b.init_cache(1, T, torch.float32, dev))
        res["decode_vs_prefill"] = _err(logits[1][i], _whole(fresh)[0].cpu())
        if dev.type == "cuda":
            torch.cuda.synchronize()
            res["peak"] = torch.cuda.max_memory_allocated()
        del params, fresh
        if dev.type == "cuda":
            torch.cuda.empty_cache()
        if cfg.name == "internvl2-1b":
            cfg2 = cfg.with_overrides(n_layers=PM_CPU_LAYERS)
            b2 = build_model(cfg2, mesh=mesh, rules=PM_RULES,
                             compute_dtype=torch.float32)
            p2 = b2.init(torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
            res["cut"] = _pm_generate(b2, p2, cfg2, reqs, dev)[:2]
        torch.save(res, Path(out) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def phase_paged_mesh(dev, cfgs=None) -> dict:
    """Phase 15: internvl2-1b (full width and depth) and gemma2-9b (full
    width, PM_LAYERS) on two gloo ranks sharing the card, mesh (1, 2), the
    serving rules, through ``build_model(cfg, mesh=, rules=)``'s
    ``init_paged_cache`` and ``paged_decode_step`` and ``insert_pages``
    (``cfgs`` replaces the configs for a rehearsal on the CPU).  For each:
    the unsharded bundle of the same weights runs phase 15's path in the
    main process first (then freed); the ranks' tokens equal to it and
    every step's logits within ``LOGIT_TOL``; the first tick == a fresh
    prefill within ``DECODE_TOL``; exact launches by call shape in each
    rank (the tile mode at its tile's shape, the checker's case of
    TILE_ROWS); every tick's collectives by kind == ``_pm_comms``; the ranks' peaks below
    the card's 80 GB; internvl2-1b cut to PM_CPU_LAYERS == the mesh path
    on the CPU (a world of one, gloo) within ``LOGIT_TOL``.  Prints each
    rank's held and peak GB, prefill ms and ms a tick.  Returns each
    arch's rank-0 launches by kernel and shape."""
    import gc
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from repro_torch.common.sharding import local_mesh
    from repro_torch.models.api import build_model

    cfgs = cfgs or [_pm_cfg(a) for a in PM_ARCHS]
    tmp = tempfile.mkdtemp(prefix="phase15_")
    paths = {}
    try:
        for cfg in cfgs:
            reqs = _pm_requests(cfg)
            n_pages, pages, tables, lens = _pm_layout(cfg, reqs)
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            b = build_model(cfg, compute_dtype=torch.float32)
            params = b.init(torch.Generator(device=dev).manual_seed(SEED),
                            device=dev)
            plain = _pm_generate(b, params, cfg, reqs, dev)
            n_params = b.param_count()
            del b, params
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            join = _start(_pm_worker, 2, tmp, f"phase15_{cfg.name}",
                          dev.type, cfg, reqs)
            cpu = None
            if cfg.name == "internvl2-1b":
                # meanwhile on the host: the cut through the mesh path on
                # the CPU (a world of one, gloo)
                cfg2 = cfg.with_overrides(n_layers=PM_CPU_LAYERS)
                dist.init_process_group(
                    "gloo", init_method=f"file://{tmp}/{cfg.name}_cpu.init",
                    rank=0, world_size=1)
                try:
                    b2 = build_model(cfg2, mesh=local_mesh((1, 1),
                                                           device="cpu"),
                                     rules=PM_RULES, compute_dtype=torch.float32)
                    p2 = b2.init(torch.Generator(device=dev).manual_seed(
                        SEED), device="cpu")
                    cpu = _pm_generate(b2, p2, cfg2, reqs,
                                       torch.device("cpu"))[:2]
                    del b2, p2
                finally:
                    dist.destroy_process_group()
            ranks = join()
            per_tick = _pm_comms(cfg, PM_RULES)
            want, want_shapes = _pm_expected(cfg, reqs, n_pages,
                                             tables.shape[1], dev.type)
            peak_sum = 0
            for rank, r in enumerate(ranks):
                peak_sum += r.get("peak", 0)
                ticks = len(r["tick_s"])
                log(f"[phase15] {cfg.name} rank {rank}/2 (rules {PM_RULES}): "
                    f"{cfg.n_layers} layers, {n_params:,} parameters, this "
                    f"rank holds {r['held'] / 1e9:.3f} GB of weights, peak "
                    f"{r.get('peak', 0) / 1e9:.2f} GB; a pool of {n_pages} "
                    f"pages of {PAGE}, its tile {r['tile']} a layer; main "
                    f"path {r['wall']:.2f} s: prefills "
                    f"{', '.join(f'{1e3 * t:.1f}' for t in r['prefill_s'])} "
                    f"ms (sequences {lens}), {ticks} ticks of {len(reqs)} "
                    f"rows {1e3 * sum(r['tick_s']) / ticks:.1f} ms a tick")
                odd = [c for kind, c in r["calls"] if c != per_tick]
                log(f"[phase15] {cfg.name} rank {rank} collectives over "
                    f"{len(r['calls'])} ticks: each {per_tick} expected: "
                    f"{'every tick as expected' if not odd else odd}")
                if odd or len(r["calls"]) != FAM_NEW - 1:
                    fail(f"phase 15 {cfg.name} rank {rank}: ticks' "
                         f"collectives {r['calls']} != {per_tick}")
                log(f"[phase15] {cfg.name} rank {rank} kernel launches "
                    f"{r['launches']}, expected {want}; by shape "
                    f"{ {k: v for k, v in r['shapes'].items() if v} }, "
                    f"expected { {k: v for k, v in want_shapes.items() if v} }")
                if r["launches"] != want or r["shapes"] != want_shapes:
                    fail(f"phase 15 {cfg.name} rank {rank}: launches "
                         f"{r['launches']} {r['shapes']} != {want} "
                         f"{want_shapes}")
            worst = 0.0
            for rank, r in enumerate(ranks):
                if r["tokens"] != plain[0]:
                    fail(f"phase 15 {cfg.name} rank {rank}: tokens "
                         f"{r['tokens']}, unsharded {plain[0]}")
                for got, ref_ in zip(r["logits"], plain[1], strict=True):
                    if not bool(torch.isfinite(got).all()):
                        fail(f"phase 15 {cfg.name}: non-finite logits")
                    worst = max(worst, _err(got, ref_))
            log(f"[phase15] {cfg.name} mesh (1, 2) paged == the unsharded "
                f"paged step: {len(reqs)} rows' tokens equal "
                f"({plain[0]}), every step's logits max |dlogit| "
                f"{worst:.3e} (tol {LOGIT_TOL:g})")
            if worst > LOGIT_TOL:
                fail(f"phase 15 {cfg.name}: mesh logits differ by "
                     f"{worst:.3e}")
            dvp = max(r["decode_vs_prefill"] for r in ranks)
            log(f"[phase15] {cfg.name} the longest request's first paged "
                f"tick == a fresh prefill of it + its token: max |dlogit| "
                f"{dvp:.3e} (tol {DECODE_TOL:g})")
            if dvp > DECODE_TOL:
                fail(f"phase 15 {cfg.name}: a tick differs from a fresh "
                     f"prefill by {dvp:.3e}")
            log(f"[phase15] {cfg.name}: the two ranks' peaks sum to "
                f"{peak_sum / 1e9:.2f} GB (card {CARD_BYTES / 1e9:g} GB)")
            if peak_sum > CARD_BYTES:
                fail(f"phase 15 {cfg.name}: peaks sum to {peak_sum} B")
            if cpu is not None:
                cut = max(_err(g_, c_) for r in ranks
                          for g_, c_ in zip(r["cut"][1], cpu[1], strict=True))
                same = all(r["cut"][0] == cpu[0] for r in ranks)
                log(f"[phase15] {cfg.name} at {PM_CPU_LAYERS} layers, mesh "
                    f"(1, 2) on the card vs the mesh path on the CPU (a "
                    f"world of 1): tokens {'equal' if same else 'DIFFER'}, "
                    f"max |dlogit| {cut:.3e} (tol {LOGIT_TOL:g})")
                if cut > LOGIT_TOL or not same:
                    fail(f"phase 15 {cfg.name}: the card disagrees with the "
                         f"CPU at {PM_CPU_LAYERS} layers")
            paths[f"{cfg.name}-paged-mesh"] = {
                "launches": ranks[0]["launches"], "shapes": ranks[0]["shapes"]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return paths


# --------------------------------------------------------------------------
# phase 16: the reference's bfloat16 compute on the card
# --------------------------------------------------------------------------

# rtol = atol for bfloat16 model outputs (tests/test_kernels.py's bfloat16
# TOLS): serve() vs submit(), decode vs a fresh prefill, card vs CPU, and
# the top-two logit gap under which serve() and submit() may choose
# different tokens (a batched and a batch-1 GEMM round bfloat16 apart)
BF16_TOL = 3e-2
# where a bfloat16 comparison at full depth sits at bfloat16's own noise
# (two bfloat16 runs of one function, rounded apart once, end as far
# apart as either is from float32: ~0.04 on internvl2-1b's logits), it
# is held as tests/test_torch_compute_dtype.py holds the port to the
# reference: against the float32 compute on the same bfloat16 weights,
# the path under test no further from it than BF16_NOISE_MULT times the
# path it is compared with, plus BF16_NOISE_FLOOR
BF16_NOISE_MULT, BF16_NOISE_FLOOR = 2.0, 1e-3
# (b): the longest phase-3 prompt's 16 decode steps on a dense bfloat16
# cache, and 4 of the phase-3 prompts as the rows of a bfloat16 pool of
# pages of PAGE for 8 ticks
B16_STEPS, B16_ROWS, B16_TICKS = 16, 4, 8
# (c): zamba2-7b at full width cut to 8 layers (phases 8 and 12's depth),
# a 200-token prompt and 4 decode steps; card == CPU at 2 layers
Z16_ARCH, Z16_LAYERS, Z16_S, Z16_STEPS = "zamba2-7b", 8, 200, 4
B16_CPU_LAYERS = 2
#: the H100's HBM rate (common.hw), for the weight-read floor
HBM_TBS = 3.35


def _bf16_ratio(got, want) -> float:
    """max |got - want| / (BF16_TOL (1 + |want|)): at most 1 where the two
    agree within rtol = atol = BF16_TOL (inf where got is not finite)."""
    import torch

    g, w = got.float().cpu(), want.float().cpu()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return ((g - w).abs() / (BF16_TOL * (1 + w.abs()))).max().item()


def _rounds_alike(got, peer, oracle) -> tuple[float, float, bool]:
    """(max |got - oracle|, max |peer - oracle|, whether the first is at
    most BF16_NOISE_MULT times the second plus BF16_NOISE_FLOOR): ``got``
    rounds where ``peer`` does, ``oracle`` the float32 compute."""
    d_got, d_peer = _err(got, oracle), _err(peer, oracle)
    return d_got, d_peer, d_got <= BF16_NOISE_MULT * d_peer + BF16_NOISE_FLOOR


def b16_shapes():
    """Phase 16 (b)'s shapes: the longest phase-3 prefill S (its image's
    tokens and prompt), the dense cache's T for B16_STEPS steps, the
    B16_ROWS rows' prefill lengths, the table width n_max (pages a row)
    and the pool's pages (one dummy page, then each row's)."""
    from repro_torch.common.config import get_config
    from repro_torch.s2m3 import Request

    S, _ = serve_shapes()
    rows = [N_IMG + len(r.prompt) for r in
            _workload(get_config("internvl2-1b"), Request)
            if r.prompt is not None][:B16_ROWS]
    n_max = -(-(max(rows) + B16_TICKS + 1) // PAGE)
    return S, dense_T(S, B16_STEPS), rows, n_max, 1 + B16_ROWS * n_max


def b16_tables(n_max, device):
    """(B16_ROWS, n_max) int32: row j's pages, last first (shuffled in the
    pool), 1 + j n_max on."""
    import torch

    return torch.tensor([list(range((j + 1) * n_max, j * n_max, -1))
                         for j in range(B16_ROWS)], dtype=torch.int32,
                        device=device)


def phase_kernels_bf16(dev) -> tuple[list[dict], dict]:
    """The bfloat16 instances at phase 16's shapes, one kernels-line row
    each, held to their plain versions at ``TOL["bfloat16"]``: flash D=64
    at internvl2-1b's longest prefill (phase 16 (a)), decode D=64 over
    (b)'s dense bfloat16 cache at its last step, paged D=64 over (b)'s
    bfloat16 pool at its last tick, and zamba2-7b's flash D=112 over its
    200-token prompt and decode D=112 at its last step ((c)), and flash
    D=256 at gemma2-9b's 4,100-token local layer, which no bf16 path
    runs (its path the tuple of bf16 paths, none of which may run it); the
    library call is SDPA in bfloat16, flex_attention for the D=256 row
    (softcap), none for the paged kernel.  The flash rows also carry their
    flips and the plain version's (``_flips``).  Returns the rows and each
    row's (path, kernel, call shape and dtype)."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels import ops, ref

    bf, dn, isz = torch.bfloat16, "bfloat16", 2
    g = torch.Generator(device=dev).manual_seed(SEED + 16)
    rows, keys = [], {}
    S, T, lens_b, n_max, n_pages = b16_shapes()
    T_z = dense_T(Z16_S, Z16_STEPS)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    for name, path, H_, K_, D_, S_, what in (
            ("flash_attention_bf16", "bf16-serve", H, K, D, S,
             "internvl2-1b prefill"),
            ("flash_attention_d112_bf16", "bf16-zamba2", Z_HEADS, Z_HEADS,
             Z_D, Z16_S, "zamba2-7b shared attention prefill")):
        q = rnd(1, S_, H_, D_)
        k, v = rnd(1, S_, K_, D_), rnd(1, S_, K_, D_)
        what = f"{what}: S={S_} H={H_} K={K_} D={D_}"
        got = ops.flash_attention(q, k, v)
        err = _check("flash_attention", dn, what, got,
                     ref.flash_attention_ref(q, k, v))
        flips = _flips(what, got, q, k, v)
        keys[name] = (path, "flash_attention",
                      (1, S_, S_, H_, K_, D_, True, 0, dn))
        qh, kh, vh = (x.transpose(1, 2) for x in (q, k, v))
        rows.append(flips | _row(
            name, "csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:93", "flash_fwd", err,
            lambda q=q, k=k, v=v: ops.flash_attention(q, k, v),
            lambda q=q, k=k, v=v: ref.flash_attention_ref(q, k, v),
            lambda q=qh, k=kh, v=vh, gqa=H_ != K_:
                F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                               enable_gqa=gqa),
            *_flash_work(1, S_, S_, H_, K_, D_, True, isz), dname=dn))

    # gemma2-9b's local layer at its 4,100-token prefill: the bf16
    # instance at D = 256 under a window and a softcap, which no bf16 path
    # runs (phase 8 serves gemma2-9b in float32); the library call is
    # flex_attention in bf16, timed at a few calls
    name = "flash_attention_d256_local_bf16"
    H_, K_, D_ = FAM_GEOM["gemma2-9b"]
    kw = dict(window=G2_WINDOW, softcap=G2_SOFTCAP)
    q = rnd(1, G2_LONG, H_, D_)
    k, v = rnd(1, G2_LONG, K_, D_), rnd(1, G2_LONG, K_, D_)
    what = f"gemma2-9b local prefill: S={G2_LONG} H={H_} K={K_} D={D_} {kw}"
    got = ops.flash_attention(q, k, v, **kw)
    want = ref.flash_attention_ref(q, k, v, **kw)
    err = _check("flash_attention", dn, what, got, want)
    flips = _flips(what, got, q, k, v, **kw)
    del got
    keys[name] = (BF16_PATHS, "flash_attention",
                  (1, G2_LONG, G2_LONG, H_, K_, D_, True, G2_WINDOW, dn))
    lib = _flex_lib(name, *(x.transpose(1, 2).contiguous() for x in (q, k, v)),
                    want, _g2_prefill_local, G2_LONG, G2_LONG, dn)
    del want
    rows.append(flips | _row(
        name, "csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:93", "flash_fwd", err,
        lambda: ops.flash_attention(q, k, v, **kw),
        lambda: ref.flash_attention_ref(q, k, v, **kw), lib,
        *_flash_work(1, G2_LONG, G2_LONG, H_, K_, D_, True, isz, G2_WINDOW),
        dname=dn, iters=3))

    for name, path, H_, K_, D_, T_, n, what in (
            ("decode_attention_bf16", "bf16-bundle", H, K, D, T,
             S + B16_STEPS, "internvl2-1b dense bfloat16 cache"),
            ("decode_attention_d112_bf16", "bf16-zamba2", Z_HEADS, Z_HEADS,
             Z_D, T_z, Z16_S + Z16_STEPS, "zamba2-7b shared attention")):
        qd = rnd(1, H_, D_)
        kd, vd = rnd(1, T_, K_, D_), rnd(1, T_, K_, D_)
        ld = torch.tensor([n], dtype=torch.int32, device=dev)
        err = _check("decode_attention", dn, f"{what}: T={T_} length {n} "
                     f"H={H_} K={K_} D={D_}",
                     ops.decode_attention(qd, kd, vd, ld),
                     ref.decode_attention_ref(qd, kd, vd, ld))
        keys[name] = (path, "decode_attention", (1, T_, H_, K_, D_, 0, dn))
        mask = (torch.arange(T_, device=dev)[None] < ld[:, None])[
            :, None, None, :]
        rows.append(_row(
            name, "csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:70", "decode_fwd", err,
            lambda q=qd, k=kd, v=vd, l_=ld: ops.decode_attention(q, k, v, l_),
            lambda q=qd, k=kd, v=vd, l_=ld: ref.decode_attention_ref(
                q, k, v, l_),
            lambda q=qd, k=kd, v=vd, m=mask, gqa=H_ != K_:
                F.scaled_dot_product_attention(
                    q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                    attn_mask=m, enable_gqa=gqa),
            *_decode_work(qd, kd, ld, isz), dname=dn))

    qp = rnd(B16_ROWS, H, D)
    kp, vp = rnd(n_pages, PAGE, K, D), rnd(n_pages, PAGE, K, D)
    tables = b16_tables(n_max, dev)
    lens_p = torch.tensor([n + B16_TICKS for n in lens_b], dtype=torch.int32,
                          device=dev)
    owned = torch.arange(n_max, device=dev)[None] * PAGE < lens_p[:, None]
    err = _check("paged_decode_attention", dn,
                 f"internvl2-1b bfloat16 pool: {B16_ROWS} rows, lengths "
                 f"{lens_p.tolist()}",
                 ops.paged_decode_attention(qp, kp, vp, tables, lens_p),
                 ref.paged_decode_attention_ref(qp, kp, vp, tables, lens_p))
    keys["paged_decode_attention_bf16"] = (
        "bf16-bundle", "paged_decode_attention",
        (B16_ROWS, n_max, PAGE, H, K, D, 0, dn))
    rows.append(_row(
        "paged_decode_attention_bf16", "csrc/decode_attention.cu",
        "src/repro/kernels/paged_decode_attention.py:77", "paged_decode_fwd",
        err, lambda: ops.paged_decode_attention(qp, kp, vp, tables, lens_p),
        lambda: ref.paged_decode_attention_ref(qp, kp, vp, tables, lens_p),
        None, *_paged_work(qp, kp, lens_p, owned, isz), dname=dn))
    return rows, keys


def _raw_shapes() -> dict:
    """``ops.SHAPE_LAUNCHES`` with each key's dtype, for phase 16's
    paths, which launch bfloat16 and float32 instances."""
    from repro_torch.kernels import ops

    return {k: dict(v) for k, v in ops.SHAPE_LAUNCHES.items()}


def _exact(tag, launches, shapes, want_shapes) -> None:
    """Launches by kernel and by (shape, dtype) equal to ``want_shapes``
    (kernel -> key -> count); fails otherwise."""
    want = {k: sum(v.values()) for k, v in want_shapes.items()}
    log(f"[phase16] {tag} kernel launches {launches}, expected {want}; by "
        f"shape and dtype { {k: v for k, v in shapes.items() if v} }, "
        f"expected { {k: v for k, v in want_shapes.items() if v} }")
    if launches != want or shapes != want_shapes:
        fail(f"phase 16 {tag}: launches {launches} {shapes} != {want} "
             f"{want_shapes}")


def phase_bf16_serve(dev, f32_rates) -> dict:
    """(a) internvl2-1b at full width and depth, bfloat16 weights (phase
    3's float32 draws cast) and the default compute, on the main path:
    phase 3's deployment and 8 requests through plan -> materialize ->
    serve() and submit().  Routes == simulate(), compare() has no route
    divergence, the pool drains; serve()'s tokens == submit()'s, or where
    they part submit()'s top-two logit gap there is within BF16_TOL;
    every step's logits up to a parting round alike (``_rounds_alike``:
    serve()'s no further from the float32 compute on the same weights,
    submit() there, than BF16_NOISE_MULT times submit()'s), their
    distance logged against rtol = atol = BF16_TOL too; launches
    exact by shape and dtype (flash bfloat16 in prefill; the paged and
    decode kernels' float32 instances, q widened against the engine's
    float32 pool and caches).  The rates beside phase 3's float32 ones."""
    import gc

    import numpy as np
    import torch

    from repro_torch.common.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.s2m3 import Request

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("internvl2-1b")
    dep, bundle, params = _deployment(dev, cfg, bf16=True)
    dep.materialize()
    dtypes = sorted({str(t.dtype) for t in _leaves(params)})
    del params
    torch.cuda.synchronize()
    n_params = bundle.param_count()
    log(f"[phase16] (a) internvl2-1b: {n_params:,} parameters, weights "
        f"{dtypes} ({2 * n_params / 1e9:.2f} GB), compute "
        f"{bundle.compute_dtype}, {cfg.n_layers} layers")
    if dtypes != ["torch.bfloat16"] or bundle.compute_dtype != torch.bfloat16:
        fail(f"(a) weights {dtypes}, compute {bundle.compute_dtype}")
    reqs = _workload(cfg, Request)
    gen_reqs = [r for r in reqs if r.prompt is not None]
    warm = gen_reqs[0]
    dep.submit(Request(99, warm.model, "dev0", prompt=warm.prompt,
                       max_new_tokens=2, inputs=warm.inputs))
    torch.cuda.synchronize()

    served_logits, solo_logits = {}, {}
    ops.reset_launches()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with record_logits(served_logits):
        results = dep.serve(reqs, **SERVE_KW)
    torch.cuda.synchronize()
    solo = {}
    t_submit = time.perf_counter()
    with record_logits(solo_logits):
        for r in gen_reqs:
            solo[r.rid] = dep.submit(r)
    torch.cuda.synchronize()
    t_submit = time.perf_counter() - t_submit
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    launches, shapes = dict(ops.LAUNCHES), _raw_shapes()
    # the oracle: the same bfloat16 weights at float32 compute
    oracle_dep, _, _ = _deployment(dev, cfg, bf16=True,
                                   compute=torch.float32)
    oracle_dep.materialize()
    oracle_logits, oracle = {}, {}
    with record_logits(oracle_logits):
        for r in gen_reqs:
            oracle[r.rid] = oracle_dep.submit(r)
    del oracle_dep

    by_rid = {r.rid: r for r in results}
    parted = 0
    for r in gen_reqs:
        a = np.asarray(by_rid[r.rid].output)
        b = np.asarray(solo[r.rid].output)
        c = np.asarray(oracle[r.rid].output)
        lg_a = torch.stack(served_logits[r.rid])
        lg_b = torch.stack(solo_logits[r.rid])
        lg_o = torch.stack(oracle_logits[r.rid])
        n = min(len(a), len(b))
        part = next((i for i in range(n) if a[i] != b[i]), None)
        if part is None and len(a) != len(b):
            fail(f"(a) rid {r.rid}: serve gave {len(a)} tokens, submit "
                 f"{len(b)}")
        upto = n if part is None else part + 1
        # the oracle's own greedy tokens hold only as long as they match
        upto_o = min(upto, next((i + 1 for i in range(min(n, len(c)))
                                 if c[i] != b[i]), min(upto, len(c))))
        ratio = _bf16_ratio(lg_a[:upto], lg_b[:upto])
        d_s, d_u, alike = _rounds_alike(lg_a[:upto_o], lg_b[:upto_o],
                                        lg_o[:upto_o])
        top2 = lg_b.float().topk(2, dim=-1).values
        msg = (f"[phase16] (a) rid {r.rid} {r.model}: {len(a)} tokens; "
               f"logits over {upto} steps {_err(lg_a[:upto], lg_b[:upto]):.3e}"
               f" apart ({ratio:.2f} of rtol = atol {BF16_TOL:g}); from the "
               f"float32 compute over {upto_o} steps: serve {d_s:.3e}, "
               f"submit {d_u:.3e} (limit {BF16_NOISE_MULT:g} x submit + "
               f"{BF16_NOISE_FLOOR:g})")
        if part is not None:
            parted += 1
            gap = (top2[part, 0] - top2[part, 1]).item()
            msg += (f"; parts from submit() at step {part} (serve "
                    f"{int(a[part])}, submit {int(b[part])}), submit()'s "
                    f"top-two logit gap there {gap:.3e} (limit {BF16_TOL:g})")
            if gap > BF16_TOL:
                log(msg)
                fail(f"(a) rid {r.rid}: serve and submit part at step {part} "
                     f"where submit's top-two gap is {gap:.3e}")
        else:
            msg += "; serve == submit"
        log(msg)
        if not alike or upto_o < 1:
            fail(f"(a) rid {r.rid}: serve's logits are {d_s:.3e} from the "
                 f"float32 compute, submit's {d_u:.3e}")
    for r in reqs:
        if r.prompt is None:
            out = by_rid[r.rid].output
            if tuple(out.shape) != (1000,) or not bool(torch.isfinite(out).all()):
                fail(f"(a) classify rid {r.rid}: output {tuple(out.shape)}")

    sched = dep.scheduler
    stream = sched.decode["vlm-head"]
    if stream.pool.n_live_pages != 1:
        fail(f"(a) page pool not drained: {stream.pool.n_live_pages} live")
    sched.check_invariants()
    sim = dep.simulate(reqs)
    for r in results:
        if r.devices != sim.routes[r.rid]:
            fail(f"(a) rid {r.rid}: route {r.devices} != simulated "
                 f"{sim.routes[r.rid]}")
    if stream.prefills != len(gen_reqs):
        fail(f"(a) {stream.prefills} prefills for {len(gen_reqs)} requests")

    # every prefill at bfloat16; the tick's paged and the solo decode at
    # float32, q widened against the engine's float32 pool and caches
    n_l = cfg.n_layers
    want = {k: {} for k in ops.LAUNCHES}

    def add(kernel, key, n):
        want[kernel][key] = want[kernel].get(key, 0) + n

    for r in gen_reqs:
        S_ = N_IMG + len(r.prompt)
        add("flash_attention", (1, S_, S_, H, K, D, True, 0, "bfloat16"),
            2 * n_l)
        add("decode_attention", (1, dense_T(S_, r.max_new_tokens), H, K, D,
                                 0, "float32"),
            (len(solo[r.rid].output) - 1) * n_l)
    add("paged_decode_attention", (ROWS, N_MAX, PAGE, H, K, D, 0, "float32"),
        stream.decode_steps * n_l)
    want = {k: {key: n for key, n in v.items() if n} for k, v in want.items()}
    _exact("(a)", launches, shapes, want)

    drift = dep.compare(reqs, **SERVE_KW)
    if drift.n_route_divergences != 0 or drift.routes_checked == 0:
        fail(f"(a) compare() {drift.summary()}")
    log(f"[phase16] (a) routes == simulate(), compare() "
        f"{drift.routes_checked} routes / {drift.n_route_divergences} "
        f"divergences, pool drained; {parted} of {len(gen_reqs)} requests "
        "part from submit() within the gap limit")
    submit_steps = sum(len(solo[r.rid].output) - 1 for r in gen_reqs)
    rates = _serve_rates(dep, gen_reqs, stream, submit_steps, t_submit,
                         peak_gb, "phase16")
    floor_ms = 2 * n_params / (HBM_TBS * 1e9)
    log(f"[phase16] (a) bfloat16 vs phase 3's float32, same run: TTFT mean "
        f"{rates['ttft_mean_ms']:.1f} ms (f32 {f32_rates['ttft_mean_ms']:.1f})"
        f", max {rates['ttft_max_ms']:.1f} ms (f32 "
        f"{f32_rates['ttft_max_ms']:.1f}); decode {rates['tok_s']:.1f} "
        f"tokens/s (f32 {f32_rates['tok_s']:.1f}), {rates['tick_ms']:.2f} ms "
        f"a tick (f32 {f32_rates['tick_ms']:.2f}); solo "
        f"{rates['solo_tok_s']:.1f} tokens/s (f32 "
        f"{f32_rates['solo_tok_s']:.1f}); peak {rates['peak_gb']:.2f} GB (f32 "
        f"{f32_rates['peak_gb']:.2f}); bfloat16 weight-read floor "
        f"{floor_ms:.3f} ms a step (2 B a parameter at {HBM_TBS} TB/s; "
        f"float32 {2 * floor_ms:.3f})")
    return {"launches": launches, "shapes": shapes}


def _b16_batch(req, dev):
    """A phase-3 request's prompt behind its image, as the bundle takes
    them (the image embeddings straight in, no stand-in encoder)."""
    import torch

    return {"tokens": torch.tensor([list(req.prompt)], dtype=torch.int32,
                                   device=dev),
            "image_embeds": torch.as_tensor(req.inputs["vision"],
                                            device=dev)[None]}


def _fresh16(bundle, params, req, toks, dev):
    """The last-token logits of a fresh prefill of ``req``'s image, prompt
    and ``toks``, into a dense cache of the bundle's default dtype."""
    import torch

    batch = _b16_batch(req, dev)
    batch["tokens"] = torch.cat([batch["tokens"], torch.tensor(
        [toks], dtype=torch.int32, device=dev)], dim=1)
    L = N_IMG + batch["tokens"].shape[1]
    logits, _ = bundle.prefill(params, batch,
                               bundle.init_cache(1, dense_T(L, 0), device=dev))
    return logits[0]


def _b16_run(bundle, params, reqs, dev, steps, ticks):
    """(b)'s run on one device: the longest request's prefill into a dense
    cache of the default dtype, ``steps`` greedy decode steps; then
    B16_ROWS requests each prefilled into a one-row cache and copied into
    a pool of the default dtype (``b16_tables``' pages), ``ticks`` paged
    steps.  Returns (the dense steps' logits and tokens, the ticks'
    logits and each row's tokens)."""
    import torch

    from repro_torch.serving.kvcache import insert_pages

    S, T, lens, n_max, n_pages = b16_shapes()
    longest = max(reqs, key=lambda r: len(r.prompt))
    cache = bundle.init_cache(1, T, device=dev)
    lg, cache = bundle.prefill(params, _b16_batch(longest, dev), cache)
    toks, dense = [int(lg[0].argmax())], []
    for i in range(steps):
        lg, cache = bundle.decode_step(
            params, torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev),
            cache, torch.tensor([S + i], dtype=torch.int32, device=dev))
        dense.append(lg[0])
        toks.append(int(lg[0].argmax()))
    cdt = {str(t.dtype) for t in _leaves(cache)}
    del cache
    pool = bundle.init_paged_cache(n_pages, PAGE, device=dev)
    tables = b16_tables(n_max, dev)
    row_toks = []
    for j, r in enumerate(reqs[:B16_ROWS]):
        one = bundle.init_cache(1, n_max * PAGE, device=dev)
        lg, one = bundle.prefill(params, _b16_batch(r, dev), one)
        insert_pages(pool, one, tables[j].tolist(), lens[j])
        row_toks.append([int(lg[0].argmax())])
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    paged = []
    for t in range(ticks):
        tok = torch.tensor([[tt[-1]] for tt in row_toks], dtype=torch.int32,
                           device=dev)
        lg, pool = bundle.paged_decode_step(params, tok, pool, tables,
                                            lengths)
        paged.append(lg)
        for j in range(B16_ROWS):
            row_toks[j].append(int(lg[j].argmax()))
        lengths = lengths + 1
    return (dense, toks), (paged, row_toks), \
        (cdt, {str(t.dtype) for t in _leaves(pool)})


def _leaves(tree):
    from repro_torch.common.pytree import tree_leaves

    return tree_leaves(tree)


def phase_bf16_bundle(dev) -> dict:
    """(b) internvl2-1b at full width through the bundle at the
    reference's bundle defaults (bfloat16 compute, weights and caches):
    a dense bfloat16 cache from ``init_cache``, the longest prompt's
    prefill and B16_STEPS decode steps; a bfloat16 pool from
    ``init_paged_cache``, B16_ROWS rows through ``paged_decode_step`` for
    B16_TICKS ticks.  A decode step == a fresh prefill within BF16_TOL at
    the first step and the last (dense and paged); at B16_CPU_LAYERS
    layers the card == the port on the CPU, both bfloat16; launches
    exact: flash, decode and paged at their bfloat16 instances."""
    import gc

    import torch

    from repro_torch.common.config import get_config
    from repro_torch.common.pytree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model
    from repro_torch.s2m3 import Request

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("internvl2-1b")
    reqs = [r for r in _workload(cfg, Request) if r.prompt is not None]
    b = build_model(cfg)
    params = tree_map(lambda t: t.to(torch.bfloat16), b.init(
        torch.Generator(device=dev).manual_seed(SEED), torch.float32, dev))
    S, T, lens, n_max, n_pages = b16_shapes()
    ops.reset_launches()
    with torch.no_grad():
        (dense, toks), (paged, row_toks), (cdt, pdt) = _b16_run(
            b, params, reqs, dev, B16_STEPS, B16_TICKS)
    torch.cuda.synchronize()
    launches, shapes = dict(ops.LAUNCHES), _raw_shapes()
    log(f"[phase16] (b) dense cache {sorted(cdt)}, pool {sorted(pdt)}; "
        f"prefill of {S} then {B16_STEPS} decode steps (T={T}): tokens "
        f"{toks}; {B16_ROWS} rows (lengths {lens}) over {n_pages} pages of "
        f"{PAGE} for {B16_TICKS} ticks: tokens {row_toks}")
    if cdt != {"torch.bfloat16"} or pdt != {"torch.bfloat16"}:
        fail(f"(b) the bundle's default caches are {cdt} / {pdt}")
    n_l = cfg.n_layers
    bf = "bfloat16"
    want = {k: {} for k in ops.LAUNCHES}
    for S_ in [S] + lens:
        key = (1, S_, S_, H, K, D, True, 0, bf)
        want["flash_attention"][key] = \
            want["flash_attention"].get(key, 0) + n_l
    want["decode_attention"] = {(1, T, H, K, D, 0, bf): B16_STEPS * n_l}
    want["paged_decode_attention"] = {
        (B16_ROWS, n_max, PAGE, H, K, D, 0, bf): B16_TICKS * n_l}
    _exact("(b)", launches, shapes, want)

    # step k's logits came from the prompt and the first k + 1 tokens
    longest = max(reqs, key=lambda r: len(r.prompt))
    with torch.no_grad():
        for k in (0, B16_STEPS - 1):
            ratio = _bf16_ratio(dense[k], _fresh16(b, params, longest,
                                                   toks[:k + 1], dev))
            log(f"[phase16] (b) dense step {k} vs a fresh prefill: "
                f"{ratio:.2f} of rtol = atol {BF16_TOL:g}")
            if ratio > 1.0:
                fail(f"(b) dense decode step {k} disagrees with a prefill")
        for t in (0, B16_TICKS - 1):
            ratio = max(_bf16_ratio(paged[t][j], _fresh16(
                b, params, reqs[j], row_toks[j][:t + 1], dev))
                for j in range(B16_ROWS))
            log(f"[phase16] (b) paged tick {t}, {B16_ROWS} rows vs fresh "
                f"prefills: {ratio:.2f} of rtol = atol {BF16_TOL:g}")
            if ratio > 1.0:
                fail(f"(b) paged tick {t} disagrees with a prefill")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    # card == CPU at B16_CPU_LAYERS layers, both bfloat16
    cfg2 = cfg.with_overrides(n_layers=B16_CPU_LAYERS)
    b2 = build_model(cfg2)
    p_cpu = tree_map(lambda t: t.to(torch.bfloat16), b2.init(
        torch.Generator(device=dev).manual_seed(SEED), device="cpu"))
    outs = {}
    with torch.no_grad():
        for device in ("cpu", dev):
            p = p_cpu if device == "cpu" else tree_map(lambda t: t.to(dev),
                                                       p_cpu)
            (d_, _), (pg, _), _ = _b16_run(b2, p, reqs, device, 3, 2)
            outs[str(device)] = d_ + pg
    worst = max(_bf16_ratio(a, c) for a, c in zip(outs[str(dev)],
                                                   outs["cpu"]))
    log(f"[phase16] (b) internvl2-1b at {B16_CPU_LAYERS} layers, bfloat16: "
        f"card (kernels) vs CPU (plain versions), 3 dense steps and 2 paged "
        f"ticks: {worst:.2f} of rtol = atol {BF16_TOL:g}")
    if worst > 1.0:
        fail("(b) the card disagrees with the CPU in bfloat16")
    return {"launches": launches, "shapes": shapes}


def _z16_run(bundle, params, prompt, dev, steps):
    """zamba2's prompt into a dense cache of the default dtypes, then
    ``steps`` greedy decode steps: (each call's logits, the tokens)."""
    import torch

    cache = bundle.init_cache(1, dense_T(len(prompt), steps), device=dev)
    lg, cache = bundle.prefill(params, {"tokens": torch.tensor(
        [prompt], dtype=torch.int32, device=dev)}, cache)
    outs, toks = [lg[0]], [int(lg[0].argmax())]
    for i in range(steps):
        lg, cache = bundle.decode_step(
            params, torch.tensor([[toks[-1]]], dtype=torch.int32, device=dev),
            cache, torch.tensor([len(prompt) + i], dtype=torch.int32,
                                device=dev))
        outs.append(lg[0])
        toks.append(int(lg[0].argmax()))
    return outs, toks


def phase_bf16_zamba2(dev) -> dict:
    """(c) zamba2-7b at full width cut to Z16_LAYERS layers, bfloat16
    weights and the default compute: a Z16_S-token prompt and Z16_STEPS
    decode steps.  Logits finite; each decode step rounds as a fresh
    prefill does (``_rounds_alike``, against the float32 compute's fresh
    prefill on the same weights; the distance logged against rtol = atol
    = BF16_TOL too); at B16_CPU_LAYERS layers card == CPU within BF16_TOL;
    launches exact: SSD at float32 (the layer widens its inputs, as the
    reference does), flash and decode at D=112 in bfloat16."""
    import gc

    import numpy as np
    import torch

    from repro_torch.common.config import get_config
    from repro_torch.common.pytree import tree_map
    from repro_torch.kernels import ops
    from repro_torch.models.api import build_model

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config(Z16_ARCH).with_overrides(n_layers=Z16_LAYERS)
    b = build_model(cfg)
    params = tree_map(lambda t: t.to(torch.bfloat16), b.init(
        torch.Generator(device=dev).manual_seed(SEED), torch.float32, dev))
    prompt = [int(t) for t in np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, Z16_S)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        outs, toks = _z16_run(b, params, prompt, dev, Z16_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, shapes = dict(ops.LAUNCHES), _raw_shapes()
    if not all(bool(torch.isfinite(o).all()) for o in outs):
        fail("(c) zamba2-7b logits are not finite")
    log(f"[phase16] (c) {Z16_ARCH} at {Z16_LAYERS} layers (of "
        f"{get_config(Z16_ARCH).n_layers}), {b.param_count():,} parameters "
        f"in bfloat16, compute {b.compute_dtype}: prefill of {Z16_S} + "
        f"{Z16_STEPS} steps in {1e3 * wall:.1f} ms, peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; tokens {toks}; "
        "logits finite")
    n_attn = cfg.n_layers // cfg.n_mamba_per_super
    T_z = dense_T(Z16_S, Z16_STEPS)
    want = {k: {} for k in ops.LAUNCHES}
    want["ssd_intra_chunk"] = {(*key, "float32"): n for key, n in
                               expected_ssd_shapes(cfg, [Z16_S]).items()}
    want["flash_attention"] = {
        (1, Z16_S, Z16_S, Z_HEADS, Z_HEADS, Z_D, True, 0, "bfloat16"): n_attn}
    want["decode_attention"] = {
        (1, T_z, Z_HEADS, Z_HEADS, Z_D, 0, "bfloat16"): n_attn * Z16_STEPS}
    _exact("(c)", launches, shapes, want)
    # each step against a fresh prefill of its tokens, bfloat16, and the
    # float32 compute's fresh prefill on the same weights (the oracle)
    b32 = build_model(cfg, compute_dtype=torch.float32)

    def fresh(bundle, k):
        cache = bundle.init_cache(1, dense_T(Z16_S + k, 0),
                                  bundle.compute_dtype, dev)
        lg, _ = bundle.prefill(params, {"tokens": torch.tensor(
            [prompt + toks[:k]], dtype=torch.int32, device=dev)}, cache)
        return lg[0]

    with torch.no_grad():
        steps = list(range(1, Z16_STEPS + 1))
        pre16, pre32 = [fresh(b, k) for k in steps], [fresh(b32, k)
                                                      for k in steps]
    dec = torch.stack([outs[k] for k in steps])
    ratio = _bf16_ratio(dec, torch.stack(pre16))
    d_dec, d_pre, alike = _rounds_alike(dec, torch.stack(pre16),
                                        torch.stack(pre32))
    log(f"[phase16] (c) decode steps 1..{Z16_STEPS} vs fresh prefills: "
        f"{_err(dec, torch.stack(pre16)):.3e} apart ({ratio:.2f} of rtol = "
        f"atol {BF16_TOL:g}); from the float32 compute's prefills: decode "
        f"{d_dec:.3e}, prefill {d_pre:.3e} (limit {BF16_NOISE_MULT:g} x "
        f"prefill + {BF16_NOISE_FLOOR:g})")
    if not alike:
        fail("(c) zamba2-7b's decode is further from the float32 compute "
             "than its prefill's rounding")
    del params
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = cfg.with_overrides(n_layers=B16_CPU_LAYERS)
    b2 = build_model(cfg2)
    p_cpu = tree_map(lambda t: t.to(torch.bfloat16), b2.init(
        torch.Generator(device=dev).manual_seed(SEED), device="cpu"))
    got = {}
    with torch.no_grad():
        for device in ("cpu", dev):
            p = p_cpu if device == "cpu" else tree_map(lambda t: t.to(dev),
                                                       p_cpu)
            got[str(device)] = _z16_run(b2, p, prompt, device, 2)[0]
    worst = max(_bf16_ratio(a, c) for a, c in zip(got[str(dev)], got["cpu"]))
    log(f"[phase16] (c) {Z16_ARCH} at {B16_CPU_LAYERS} layers, bfloat16: card "
        f"vs CPU, prefill of {Z16_S} + 2 steps: {worst:.2f} of rtol = atol "
        f"{BF16_TOL:g}")
    if worst > 1.0:
        fail("(c) zamba2-7b on the card disagrees with the CPU in bfloat16")
    return {"launches": launches, "shapes": shapes}


# phase 16's paths: (a), (b), (c)
BF16_PATHS = ("bf16-serve", "bf16-bundle", "bf16-zamba2")


def phase_bf16(dev, f32_rates) -> dict:
    """Phase 16: the reference's default compute, bfloat16, on the card:
    (a) the main path, (b) the bundle's default caches, (c) zamba2-7b."""
    return dict(zip(BF16_PATHS, (phase_bf16_serve(dev, f32_rates),
                                 phase_bf16_bundle(dev),
                                 phase_bf16_zamba2(dev))))


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (sets the float32 matmul precision)

    dev = torch.device("cuda")
    card = card_line()
    log(f"[card] {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()

    def timed(n, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"[phase{n}] done in {time.perf_counter() - t:.1f} s")
        return out

    timed(1, phase_build)
    (rows, keys), (rec_rows, rec_keys), (slice_rows, slice_keys), \
        (fam_rows, fam_keys), (tile_rows, tile_keys), (b16_rows, b16_keys) = \
        timed(2, lambda: [f(dev) for f in (
            phase_kernels, phase_kernels_recurrent, phase_kernels_slice,
            phase_kernels_families, phase_kernels_paged_tile,
            phase_kernels_bf16)])
    mla_rows, mla_keys = timed(2, phase_kernels_mla, dev)
    serve, dep, gen_reqs = timed(3, phase_serve, dev)
    timed(4, phase_profile, dep, gen_reqs)
    del dep, gen_reqs
    paths = {"serve": serve, **timed(5, phase_recurrent, dev),
             "scenario": timed(6, phase_scenario, dev)}
    paths.update(timed(7, lambda: {TL_ARCH: phase_tinyllama(dev),
                                   W_ARCH: phase_whisper(dev)}))
    from repro_torch.common.config import get_config

    paths.update(timed(8, lambda: {arch: phase_family(
        dev, get_config(arch).with_overrides(n_layers=FAM_LAYERS))
        for arch in FAM_ARCHS}))
    paths.update(timed(9, lambda: {
        DS_ARCH: phase_deepseek(dev),
        L405_ARCH: phase_family(
            dev, get_config(L405_ARCH).with_overrides(n_layers=L405_LAYERS),
            cpu_layers=L405_CPU_LAYERS, tag="phase9")}))
    timed(10, phase_analysis, dev)
    paths["train"] = timed(11, phase_training, dev)
    timed(12, phase_distributed, dev)
    timed(13, phase_dryrun, dev)
    paths.update(timed(14, phase_recurrent_mesh, dev))
    paths.update(timed(15, phase_paged_mesh, dev))
    paths.update(timed(16, phase_bf16, dev, serve["rates"]))
    # each row's launches at its own call shape on its path's main-path
    # run, beside the kernel's launches on that path
    rows += rec_rows + slice_rows + fam_rows + tile_rows + b16_rows + mla_rows
    keys.update(rec_keys, **slice_keys, **fam_keys, **tile_keys, **b16_keys,
                **mla_keys)
    for row in rows:
        path, kernel, key = keys[row["name"]]
        if isinstance(path, tuple):
            # a shape no path runs (the page-range tile, a (2, ·) mesh's;
            # the bf16 flash at gemma2-9b's local layer): 0 at it on the
            # paths named, beside the kernel's launches there
            row["launches"] = 0
            row["launches_of_kernel"] = sum(paths[p]["launches"][kernel]
                                            for p in path)
            log(f"[launches] {row['name']}: 0: no path runs it ({path} "
                f"ran {row['launches_of_kernel']} {kernel} launches, none "
                f"at {key})")
            if any(paths[p]["shapes"][kernel].get(key) for p in path):
                fail(f"{row['name']}: a path of {path} ran {key}")
            continue
        row["launches"] = paths[path]["shapes"][kernel].get(key, 0)
        row["launches_of_kernel"] = paths[path]["launches"][kernel]
        log(f"[launches] {row['name']}: {row['launches']} of {path}'s "
            f"{row['launches_of_kernel']} {kernel} launches at {key}")
        if not row["launches"]:
            fail(f"{row['name']}: its timed shape {key} never ran on the "
                 f"{path} path")
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
