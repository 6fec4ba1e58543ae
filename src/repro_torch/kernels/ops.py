"""Wrappers over the hand-written CUDA kernels: attention (MLA's
absorbed paged decode among it), the Mamba2 SSD intra-chunk kernel and
the sLSTM recurrence.

Each wrapper checks its inputs, then either launches its kernel on the
current CUDA stream or — only for tensors that lie on the CPU — takes
the plain version from ``kernels.ref``.  A CUDA tensor never falls back:
a kernel that does not build or launch raises.  On ``meta`` tensors a
wrapper runs every check of the card path (head dim, plan, shared
memory, cluster, grid) and returns its outputs unfilled, launching
nothing: ``analysis.kernel_check`` reads the output contract that way.
A wrapper reads raw pointers, so it takes local tensors only: it raises
``TypeError`` on a ``DTensor`` argument before any launch (the sharded
model calls it on each rank's local tensors, through
``common.sharding.shard_map``).
The kernels have no backward: on a CUDA or meta tensor, a wrapper
raises ``NoBackwardError`` before any launch when grad mode is on and a
floating input requires grad (the plain-torch path that differentiates
is chosen by the caller: ``build_model(cfg, attn_impl="xla")``).
A shape with no launch on the card raises a ``KernelPlanError`` (a
``ValueError``) naming the rule it breaks.  ``LAUNCHES`` counts the
kernel launches of each wrapper, and ``SHAPE_LAUNCHES`` the same launches
by call shape (the CPU and meta paths do not count), so a run can show
that its work went through the kernels, and at which shapes.
On the card and on meta tensors each wrapper also tells the callables
in ``WORK_HOOKS`` of its work, which torch's dispatch cannot see inside
a launch: its FLOPs, counted as the reference's einsum form of the
function (the full S x T score product of attention), the bytes it
reads and writes (each input once, each output once), and the bytes
the call holds at its peak beyond what was live when it began (its
outputs and workspace).  ``common.profiling`` counts a step that way;
on the CPU the plain versions' own ops are counted instead.
A CUDA graph captured inside ``recording()`` launches nothing until it
is replayed: the counts and work reports made while it captures are
kept on a tape, which ``replay_tape`` applies once a replay.
"""

from __future__ import annotations

import contextlib
import functools
import threading
from dataclasses import dataclass

import torch

from repro_torch.common.hw import H100_SXM
from repro_torch.kernels import ref

#: kernel name -> launches since the last ``reset_launches()``
#: (``slstm_scan`` counts the prefill kernel, ``slstm_scan_s1`` the
#: one-step decode kernel; both are launched by ``slstm_scan()``)
LAUNCHES = {"flash_attention": 0, "decode_attention": 0,
            "paged_decode_attention": 0, "paged_mla_decode": 0,
            "ssd_intra_chunk": 0, "slstm_scan": 0, "slstm_scan_s1": 0}

#: kernel name -> launches since the last ``reset_launches()`` by call
#: shape and dtype, which sum to the kernel's ``LAUNCHES`` entry: flash
#: (B, S, T, H, K, D, causal, window, dtype), decode (B, T, H, K, D,
#: window, dtype), paged decode (B, n_max, page_size, H, K, D, window,
#: dtype) over a whole pool and (B, n_max, the tile's slots a page, H, K,
#: D, window, the tile's pages, page_size, dtype) over a rank's tile,
#: MLA's paged decode (B, n_max, page_size, H, kv_lora_rank, rope, dtype), SSD
#: (B, chunks, chunk length L, heads H, dtype) and both sLSTM kernels (B,
#: S, H, hd, dtype); window 0 is none, so a local layer's launches count
#: apart from a global one's, and dtype is the instance's name
#: ("float32" or "bfloat16"), so a path's bfloat16 and float32 launches
#: count apart
SHAPE_LAUNCHES: dict[str, dict[tuple, int]] = {name: {} for name in LAUNCHES}

#: head dims the attention kernels are instantiated for: the smoke
#: configs' 16, internvl2-1b's 64, zamba2-7b's 112, llama3-8b's 128 and
#: gemma2-9b's 256
HEAD_DIMS = (16, 64, 112, 128, 256)

#: the SSD kernel's limit on the chunk length L, the head dim P and the
#: state size N (its tiles and shared memory are sized for them)
SSD_MAX_DIM = 128

#: the SSD kernel's query rows a y tile that it takes (16 and 64 only in
#: float32 with P <= 64, for experiments) and the state rows a thread
#: owns in an S_loc tile (S_loc tiles are tr / 4 * that rows tall); the
#: planner's y tile rows
SSD_TILE_ROWS = (16, 32, 64)
SSD_STATE_ROWS_A_THREAD = (4, 8)
SSD_PLAN_ROWS = 32
#: the waves of blocks up to which the planner takes 64-row S_loc tiles
SSD_WIDE_WAVES = 3
#: the steps (keys) of B and x a block stages in shared memory at once
SSD_KEY_BLOCK = 64

#: the split-KV decode kernel: the fewest keys of a full cache that one
#: split keeps, the q-heads (warps) of one block, and its most splits
DECODE_MIN_KEYS = 16
DECODE_HEADS_PER_BLOCK = 8
DECODE_MAX_SPLITS = 256
#: the blocks an SM each split-KV kernel is built to hold
#: (``__launch_bounds__``)
DECODE_BLOCKS_PER_SM = 2

#: MLA's paged decode kernel: the latent and rotary widths it is built
#: for (DeepSeek-V3's kv_lora_rank and qk_rope_dim), the heads a block
#: (the last block of an H % 32 == 16 holds 16, its upper warps idle),
#: the fewest keys a split keeps, the blocks an SM holds, its most splits
MLA_RANK, MLA_ROPE, MLA_HEADS_PER_BLOCK = 512, 64, 32
MLA_HEAD_MULTIPLE = MLA_HEADS_PER_BLOCK // 2
MLA_MIN_KEYS, MLA_BLOCKS_PER_SM, MLA_MAX_SPLITS = 64, 1, 64
#: its threads a block and dynamic shared memory (``csrc/mla_decode.cu``:
#: the block's queries, a ring of two 32-key tiles, the tile's scores and
#: probabilities, the rescale factors and final sums, in floats)
MLA_KEYS_PER_TILE = 32
MLA_THREADS = 256
MLA_SMEM = 4 * (MLA_HEADS_PER_BLOCK * (MLA_RANK + MLA_ROPE)
                + 2 * MLA_KEYS_PER_TILE * (MLA_RANK + MLA_ROPE)
                + MLA_HEADS_PER_BLOCK * (MLA_KEYS_PER_TILE + 4)
                + MLA_KEYS_PER_TILE * (MLA_HEADS_PER_BLOCK + 4)
                + 2 * MLA_HEADS_PER_BLOCK)

#: the sLSTM prefill kernel: the largest cluster (blocks a head; 16 is a
#: non-portable size that Hopper allows), the 32-row slots of R a lane
#: keeps in registers, the batch rows one cluster carries, the largest
#: head dim (both sLSTM kernels), and a block's shared-memory limit
SLSTM_MAX_CLUSTER = H100_SXM.max_cluster
SLSTM_REG_SLOTS = 4
SLSTM_MAX_ROWS = 4
SLSTM_MAX_HEAD_DIM = 512
SMEM_LIMIT = H100_SXM.smem_block
#: an SM's shared memory (228 KiB), of which each resident block takes
#: its dynamic bytes plus 1 KiB the system reserves
SM_SMEM, SMEM_RESERVED = H100_SXM.smem_sm, H100_SXM.smem_reserved
#: an SM's 32-bit registers
SM_REGISTERS = H100_SXM.registers_sm
#: CUDA's grid extents x, y, z
MAX_GRID = H100_SXM.max_grid

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

#: callables ``hook(kernel name, flops, bytes moved, peak bytes)`` each
#: wrapper calls on the card and on meta tensors (see the module
#: docstring)
WORK_HOOKS: list = []


#: this thread's tape while ``recording()`` is open
_TAPE = threading.local()


@contextlib.contextmanager
def recording():
    """Keep the launch counts and work reports that the wrappers make in
    this thread on a tape instead of applying them: a CUDA graph captured
    inside launches nothing until it is replayed.  Yields the tape, a
    list of calls that ``replay_tape`` applies."""
    outer = getattr(_TAPE, "calls", None)
    tape = _TAPE.calls = []
    try:
        yield tape
    finally:
        _TAPE.calls = outer


def replay_tape(tape) -> None:
    """Apply a ``recording()`` tape, as a replay of the graph captured
    with it launches its kernels: ``LAUNCHES`` and ``SHAPE_LAUNCHES``
    count them and the ``WORK_HOOKS`` hear of them."""
    for fn, args in tape:
        fn(*args)


def _taped(fn, args) -> bool:
    calls = getattr(_TAPE, "calls", None)
    if calls is None:
        return False
    calls.append((fn, args))
    return True


def _work(name, flops, inputs, out_bytes, scratch=0) -> None:
    moved = sum(t.numel() * t.element_size() for t in inputs) + out_bytes
    _report(name, float(flops), moved, out_bytes + scratch)


def _report(name, flops, moved, peak) -> None:
    if _taped(_report, (name, flops, moved, peak)):
        return
    for hook in WORK_HOOKS:
        hook(name, flops, moved, peak)


def _nbytes(shape, dtype) -> int:
    n = dtype.itemsize
    for d in shape:
        n *= d
    return n


class KernelLaunchError(RuntimeError):
    """A kernel launch returned a CUDA error."""


class NoBackwardError(RuntimeError):
    """A kernel input requires grad under grad mode on the card: the
    hand-written kernels compute no backward, so their outputs would
    leave autograd without one."""


class KernelPlanError(ValueError):
    """A shape the kernels have no launch for on the card."""


class NoPlanError(KernelPlanError):
    """No kernel instance or tiling takes this shape (a head dim without
    a plan, an SSD dimension above ``SSD_MAX_DIM``, an sLSTM head dim that
    is not a multiple of 8 or is above ``SLSTM_MAX_HEAD_DIM``)."""


class SharedMemoryError(KernelPlanError):
    """A block would need more dynamic shared memory than ``SMEM_LIMIT``."""


class ClusterError(KernelPlanError):
    """No thread-block cluster of at most ``SLSTM_MAX_CLUSTER`` blocks
    splits the sLSTM head dim."""


class GridError(KernelPlanError):
    """A grid extent above CUDA's ``MAX_GRID``."""


class TileError(KernelPlanError):
    """A paged decode tile that is not a tile of its pool: pages [p0, p0 +
    P) past the pool's pages, or slots [s0, s0 + ps) past its page."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0
    for counts in SHAPE_LAUNCHES.values():
        counts.clear()


def _count(name, key, dtype) -> None:
    """One launch of kernel ``name`` at call shape ``key`` in ``dtype``
    (its name, "float32" or "bfloat16", ends the counted key)."""
    if _taped(_count, (name, key, dtype)):
        return
    LAUNCHES[name] += 1
    counts = SHAPE_LAUNCHES[name]
    key = (*key, str(dtype).removeprefix("torch."))
    counts[key] = counts.get(key, 0) + 1


def _check(name, tensors):
    """One device (CPU, CUDA or meta) and one float32/bfloat16 dtype for
    all."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"{name}: unsupported device {dev}")
    dts = {t.dtype for t in tensors.values()}
    if len(dts) != 1 or next(iter(dts)) not in _DTYPES:
        raise TypeError(f"{name}: inputs must share one dtype of "
                        f"float32/bfloat16, got {sorted(map(str, dts))}")
    return dev


def _no_dtensor(name, tensors):
    """Raise ``TypeError`` when any of ``tensors`` (``None`` entries
    skipped) is a ``DTensor``: the kernels read its local storage's raw
    pointer, which is not the tensor it stands for."""
    if not torch.distributed.is_available():
        return
    from torch.distributed.tensor import DTensor

    if any(isinstance(t, DTensor) for t in tensors):
        raise TypeError(
            f"{name}: a DTensor argument; call the kernel on each rank's "
            "local tensors (common.sharding.shard_map)")


def _no_backward(name, dev, tensors):
    """Raise ``NoBackwardError`` on a CUDA or meta device when grad mode
    is on and any floating tensor of ``tensors`` (``None`` entries
    skipped) requires grad.  The CPU path's plain versions differentiate
    and never raise."""
    if dev.type == "cpu" or not torch.is_grad_enabled():
        return
    if any(t is not None and t.is_floating_point() and t.requires_grad
           for t in tensors):
        raise NoBackwardError(
            f"{name}: the kernel has no backward and an input requires "
            "grad; differentiate through the plain-torch path "
            "(build_model(cfg, attn_impl='xla'), or impl='xla' on the "
            "layer), or call it under torch.no_grad()")


def _contiguous(name, tensors):
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _cuda_ready(name, tensors, D):
    _contiguous(name, tensors)
    if D not in HEAD_DIMS:
        raise NoPlanError(f"{name}: head_dim {D} not in {HEAD_DIMS}")


def check_grid(name, grid) -> None:
    """Raise ``GridError`` if an extent of ``grid`` (x, y, z) is above
    CUDA's ``MAX_GRID``.  (An empty call, an extent of 0, launches
    nothing: the C entries return at once.)"""
    for axis, n, most in zip("xyz", grid, MAX_GRID):
        if n > most:
            raise GridError(f"{name}: grid {tuple(grid)} has {axis} extent "
                            f"{n}, above CUDA's {most}")


@dataclass(frozen=True)
class FlashPlan:
    """The flash kernel's tiles at one head dim and dtype, which
    ``flash_attention_plan`` reports on the card: the float32 instance's
    ``Tiles<D>`` and ``Geom``, or the bfloat16 instance's ``MmaTiles<D>``
    and ``MmaGeom`` (``csrc/flash_attention.cu``)."""

    bq: int           # query rows a block
    bk: int           # keys a tile
    threads: int      # threads a block
    smem: int         # dynamic shared-memory bytes a block


#: ``Tiles<D>`` of ``csrc/flash_attention.cu``, the float32 instance:
#: (BQ, BK) by head dim
FLASH_TILES = {16: (64, 64), 64: (16, 64), 112: (32, 64), 128: (64, 32),
               256: (32, 32)}
#: the float32 instance's threads a block (``NT``)
FLASH_THREADS = 128
#: ``MmaTiles<D>``, the bfloat16 instance: (BQ, BK, KW) by head dim; a
#: warp owns 16 query rows and BK keys of each tile of KW x BK, so a block
#: has 2 BQ KW threads
FLASH_TILES_BF16 = {16: (32, 16, 1), 64: (32, 32, 4), 112: (64, 32, 2),
                    128: (64, 32, 1), 256: (64, 16, 1)}


@functools.lru_cache(maxsize=None)
def flash_plan(D, dtype=torch.float32) -> FlashPlan:
    """The flash kernel's plan at head dim D for ``dtype`` inputs: the
    Python mirror of ``flash_attention_plan``.  float32: shared memory
    holds Q, one K tile, one V tile (rows padded to D + 4 floats) and P
    (BK rows of BQ + 4).  bfloat16: Q and two (K, V) tile pairs of KW x
    BK keys, all bf16 with rows padded to D + 8.
    Raises ``NoPlanError`` for a D without a plan, as the wrapper does at
    launch."""
    if dtype not in _DTYPES:
        raise TypeError(f"flash_attention: dtype {dtype} is not float32 or "
                        "bfloat16")
    if D not in FLASH_TILES:
        raise NoPlanError(f"flash_attention: head_dim {D} not in "
                          f"{HEAD_DIMS}")
    if dtype is torch.bfloat16:
        bq, bk, kw = FLASH_TILES_BF16[D]
        threads = 2 * bq * kw
        smem = 2 * (D + 8) * (bq + 4 * kw * bk)
    else:
        bq, bk = FLASH_TILES[D]
        threads = FLASH_THREADS
        smem = 4 * (bq * (D + 4) + 2 * bk * (D + 4) + bk * (bq + 4))
    if smem > SMEM_LIMIT:
        raise SharedMemoryError(f"flash_attention: head_dim {D} needs "
                                f"{smem} B of shared memory a block, above "
                                f"{SMEM_LIMIT}")
    return FlashPlan(bq=bq, bk=bk, threads=threads, smem=smem)


def flash_grid(B, S, H, D, dtype=torch.float32) -> tuple[int, int, int]:
    """The flash kernel's grid: (H, B, q tiles), the q tile slowest."""
    return H, B, -(-S // flash_plan(D, dtype).bq)


def _aligned(name, tensors):
    """The flash and split-KV decode kernels read rows with 16-byte
    (f32; bf16 flash) or 8-byte (bf16 decode) vector loads."""
    for arg, t in tensors.items():
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} must start on a 16-byte "
                             "boundary")


def _raise_on(name, err):
    if err != 0:
        raise KernelLaunchError(f"{name}: CUDA error {err} at launch")


def _stream(t):
    """The raw handle of the current CUDA stream on t's device (without
    building a ``torch.cuda.Stream`` object on every launch)."""
    return torch._C._cuda_getCurrentRawStream(t.device.index)


def _f32(t):
    """t as a contiguous float32 tensor: t itself when it is one."""
    if t.dtype is torch.float32 and t.is_contiguous():
        return t
    return t.float().contiguous()


def _window(name, window) -> int:
    window = int(window)
    if window < 0:
        raise ValueError(f"{name}: window {window} < 0 (0 is none)")
    return window


def flash_attention(q, k, v, *, causal=True, window=0, softcap=0.0):
    """q: (B,S,H,D); k/v: (B,T,K,D) with H % K == 0.  Returns (B,S,H,D)
    in q's dtype.  Positions are the trivial arange on both sides; with
    ``window`` > 0 query i sees keys j > i - window."""
    _no_dtensor("flash_attention", (q, k, v))
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or K < 1 or H % K:
        raise ValueError(f"flash_attention: q{tuple(q.shape)} does not "
                         f"match k/v{tuple(k.shape)}")
    dev = _check("flash_attention", {"q": q, "k": k, "v": v})
    _no_backward("flash_attention", dev, (q, k, v))
    window = _window("flash_attention", window)
    if dev.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                       softcap=softcap)
    _cuda_ready("flash_attention", {"q": q, "k": k, "v": v}, D)
    check_grid("flash_attention", flash_grid(B, S, H, D, q.dtype))
    _work("flash_attention", 4 * B * H * S * T * D, (q, k, v),
          _nbytes(q.shape, q.dtype))
    if dev.type == "meta":
        return torch.empty_like(q)
    _aligned("flash_attention", {"q": q, "k": k, "v": v})
    from repro_torch.kernels.build import load

    lib = load("flash_attention")
    o = torch.empty_like(q)
    err = lib.flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, S, T, H,
        K, D, _DTYPES[q.dtype], int(bool(causal)), window,
        float(softcap), _stream(q))
    _raise_on("flash_attention", err)
    _count("flash_attention", (B, S, T, H, K, D, bool(causal), window),
           q.dtype)
    return o


def _lengths_ok(name, lengths, B, dev):
    if lengths.shape != (B,) or lengths.dtype != torch.int32 or \
            lengths.device != dev:
        raise ValueError(f"{name}: lengths must be ({B},) int32 on {dev}, "
                         f"got {tuple(lengths.shape)} {lengths.dtype} on "
                         f"{lengths.device}")


def decode_splits(T, B, K, G, n_sm, window=0):
    """How many blocks share one row's keys in the split-KV decode
    kernels, whose grid is (n_split, K, B * ceil(G / 8)): as many as
    fill two blocks an SM, but no more than leave each split
    ``DECODE_MIN_KEYS`` keys of a full row's live keys — T of a cache of
    T, or min(T, window) under a window — (and at most
    ``DECODE_MAX_SPLITS``).  It reads only static shapes, so every step
    of a decode loop gets the same grid."""
    blocks = B * K * -(-G // DECODE_HEADS_PER_BLOCK)
    live = min(T, window) if window and window > 0 else T
    return max(1, min(2 * n_sm // blocks, live // DECODE_MIN_KEYS,
                      DECODE_MAX_SPLITS))


def _decode_ws_bytes(B, H, D, n_split) -> int:
    """The split-KV decode kernels' float32 workspace: per (row, head,
    split) the partial max, sum and D-wide accumulator."""
    return 4 * B * H * n_split * (D + 2)


def decode_grid(B, K, G, n_split) -> tuple[int, int, int]:
    """The split-KV decode kernels' grid: (n_split, K, B * ceil(G / 8)),
    ``DECODE_HEADS_PER_BLOCK`` q-heads (one warp each) a block."""
    return n_split, K, B * -(-G // DECODE_HEADS_PER_BLOCK)


def sm_count(dev) -> int:
    """The SMs the decode and SSD planners fill: the card's for a CUDA
    device, the H100's (``common.hw``) for any other (a meta tensor's, a
    static check's)."""
    return _sm_count(dev.index) if dev.type == "cuda" else H100_SXM.sms


def split_range(n_keys, n_split, i, lo=0):
    """Keys [lo + a, lo + b) of split i of a row whose n_keys live keys
    start at key lo (a window's first key, else 0): the rule the kernel
    applies on the device to each row's length."""
    return lo + n_keys * i // n_split, lo + n_keys * (i + 1) // n_split


@functools.lru_cache(maxsize=None)
def _sm_count(index):
    return torch.cuda.get_device_properties(index).multi_processor_count


_TICKETS: dict[int, torch.Tensor] = {}
#: tickets a larger launch outgrew, kept: a CUDA graph may hold their
#: pointer
_OUTGROWN: list = []


def _ticket_counters(dev, n):
    """The split-KV kernel's merge tickets: zeroed once per device; every
    launch leaves them zero again, so launches on one device must be
    ordered (one stream), not concurrent."""
    t = _TICKETS.get(dev.index)
    if t is None or t.numel() < n:
        if t is not None:
            _OUTGROWN.append(t)
        t = torch.zeros(max(n, 1024), dtype=torch.int32, device=dev)
        _TICKETS[dev.index] = t
    return t


def decode_attention(q, k, v, lengths, *, window=0, softcap=0.0):
    """q: (B,H,D); k/v: (B,T,K,D); lengths: (B,) int32 valid key counts
    (keys at or past them are masked; with ``window`` > 0 so are keys
    below ``lengths - window``, which the kernel never reads).  Returns
    (B,H,D)."""
    _no_dtensor("decode_attention", (q, k, v, lengths))
    if q.ndim != 3 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"decode_attention: bad shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    B, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or K < 1 or H % K:
        raise ValueError(f"decode_attention: q{tuple(q.shape)} does not "
                         f"match k/v{tuple(k.shape)}")
    dev = _check("decode_attention", {"q": q, "k": k, "v": v})
    _no_backward("decode_attention", dev, (q, k, v))
    _lengths_ok("decode_attention", lengths, B, dev)
    window = _window("decode_attention", window)
    if dev.type == "cpu":
        return ref.decode_attention_ref(q, k, v, lengths, window=window,
                                        softcap=softcap)
    _cuda_ready("decode_attention",
                {"q": q, "k": k, "v": v, "lengths": lengths}, D)
    G = H // K
    n_split = decode_splits(T, B, K, G, sm_count(dev), window)
    check_grid("decode_attention", decode_grid(B, K, G, n_split))
    _work("decode_attention", 4 * B * H * T * D, (q, k, v, lengths),
          _nbytes(q.shape, q.dtype), _decode_ws_bytes(B, H, D, n_split))
    if dev.type == "meta":
        return torch.empty_like(q)
    _aligned("decode_attention", {"q": q, "k": k, "v": v})
    from repro_torch.kernels.build import load

    lib = load("decode_attention")
    o = torch.empty_like(q)
    ws = torch.empty(_decode_ws_bytes(B, H, D, n_split) // 4,
                     dtype=torch.float32, device=dev)
    tickets = _ticket_counters(
        dev, B * K * -(-G // DECODE_HEADS_PER_BLOCK))
    err = lib.decode_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), ws.data_ptr(), tickets.data_ptr(), B, H, K, D, T,
        n_split, window, _DTYPES[q.dtype], float(softcap), _stream(q))
    _raise_on("decode_attention", err)
    _count("decode_attention", (B, T, H, K, D, window), q.dtype)
    return o


def _paged_tile(tile, P, ps):
    """``tile`` (p0, n_pages, s0, page_size) checked against a rank's
    (P, ps) pages of it: ``TileError`` unless pages [p0, p0 + P) lie in
    the pool's n_pages and slots [s0, s0 + ps) in its page_size."""
    p0, n_pages, s0, page_size = (int(x) for x in tile)
    if p0 < 0 or P < 1 or p0 + P > n_pages or s0 < 0 or ps < 1 or \
            s0 + ps > page_size:
        raise TileError(
            f"paged_decode_attention: a tile of {P} pages from page {p0} "
            f"and {ps} slots from slot {s0} is not a tile of a pool of "
            f"{n_pages} pages of {page_size}")
    return p0, n_pages, s0, page_size


def paged_decode_attention(q, k_pages, v_pages, block_tables, lengths, *,
                           window=0, softcap=0.0, tile=None):
    """Batched paged-KV decode: q (B,H,D); k/v pages (n_pages, page_size,
    K, D); block_tables (B, n_max) int32 page ids, clamped into range;
    lengths (B,) int32 masks each row's ragged tail; with ``window`` > 0
    keys below ``lengths - window`` are masked too (their pages are not
    read).  Returns (B,H,D).  The split count comes from static shapes
    (the table's span n_max * page_size, and the window), so nothing is
    read back from the device.

    The tile mode: with ``tile`` = (p0, n_pages, s0, page_size) the pages
    are a rank's tile (P, ps, K, D) of a pool of n_pages pages of
    page_size slots, pages [p0, p0 + P) and slots [s0, s0 + ps) of each
    (``TileError`` otherwise), the tables hold the pool's page ids, and
    the call attends over the live keys the tile holds; it then returns
    (o, lse), the tile's normalised output and its log-sum-exp (B, H) in
    float32 (-inf, and o = 0, where the tile holds no live key of a
    row), which ranks combine into the whole pool's output
    (``layers.attention.paged_decode_attention_shardmap``).  The splits
    then share the tile's n_max * ps candidate keys a row; (0, n_pages, 0,
    page_size) is the whole pool's tile."""
    _no_dtensor("paged_decode_attention",
                (q, k_pages, v_pages, block_tables, lengths))
    if q.ndim != 3 or k_pages.ndim != 4 or k_pages.shape != v_pages.shape:
        raise ValueError(
            f"paged_decode_attention: bad shapes q{tuple(q.shape)} "
            f"pages{tuple(k_pages.shape)} {tuple(v_pages.shape)}")
    B, H, D = q.shape
    P, ps, K = k_pages.shape[0], k_pages.shape[1], k_pages.shape[2]
    if k_pages.shape[3] != D or K < 1 or H % K or block_tables.ndim != 2 \
            or block_tables.shape[0] != B:
        raise ValueError(
            f"paged_decode_attention: q{tuple(q.shape)} does not match "
            f"pages{tuple(k_pages.shape)} / tables{tuple(block_tables.shape)}")
    dev = _check("paged_decode_attention",
                 {"q": q, "k_pages": k_pages, "v_pages": v_pages})
    _no_backward("paged_decode_attention", dev, (q, k_pages, v_pages))
    _lengths_ok("paged_decode_attention", lengths, B, dev)
    if block_tables.dtype != torch.int32 or block_tables.device != dev:
        raise ValueError("paged_decode_attention: block_tables must be "
                         f"int32 on {dev}")
    window = _window("paged_decode_attention", window)
    tiled = tile is not None
    if tiled:
        tile = _paged_tile(tile, P, ps)
    if dev.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, k_pages, v_pages, block_tables, lengths, window=window,
            softcap=softcap, tile=tile)
    _cuda_ready("paged_decode_attention",
                {"q": q, "k_pages": k_pages, "v_pages": v_pages,
                 "block_tables": block_tables, "lengths": lengths}, D)
    n_max = block_tables.shape[1]
    G = H // K
    n_split = decode_splits(n_max * ps, B, K, G, sm_count(dev), window)
    check_grid("paged_decode_attention", decode_grid(B, K, G, n_split))
    lse_bytes = 4 * B * H if tiled else 0
    _work("paged_decode_attention", 4 * B * H * n_max * ps * D,
          (q, k_pages, v_pages, block_tables, lengths),
          _nbytes(q.shape, q.dtype) + lse_bytes,
          _decode_ws_bytes(B, H, D, n_split))
    if dev.type == "meta":
        o = torch.empty_like(q)
        return (o, torch.empty((B, H), dtype=torch.float32,
                               device=dev)) if tiled else o
    _aligned("paged_decode_attention",
             {"q": q, "k_pages": k_pages, "v_pages": v_pages})
    from repro_torch.kernels.build import load

    lib = load("decode_attention")
    o = torch.empty_like(q)
    ws = torch.empty(_decode_ws_bytes(B, H, D, n_split) // 4,
                     dtype=torch.float32, device=dev)
    tickets = _ticket_counters(
        dev, B * K * -(-G // DECODE_HEADS_PER_BLOCK))
    if not tiled:
        err = lib.paged_decode_attention_fwd(
            q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
            block_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
            ws.data_ptr(), tickets.data_ptr(), B, H, K, D, P, ps, n_max,
            n_split, window, _DTYPES[q.dtype], float(softcap), _stream(q))
        _raise_on("paged_decode_attention", err)
        _count("paged_decode_attention", (B, n_max, ps, H, K, D, window),
               q.dtype)
        return o
    p0, n_pages, s0, page_size = tile
    lse = torch.empty((B, H), dtype=torch.float32, device=dev)
    err = lib.paged_decode_attention_tile_fwd(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), o.data_ptr(),
        lse.data_ptr(), ws.data_ptr(), tickets.data_ptr(), B, H, K, D,
        n_pages, p0, P, page_size, s0, ps, n_max, n_split, window,
        _DTYPES[q.dtype], float(softcap), _stream(q))
    _raise_on("paged_decode_attention", err)
    _count("paged_decode_attention",
           (B, n_max, ps, H, K, D, window, P, page_size), q.dtype)
    return o, lse


def mla_splits(T, B, H, n_sm) -> int:
    """The splits of a row's keys in MLA's paged decode, whose grid is
    (n_split, ceil(H / 32), B): enough blocks to fill
    ``MLA_BLOCKS_PER_SM`` an SM eight times over (a tick's dead rows'
    blocks end at once, and more, shorter blocks even out the live rows'
    waves: at dots-vlm1.ocr's tick on an H100 this rule's 5 splits take
    0.787 ms, 4 to 10 splits within 2.5 % of that, 2 splits 0.931 and 1
    split 1.207), each split keeping ``MLA_MIN_KEYS`` of a full row's T
    keys (at most ``MLA_MAX_SPLITS``).  Static shapes only, as
    ``decode_splits``."""
    blocks = B * -(-H // MLA_HEADS_PER_BLOCK)
    want = -(-8 * MLA_BLOCKS_PER_SM * n_sm // max(blocks, 1))
    return max(1, min(want, T // MLA_MIN_KEYS, MLA_MAX_SPLITS))


def mla_grid(B, H, n_split) -> tuple[int, int, int]:
    return n_split, -(-H // MLA_HEADS_PER_BLOCK), B


def _mla_ws_bytes(B, H, r, n_split) -> int:
    """The split partials: (m, l) and the r-wide sum of each (row, head,
    split); none with one split."""
    return 0 if n_split == 1 else 4 * B * H * n_split * (r + 2)


def paged_mla_decode(q_lat, q_pe, ckv_pages, kr_pages, block_tables,
                     lengths, *, scale):
    """MLA's absorbed decode step over a paged latent pool (see
    ``ref.paged_mla_decode_ref``): q_lat (B,H,r), q_pe (B,H,rope),
    ckv_pages (P, page_size, r), kr_pages (P, page_size, rope),
    block_tables (B, n_max) int32, lengths (B,) int32.  Returns (B,H,r).
    The kernel is float32 at r = ``MLA_RANK``, rope = ``MLA_ROPE`` and H
    a multiple of ``MLA_HEAD_MULTIPLE``; its splits come from static
    shapes, so a CUDA graph can hold the call."""
    name = "paged_mla_decode"
    _no_dtensor(name, (q_lat, q_pe, ckv_pages, kr_pages, block_tables,
                       lengths))
    if q_lat.ndim != 3 or q_pe.ndim != 3 or ckv_pages.ndim != 3 or \
            kr_pages.ndim != 3 or block_tables.ndim != 2:
        raise ValueError(f"{name}: bad shapes q_lat{tuple(q_lat.shape)} "
                         f"q_pe{tuple(q_pe.shape)} "
                         f"ckv{tuple(ckv_pages.shape)} "
                         f"kr{tuple(kr_pages.shape)}")
    B, H, r = q_lat.shape
    P, ps, rope = kr_pages.shape
    if q_pe.shape != (B, H, rope) or ckv_pages.shape != (P, ps, r) or \
            block_tables.shape[0] != B:
        raise ValueError(f"{name}: q_lat{tuple(q_lat.shape)} "
                         f"q_pe{tuple(q_pe.shape)} do not match "
                         f"ckv{tuple(ckv_pages.shape)} "
                         f"kr{tuple(kr_pages.shape)} / "
                         f"tables{tuple(block_tables.shape)}")
    dev = _check(name, {"q_lat": q_lat, "q_pe": q_pe, "ckv_pages": ckv_pages,
                        "kr_pages": kr_pages})
    _no_backward(name, dev, (q_lat, q_pe, ckv_pages, kr_pages))
    _lengths_ok(name, lengths, B, dev)
    if block_tables.dtype != torch.int32 or block_tables.device != dev:
        raise ValueError(f"{name}: block_tables must be int32 on {dev}")
    if dev.type == "cpu":
        return ref.paged_mla_decode_ref(q_lat, q_pe, ckv_pages, kr_pages,
                                        block_tables, lengths, scale=scale)
    _contiguous(name, {"q_lat": q_lat, "q_pe": q_pe, "ckv_pages": ckv_pages,
                       "kr_pages": kr_pages, "block_tables": block_tables,
                       "lengths": lengths})
    if (r, rope) != (MLA_RANK, MLA_ROPE) or H % MLA_HEAD_MULTIPLE or \
            q_lat.dtype != torch.float32:
        raise NoPlanError(
            f"{name}: the kernel takes float32 at r={MLA_RANK}, "
            f"rope={MLA_ROPE} and H a multiple of {MLA_HEAD_MULTIPLE}; "
            f"got {q_lat.dtype} r={r} rope={rope} H={H}")
    n_max = block_tables.shape[1]
    n_split = mla_splits(n_max * ps, B, H, sm_count(dev))
    check_grid(name, mla_grid(B, H, n_split))
    ws_bytes = _mla_ws_bytes(B, H, r, n_split)
    _work(name, 2 * B * H * n_max * ps * (2 * r + rope),
          (q_lat, q_pe, ckv_pages, kr_pages, block_tables, lengths),
          _nbytes(q_lat.shape, q_lat.dtype), ws_bytes)
    if dev.type == "meta":
        return torch.empty_like(q_lat)
    _aligned(name, {"q_lat": q_lat, "q_pe": q_pe, "ckv_pages": ckv_pages,
                    "kr_pages": kr_pages})
    from repro_torch.kernels.build import load

    lib = load("mla_decode")
    o = torch.empty_like(q_lat)
    ws = torch.empty(max(ws_bytes // 4, 1), dtype=torch.float32, device=dev)
    err = lib.paged_mla_decode_fwd(
        q_lat.data_ptr(), q_pe.data_ptr(), ckv_pages.data_ptr(),
        kr_pages.data_ptr(), block_tables.data_ptr(), lengths.data_ptr(),
        o.data_ptr(), ws.data_ptr(), B, H, r, rope, P, ps, n_max, n_split,
        float(scale), _stream(q_lat))
    _raise_on(name, err)
    _count(name, (B, n_max, ps, H, r, rope), q_lat.dtype)
    return o


@dataclass(frozen=True)
class SsdPlan:
    """How the SSD intra-chunk kernel lays one call out on the card: per
    (chunk, head), n_y y tiles of tr query rows and n_s S_loc tiles of ns
    state rows, each one block; the grid puts every (chunk, head)'s
    n_heavy heaviest y tiles first, then its S_loc tiles, then the other
    y tiles, heaviest first (tile rank r covers blocks r * H * BC on)."""

    tr: int             # query rows a y tile
    n_y: int            # y tiles a (chunk, head): ceil(L / tr)
    ns: int             # state rows an S_loc tile
    n_s: int            # S_loc tiles a (chunk, head): ceil(N / ns)
    n_heavy: int        # y tiles placed before the S_loc tiles
    threads: int        # threads a block: 4 tr
    smem: int           # dynamic shared-memory bytes a block
    blocks: int         # the grid: (n_y + n_s) * H * BC
    blocks_per_sm: int  # blocks an SM holds by shared memory and threads


def ssd_smem(L, P, N, tr, ns) -> int:
    """The SSD kernel's dynamic shared memory a block at tr query rows a
    y tile and ns state rows an S_loc tile: the larger of the two tiles'
    layouts (see ``ssd_layout``)."""
    KB, L16 = SSD_KEY_BLOCK, -(-L // 16) * 16
    ldn, ldp = -(-N // 4) * 4 + 4, -(-P // 4) * 4 + 4
    y_floats = tr * ldn + KB * ldn + KB * ldp + tr * (KB + 16) + 2 * L16
    s_floats = 2 * (KB * (ns + 4) + KB * ldp) + 2 * L16
    return 4 * max(y_floats, s_floats)


def ssd_layout(L, P, N, tr, ns, H=1, BC=1, n_heavy=0):
    """The SSD kernel's plan with tr query rows a y tile and ns state rows
    an S_loc tile, for BC chunks of H heads: its shared memory (the
    larger of the two tiles' layouts in ``csrc/ssd_scan.cu``: a y tile
    holds C [tr][ldn], one staged block of ``SSD_KEY_BLOCK`` B and x rows
    [KB][ldn / ldp], M [tr][KB + 16], cum and dt [L16]; an S_loc tile B
    w_end [KB][ns + 4] and x [KB][ldp] in two stages, cum and dt [L16])
    and the blocks an SM holds (registers are capped at 128 a thread),
    with n_heavy y tiles before the S_loc tiles in the grid.  Raises
    ``NoPlanError`` for a shape or split the kernel does not take,
    ``SharedMemoryError`` above ``SMEM_LIMIT`` and ValueError for an
    order outside the tiles."""
    if not (1 <= min(L, P, N) and max(L, P, N) <= SSD_MAX_DIM):
        raise NoPlanError(f"ssd_intra_chunk: L={L}, P={P}, N={N}; the "
                          f"kernel takes each from 1 to {SSD_MAX_DIM}")
    if tr not in SSD_TILE_ROWS or ns % (tr // 4) or \
            ns // (tr // 4) not in SSD_STATE_ROWS_A_THREAD:
        raise NoPlanError(f"ssd_intra_chunk: no kernel for tr={tr}, ns={ns} "
                          f"(tr in {SSD_TILE_ROWS}, ns = tr / 4 times one "
                          f"of {SSD_STATE_ROWS_A_THREAD})")
    smem = ssd_smem(L, P, N, tr, ns)
    if smem > SMEM_LIMIT:
        raise SharedMemoryError(f"ssd_intra_chunk: tr={tr} needs {smem} B "
                                f"of shared memory a block, above "
                                f"{SMEM_LIMIT}")
    n_y, n_s = -(-L // tr), -(-N // ns)
    if not 0 <= n_heavy <= n_y:
        raise ValueError(f"ssd_intra_chunk: n_heavy={n_heavy} outside "
                         f"[0, {n_y}]")
    threads = 4 * tr
    return SsdPlan(tr=tr, n_y=n_y, ns=ns, n_s=n_s, n_heavy=n_heavy,
                   threads=threads, smem=smem,
                   blocks=(n_y + n_s) * H * BC,
                   blocks_per_sm=min(SM_SMEM // (smem + SMEM_RESERVED),
                                     SM_REGISTERS // (threads * 128)))


@functools.lru_cache(maxsize=None)
def ssd_plan(L, P, N, H, BC, n_sm):
    """The SSD kernel's layout for BC chunks of L steps, H heads of P and
    state N on a card of n_sm SMs: y tiles of ``SSD_PLAN_ROWS`` query
    rows, and, as ``tools/kernel_sweep.py --parts ssd`` measured best on
    an H100 at zamba2-7b's prefills (1-3 chunks, H = 112, P = N = 64):

    * while the grid fits in ``SSD_WIDE_WAVES`` waves, one S_loc tile of
      64 state rows (three blocks an SM) behind the two heaviest y tiles;
    * past that, S_loc tiles of 32 state rows first (four blocks an SM),
      then the y tiles, heaviest first.

    Raises ``KernelPlanError`` for a shape the kernel does not take."""
    if N > 32:
        wide = ssd_layout(L, P, N, SSD_PLAN_ROWS, 64, H, BC,
                          n_heavy=min(2, -(-L // SSD_PLAN_ROWS)))
        if wide.blocks <= SSD_WIDE_WAVES * wide.blocks_per_sm * n_sm:
            return wide
    return ssd_layout(L, P, N, SSD_PLAN_ROWS, 32, H, BC)


def ssd_intra_chunk(x, Bm, Cm, dt, A_log):
    """Mamba2 SSD, intra-chunk part.  x: (B,nc,L,H,P); Bm/Cm: (B,nc,L,N);
    dt: (B,nc,L,H) post-softplus; A_log: (H,).  Returns float32 (y_intra
    (B,nc,L,H,P), S_loc (B,nc,H,N,P), Lam (B,nc,H)): see
    ``ref.ssd_intra_chunk_ref``.  On the card, one launch laid out by
    ``ssd_plan``."""
    _no_dtensor("ssd_intra_chunk", (x, Bm, Cm, dt, A_log))
    if x.ndim != 5 or Bm.ndim != 4 or Bm.shape != Cm.shape or dt.ndim != 4:
        raise ValueError(f"ssd_intra_chunk: bad shapes x{tuple(x.shape)} "
                         f"B{tuple(Bm.shape)} C{tuple(Cm.shape)} "
                         f"dt{tuple(dt.shape)}")
    B, nc, L, H, P = x.shape
    N = Bm.shape[-1]
    if Bm.shape[:3] != (B, nc, L) or dt.shape != (B, nc, L, H) or \
            A_log.shape != (H,):
        raise ValueError(f"ssd_intra_chunk: x{tuple(x.shape)} does not "
                         f"match B/C{tuple(Bm.shape)} dt{tuple(dt.shape)} "
                         f"A_log{tuple(A_log.shape)}")
    dev = _check("ssd_intra_chunk", {"x": x, "Bm": Bm, "Cm": Cm, "dt": dt})
    if A_log.device != dev:
        raise ValueError(f"ssd_intra_chunk: A_log on {A_log.device}, "
                         f"inputs on {dev}")
    _no_backward("ssd_intra_chunk", dev, (x, Bm, Cm, dt, A_log))
    if dev.type == "cpu":
        return ref.ssd_intra_chunk_ref(x, Bm, Cm, dt, A_log)
    _contiguous("ssd_intra_chunk", {"x": x, "Bm": Bm, "Cm": Cm, "dt": dt})
    plan = ssd_plan(L, P, N, H, B * nc, sm_count(dev))
    check_grid("ssd_intra_chunk", (plan.blocks, 1, 1))
    _work("ssd_intra_chunk", 2 * B * nc * L * (L * N + L * H * P + H * N * P),
          (x, Bm, Cm, dt, A_log), 4 * B * nc * H * (L * P + N * P + 1))
    y = torch.empty((B, nc, L, H, P), dtype=torch.float32, device=dev)
    s_loc = torch.empty((B, nc, H, N, P), dtype=torch.float32, device=dev)
    lam = torch.empty((B, nc, H), dtype=torch.float32, device=dev)
    if dev.type == "meta":
        return y, s_loc, lam
    from repro_torch.kernels.build import load

    lib = load("ssd_scan")
    a_log = _f32(A_log)
    err = lib.ssd_intra_chunk_fwd(
        x.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), dt.data_ptr(),
        a_log.data_ptr(), y.data_ptr(), s_loc.data_ptr(), lam.data_ptr(),
        B * nc, L, H, P, N, plan.tr, plan.ns, plan.n_heavy, plan.threads,
        plan.smem, _DTYPES[x.dtype], _stream(x))
    _raise_on("ssd_intra_chunk", err)
    _count("ssd_intra_chunk", (B, nc, L, H), x.dtype)
    return y, s_loc, lam


def ssd_chunked(x, Bm, Cm, dt, A_log, *, chunk=128, initial_state=None):
    """Chunked Mamba2 SSD (no D skip): the intra-chunk kernel, then the
    inter-chunk recurrence over chunks and the inter-chunk output in
    torch, as ``repro.kernels.ssd_scan.ssd_chunked`` does around its
    Pallas call.  x: (B,S,H,P); Bm/Cm: (B,S,N); dt: (B,S,H); the chunk
    is L = min(chunk, S) and must divide S (callers pad).  Returns (y
    (B,S,H,P) in x's dtype, final state (B,H,N,P) float32)."""
    _no_dtensor("ssd_chunked", (x, Bm, Cm, dt, A_log, initial_state))
    _no_backward("ssd_chunked", x.device,
                 (x, Bm, Cm, dt, A_log, initial_state))
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    L = min(chunk, S)
    if S % L:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of the "
                         f"chunk {L}; pad the sequence first")
    nc = S // L
    y_intra, S_loc, Lam = ssd_intra_chunk(
        x.reshape(B, nc, L, H, P), Bm.reshape(B, nc, L, N),
        Cm.reshape(B, nc, L, N), dt.reshape(B, nc, L, H), A_log)
    # inter-chunk recurrence: state before chunk c, S_c = S_{c-1} Lam + S_loc
    run = (torch.zeros((B, H, N, P), dtype=torch.float32, device=x.device)
           if initial_state is None else initial_state.float())
    before = []
    for c in range(nc):
        before.append(run)
        run = run * Lam[:, c, :, None, None] + S_loc[:, c]
    S_before = torch.stack(before, dim=1)                 # (B,nc,H,N,P)
    dA = dt.float().reshape(B, nc, L, H) * -torch.exp(A_log.float())
    decay_in = torch.exp(torch.cumsum(dA, dim=2))         # (B,nc,L,H)
    y_inter = torch.einsum("bcln,bchnp,bclh->bclhp",
                           Cm.float().reshape(B, nc, L, N), S_before,
                           decay_in)
    return (y_intra + y_inter).to(x.dtype).reshape(B, S, H, P), run


@dataclass(frozen=True)
class SlstmPlan:
    """How the sLSTM prefill kernel lays one call out on the card."""

    cluster: int      # C: blocks of one head's cluster
    units: int        # units of its head a block owns, for all 4 gates
    threads: int      # threads a block: one warp per 2 units
    smem_slots: int   # 32-row slots of the block's R slice in shared memory
    reg_slots: int    # ... in registers (the last k rows)
    rows: int         # batch rows one cluster carries (ceil(B / rows)
                      # clusters a head)
    smem: int         # dynamic shared-memory bytes a block

    @property
    def reg_rows(self) -> int:
        """The k rows of R held in registers: [hd - reg_rows, hd) when hd
        is a multiple of 32."""
        return 32 * self.reg_slots


@functools.lru_cache(maxsize=None)
def slstm_plan(B, H, hd):
    """The sLSTM kernels' layout for B rows of H heads of hd units.  One
    cluster per head: the fewest blocks C (a power of two, at most
    ``SLSTM_MAX_CLUSTER``) that leave each block an even count of at most 32
    units; the last ``SLSTM_REG_SLOTS`` 32-row slots of the block's R
    slice in registers and the rest in shared memory; up to
    ``SLSTM_MAX_ROWS`` rows a cluster.  Raises ValueError for an hd that
    fits no plan: not a multiple of 8 (the one-step kernel's 8 units a
    block), above ``SLSTM_MAX_HEAD_DIM``, with no such cluster, or with
    more shared memory than a block's ``SMEM_LIMIT`` (``NoPlanError``,
    ``ClusterError`` or ``SharedMemoryError``, all ``KernelPlanError``)."""
    if hd < 8 or hd % 8 or hd > SLSTM_MAX_HEAD_DIM or B < 1 or H < 1:
        raise NoPlanError(
            f"slstm_scan: no kernel plan for head dim {hd} (the kernels "
            f"take multiples of 8 up to {SLSTM_MAX_HEAD_DIM}), B={B}, H={H}")
    C = next((c for c in (1, 2, 4, 8, 16) if c <= SLSTM_MAX_CLUSTER
              and hd % c == 0 and (hd // c) % 2 == 0 and hd // c <= 32),
             None)
    if C is None:
        raise ClusterError(
            f"slstm_scan: head dim {hd} splits into no cluster of at most "
            f"{SLSTM_MAX_CLUSTER} blocks of an even count of at most 32 "
            "units")
    units = hd // C
    slots = -(-hd // 32)
    reg = min(slots, SLSTM_REG_SLOTS)
    rows = min(B, SLSTM_MAX_ROWS)
    smem = (16 + (units // 2) * (slots - reg) * 1024      # 2 mbarriers, R
            + 4 * (2 * rows * 32 * slots + 2 * rows * 4 * units
                   + 3 * rows * units))
    if smem > SMEM_LIMIT:
        raise SharedMemoryError(f"slstm_scan: head dim {hd} needs {smem} B of "
                         f"shared memory a block, above {SMEM_LIMIT}")
    return SlstmPlan(cluster=C, units=units, threads=16 * units,
                     smem_slots=slots - reg, reg_slots=reg, rows=rows,
                     smem=smem)


#: the one-step sLSTM kernel: units of one head a block owns, batch rows
#: a block carries, threads a block (``STEP_*`` in ``csrc/slstm_scan.cu``)
SLSTM_STEP_UNITS, SLSTM_STEP_ROWS, SLSTM_STEP_THREADS = 8, 8, 256


def slstm_grid(B, S, H, hd) -> tuple[int, int, int]:
    """The grid the sLSTM wrapper launches for B rows of S steps: the
    prefill kernel's (H * cluster, ceil(B / rows)) for S > 1, the one-step
    kernel's (d / 8, ceil(B / 8)) for S = 1."""
    if S == 1:
        return (H * hd // SLSTM_STEP_UNITS, -(-B // SLSTM_STEP_ROWS), 1)
    plan = slstm_plan(B, H, hd)
    return H * plan.cluster, -(-B // plan.rows), 1


def _slstm_gates(R):
    """R as its four (H, hd, hd) gate tensors: a stacked (4,H,hd,hd)
    tensor is split into views, without a copy."""
    if isinstance(R, torch.Tensor):
        if R.ndim != 4 or R.shape[0] != 4:
            raise ValueError(f"slstm_scan: bad shape R{tuple(R.shape)}")
        return R.unbind(0)
    gates = tuple(R)
    if len(gates) != 4 or any(
            not isinstance(g, torch.Tensor) or g.ndim != 3
            or g.shape != gates[0].shape for g in gates):
        raise ValueError("slstm_scan: R must be a (4,H,hd,hd) tensor or "
                         "four (H,hd,hd) gate tensors (i, f, z, o)")
    return gates


def slstm_scan(pre, R, *, state=None):
    """The sLSTM recurrence over a whole sequence in one launch.  pre:
    (B,S,4,d) gate pre-activations (gates i, f, z, o); R: block-diagonal
    recurrent weights, H*hd = d, either a (4,H,hd,hd) tensor or the four
    gate tensors (r_i, r_f, r_z, r_o), each (H,hd,hd); state: None (the
    fresh state, exactly the TPU kernel's function) or (c, n, h, m), each
    (B,d).  Returns (h over time (B,S,d) in pre's dtype, final (c, n, h,
    m) float32): see ``ref.slstm_scan_ref``.  On the card S = 1 launches
    the one-step kernel, S > 1 the cluster kernel (``slstm_plan``)."""
    _no_dtensor("slstm_scan", (pre, *(R if isinstance(R, (tuple, list))
                                     else (R,)), *(state or ())))
    gates = _slstm_gates(R)
    if pre.ndim != 4 or pre.shape[2] != 4:
        raise ValueError(f"slstm_scan: bad shape pre{tuple(pre.shape)}")
    B, S, _, d = pre.shape
    H, hd, hd2 = gates[0].shape
    if hd != hd2 or H * hd != d or S < 1:
        raise ValueError(f"slstm_scan: pre{tuple(pre.shape)} does not match "
                         f"R gates {tuple(gates[0].shape)} (need H*hd = d, "
                         "S >= 1)")
    dev = _check("slstm_scan", {"pre": pre})
    if any(g.device != dev or not g.is_floating_point() for g in gates):
        raise ValueError(f"slstm_scan: R must be floating on {dev}")
    if state is not None:
        if len(state) != 4 or any(t.shape != (B, d) or t.device != dev
                                  for t in state):
            raise ValueError(f"slstm_scan: state must be 4 tensors of "
                             f"({B}, {d}) on {dev}")
    _no_backward("slstm_scan", dev, (pre, *gates, *(state or ())))
    if dev.type == "cpu":
        R4 = R if isinstance(R, torch.Tensor) else torch.stack(gates)
        return ref.slstm_scan_ref(pre, R4, state)
    _contiguous("slstm_scan", {"pre": pre, **{
        f"state[{i}]": t for i, t in enumerate(state or ())}})
    plan = slstm_plan(B, H, hd)
    check_grid("slstm_scan", slstm_grid(B, S, H, hd))
    _work("slstm_scan", 8 * B * S * H * hd * hd, (pre, *gates, *(state or ())),
          _nbytes((B, S, d), pre.dtype) + 16 * B * d)
    if dev.type == "meta":
        out = torch.empty((4, B, d), dtype=torch.float32, device=dev)
        return (torch.empty((B, S, d), dtype=pre.dtype, device=dev),
                tuple(out.unbind(0)))
    r = [_f32(g) for g in gates]              # no copy when f32 already
    _aligned("slstm_scan", dict(zip(("r_i", "r_f", "r_z", "r_o"), r)))
    st = (None,) * 4 if state is None else [_f32(t) for t in state]
    from repro_torch.kernels.build import load

    lib = load("slstm_scan")
    out = torch.empty((4, B, d), dtype=torch.float32, device=dev)
    y = torch.empty((B, S, d), dtype=pre.dtype, device=dev)
    ptrs = [t.data_ptr() for t in r] + [y.data_ptr()] + [
        None if t is None else t.data_ptr() for t in st]
    if S == 1:
        err = lib.slstm_step_fwd(pre.data_ptr(), *ptrs, out.data_ptr(), B, d,
                                 H, hd, _DTYPES[pre.dtype], _stream(pre))
        key = "slstm_scan_s1"
    else:
        err = lib.slstm_scan_fwd(pre.data_ptr(), *ptrs, out.data_ptr(), B, S,
                                 d, H, hd, plan.cluster, plan.reg_slots,
                                 plan.rows, _DTYPES[pre.dtype], _stream(pre))
        key = "slstm_scan"
    _raise_on("slstm_scan", err)
    _count(key, (B, S, H, hd), pre.dtype)
    return y, tuple(out.unbind(0))
