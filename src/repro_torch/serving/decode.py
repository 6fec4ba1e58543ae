"""Paged continuous-batching decode streams — the generative half of the
serving scheduler.

One ``DecodeStream`` per generative decoder module: it owns the module's
page pool (``PagePool``), the fixed-width decode rows (``SlotPool``),
and the paged KV cache the engine decodes against.  Requests arrive from
``ServeScheduler`` after their encoder stages complete; each is admitted
into a free row via a batch-1 prefill scattered into freshly allocated
pages, then all live rows — across *tasks*, this is the S2M3 sharing
argument applied to generative heads — decode together in one batched
``paged_decode_attention`` launch per step.

Admission reserves each sequence's worst-case page count up front
(``n_prefix + len(prompt) + max_new_tokens``), so mid-stream ``extend``
can never fail and no preemption is needed; the waiting queue is ordered
by SLO deadline (earliest first), then arrival.  Dead rows point their
block-table entries at a reserved dummy page (page 0), so the batched
scatter never corrupts a live sequence.

The paged pool and the per-request dense prefill cache are float32, as
the reference's are, whatever the bundle computes in: under bfloat16
compute the decode kernels widen q to the pool's dtype
(``layers.attention.paged_attend``) and never copy the pool.
The pool is updated in place — by ``insert_pages`` after each prefill
and by the paged decode step — and never rebound from a copy.

Lock discipline (enforced by ``repro.analysis.concurrency_lint``): all
allocator calls and shared-state mutation happen under ``self._lock``;
prefill/decode dispatch happens outside it.  A tick-level busy flag
keeps concurrent ``tick()`` calls from interleaving device steps.

The batched step runs as one CUDA graph replay where it can: on a CUDA
decoder without a mesh, in a tick whose live rows are all greedy.  The
graph holds the whole step, every kernel the eager step launches, and
ends in the rows' greedy picks; a tick copies its tokens, tables and
lengths from pinned host staging into the graph's static buffers,
replays, and reads the picks once.  The first such tick runs the step
eagerly and captures it; the graph bakes in the pointers of the
decoder's parameters and of the page pool, so a tick that finds one of
them moved (a replan, an evict and re-add) runs eagerly and captures
again.  Every other tick (the CPU, a mesh, a sampled row) runs the step
eagerly: one greedy over the batch and one read for the greedy rows,
and each sampled row its own generator's draw and read.  The kernel
wrappers count a replay's launches from what the capture recorded
(``kernels.ops.recording``).  Counters ``decode.graph_captures`` and
``decode.graph_replays`` count both, labelled by module.

A decoder with MoE layers also counts, in each prefill and each tick,
the (token, expert) pairs its live tokens route to the experts its
weights hold, summed over the layers (``layers.moe.counting_pairs``):
the graph's step ends in the picks and that count, so the tick's one
read brings both, and a prefill reads it with its first token (a
sampled eager tick reads it once more).  ``prefill`` and ``decode_tick``
spans carry it as ``expert_pairs``, and the counter
``moe.expert_pairs``, labelled by module, sums it.  They also carry
``expert_rows``, the (token, expert) rows the held experts computed: a
tick's every row through every held expert, a prefill's routed pairs
alone.  (A prefill over held
experts reads its MoE layers' segment lengths inside its dispatch:
``layers.moe.moe_apply_routed``.)

A tick's host phases are tracer scopes (``obs.trace.Tracer.scope``):
``s2m3.decode.admit`` around each admission's bookkeeping,
``s2m3.prefill.dispatch`` and ``s2m3.prefill.read`` around its prefill,
then ``s2m3.decode.form``, ``.dispatch``, ``.read`` and ``.retire``
around the batched step.  The ``prefill`` and ``decode_tick`` spans carry
``dispatch_s`` (the dispatch scope's time) and ``syncs`` (the blocking
token reads: 1 a prefill; a tick 1 for its greedy rows and 1 for each
sampled row); a ``decode_tick`` span also carries ``graph``, 1 where the
tick replayed the graph and 0 where it ran eagerly.
"""

from __future__ import annotations

import heapq
import threading
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from repro_torch.common.pytree import tree_leaves
from repro_torch.core.routing import Request
from repro_torch.kernels import ops
from repro_torch.layers.moe import counting_pairs
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.trace import Tracer
from repro_torch.serving.kvcache import PagePool, SlotPool, insert_pages
from repro_torch.serving.sampler import greedy, rid_generator, select_token

_DUMMY = "<dummy>"


@dataclass
class _GenSeq:
    """One generative request's decode state."""

    rid: int
    request: Request
    enc_outputs: dict[str, Any]
    t_submit: float
    tokens: list[int] = field(default_factory=list)
    row: int = -1
    length: int = 0                 # tokens currently in the paged cache
    rng: Any = None                 # torch.Generator seeded from the rid
    done: bool = False
    timeline: list = field(default_factory=list)
    parent: int | None = None       # root span of the owning request
    wait_sid: int = -1              # admission-wait span
    decode_sid: int = -1            # decode-residency span (tick parent)


@dataclass
class TickReport:
    finished: list[_GenSeq]
    prefills: int = 0
    decode_batch: int = 0


def pick_tokens(logits, live) -> tuple[dict[int, int], int]:
    """The live rows' next tokens from an eager step's logits: one greedy
    over the batch and one read for all the greedy rows (the first
    maximal index of each row), then each sampled row's draw from its own
    generator and its read.  Returns ({row: token}, the reads made)."""
    picks: dict[int, int] = {}
    reads = 0
    if any(seq.request.temperature <= 0.0 for _, seq in live):
        top = greedy(logits).tolist()
        reads = 1
        picks = {row: top[row] for row, seq in live
                 if seq.request.temperature <= 0.0}
    for row, seq in live:
        if row not in picks:
            picks[row] = int(select_token(
                logits[row], seq.rng, temperature=seq.request.temperature))
            reads += 1
    return picks, reads


def _total(counts):
    """The summed pair count of what ``counting_pairs`` collected, 0-d
    int32 on the device (None where no MoE layer ran)."""
    return (torch.stack(counts.pairs).sum().to(torch.int32) if counts.pairs
            else None)


class _StepGraph:
    """A stream's batched paged decode step as a CUDA graph that ends in
    the rows' greedy picks: static (rows, 1) tokens, (rows, n_max) tables
    and (rows,) lengths, int32 on the decoder's device, filled each tick
    from pinned host staging; the (rows,) int32 picks each replay
    writes; and ``key``, the pointers the capture baked in."""

    def __init__(self, rows: int, n_max: int, device):
        shapes = ((rows, 1), (rows, n_max), (rows,))
        self.inputs = tuple(torch.zeros(s, dtype=torch.int32, device=device)
                            for s in shapes)
        self.staged = tuple(torch.zeros(s, dtype=torch.int32,
                                        pin_memory=True) for s in shapes)
        self.stream = torch.cuda.Stream(device)
        self.graph = None
        self.key = None
        self.picks = None
        self.tape: list = []

    def fill(self, *arrays) -> None:
        """The tick's tokens, tables and lengths into the static buffers
        on the current stream.  The previous tick's pick read, which
        synchronised, has finished the copies out of the staging."""
        for staged, buf, a in zip(self.staged, self.inputs, arrays):
            staged.numpy()[...] = a
            buf.copy_(staged, non_blocking=True)

    def replay(self):
        self.graph.replay()
        ops.replay_tape(self.tape)
        return self.picks

    def capture(self, step, key) -> None:
        """Capture ``step`` on the static buffers, on the graph's side
        stream, once an eager run at the same shapes has set up what sets
        up on first use.  cuBLAS keeps a workspace for each stream it runs
        on: dropped before and after the capture (as torch's own graph
        trees do), the capture's comes from the graph's private pool,
        which keeps it for the replays, and no second workspace stays
        allocated.  The logits stay in that pool too, unreferenced."""
        graph = torch.cuda.CUDAGraph()
        torch._C._cuda_clearCublasWorkspaces()
        with ops.recording() as tape, \
                torch.cuda.graph(graph, stream=self.stream):
            out = step(*self.inputs)
        torch._C._cuda_clearCublasWorkspaces()
        self.graph, self.key, self.picks, self.tape = graph, key, out, tape


class DecodeStream:
    """Continuous-batching decode state for one generative module."""

    def __init__(self, engine, module: str, *, rows: int, n_pages: int,
                 page_size: int, max_seq_len: int, now=None,
                 tracer: Tracer | None = None,
                 metrics: MetricsRegistry | None = None):
        self.engine = engine
        self.module = module
        self.rt = engine.decoder_runtime(module)
        self.page_size = page_size
        self.max_seq_len = max_seq_len
        self.n_max = -(-max_seq_len // page_size)
        self._now = now or (lambda: 0.0)
        # standalone streams get their own registry/tracer; under a
        # ServeScheduler both are shared so stats and traces are unified
        self.metrics = metrics or MetricsRegistry()
        self.tracer = tracer or Tracer(clock=self._now)
        self.pool = PagePool(n_pages, page_size)
        self.rows = SlotPool(rows)
        self.cache = engine.init_paged_cache(module, n_pages, page_size,
                                             torch.float32)
        self._lock = threading.RLock()
        with self._lock:
            # page 0 is the dummy target for dead rows' scatters
            self.pool.alloc(_DUMMY, 1)
        self.waiting: list = []           # heap: (deadline, t, n, seq)
        self._n_submitted = 0
        self.live: dict[int, _GenSeq] = {}
        self.tables = np.zeros((rows, self.n_max), np.int32)
        self.lengths = np.zeros((rows,), np.int32)
        self._worst: dict[int, int] = {}  # rid -> reserved worst pages
        self._reserved = 0
        self._busy = False
        # counters (read via the int properties / stats_dict)
        self._c_steps = self.metrics.counter("decode.steps", module=module)
        self._c_tokens = self.metrics.counter("decode.tokens", module=module)
        self._c_prefills = self.metrics.counter("decode.prefills",
                                                module=module)
        self._c_xtask = self.metrics.counter("decode.cross_task_batches",
                                             module=module)
        self._c_captures = self.metrics.counter("decode.graph_captures",
                                                module=module)
        self._c_replays = self.metrics.counter("decode.graph_replays",
                                               module=module)
        self._c_pairs = self.metrics.counter("moe.expert_pairs",
                                             module=module)
        self._graph: _StepGraph | None = None
        self._step_rows = 0

    # legacy counter attributes, now views over the metrics registry
    @property
    def decode_steps(self) -> int:
        return int(self._c_steps.value)

    @property
    def decode_tokens(self) -> int:
        return int(self._c_tokens.value)

    @property
    def prefills(self) -> int:
        return int(self._c_prefills.value)

    @property
    def cross_task_decode_batches(self) -> int:
        return int(self._c_xtask.value)

    @property
    def graph_captures(self) -> int:
        return int(self._c_captures.value)

    @property
    def graph_replays(self) -> int:
        return int(self._c_replays.value)

    # -- sizing ---------------------------------------------------------
    def _worst_tokens(self, request: Request) -> int:
        return (self.rt.n_prefix + len(request.prompt)
                + max(int(request.max_new_tokens), 1))

    def validate(self, request: Request) -> None:
        if request.prompt is None or len(request.prompt) == 0:
            raise ValueError(
                f"generative request {request.rid} has no prompt tokens")
        worst = self._worst_tokens(request)
        if worst > self.max_seq_len:
            raise ValueError(
                f"request {request.rid}: prefix+prompt+max_new_tokens="
                f"{worst} exceeds max_seq_len={self.max_seq_len} of "
                f"decoder {self.module!r}")
        with self._lock:
            need = self.pool.pages_for(worst)
            usable = self.pool.n_pages - 1
        if need > usable:
            raise ValueError(
                f"request {request.rid}: needs {need} pages, pool holds "
                f"{usable} usable")

    # -- admission ------------------------------------------------------
    def depth(self) -> int:
        with self._lock:
            return len(self.waiting) + len(self.live)

    def submit(self, rid: int, request: Request,
               enc_outputs: dict[str, Any],
               parent: int | None = None) -> None:
        self.validate(request)
        seq = _GenSeq(rid, request, enc_outputs, self._now(), parent=parent)
        seq.wait_sid = self.tracer.begin(self.module, "admission", rid=rid,
                                         parent=parent)
        deadline = (request.slo_deadline if request.slo_deadline is not None
                    else float("inf"))
        with self._lock:
            heapq.heappush(self.waiting,
                           (deadline, seq.t_submit, self._n_submitted, seq))
            self._n_submitted += 1

    def _outstanding_pages(self) -> int:
        """Reserved-but-not-yet-held pages across live sequences."""
        held = self.pool.n_live_pages - 1          # minus the dummy page
        return self._reserved - held

    def _pop_admittable(self) -> _GenSeq | None:
        """Admit the head of the waiting queue if a row and its
        worst-case page reservation fit; head-of-line order keeps the
        SLO-deadline priority honest.  Takes the (re-entrant) lock
        itself so allocator calls are locked at every call site."""
        with self._lock:
            if not self.waiting:
                return None
            seq = self.waiting[0][3]
            worst = self.pool.pages_for(self._worst_tokens(seq.request))
            if self.pool.n_free - self._outstanding_pages() < worst:
                return None
            row = self.rows.alloc()
            if row is None:
                return None
            heapq.heappop(self.waiting)
            prefix_len = self.rt.n_prefix + len(seq.request.prompt)
            pages = self.pool.alloc(seq.rid, prefix_len)
            seq.row = row
            seq.length = prefix_len
            self._worst[seq.rid] = worst
            self._reserved += worst
            self.tables[row, :] = 0
            self.tables[row, :len(pages)] = pages
            self.lengths[row] = prefix_len
            self.live[row] = seq
            self.tracer.end(seq.wait_sid)
            return seq

    def _finish_locked(self, seq: _GenSeq) -> None:
        with self._lock:
            seq.done = True
            self.pool.free(seq.rid)
            self.rows.release(seq.row)
            del self.live[seq.row]
            self.tables[seq.row, :] = 0
            self.lengths[seq.row] = 0
            self._reserved -= self._worst.pop(seq.rid)

    # -- execution ------------------------------------------------------
    def _prefill(self, seq: _GenSeq):
        """Batch-1 prefill into the sequence's pages + first token.
        Device dispatch — runs outside the lock.  Returns the dispatch
        and read scopes, which the ``prefill`` span spans."""
        req = seq.request
        scope = self.tracer.scope
        with scope("s2m3.decode.admit"):
            with self._lock:
                pages = self.pool.block_table(seq.rid)
            one = self.rt.bundle.init_cache(1, len(pages) * self.page_size,
                                            torch.float32, self.rt.device)
        with scope("s2m3.prefill.dispatch") as disp:
            batch = self.engine.gen_batch(req.prompt, seq.enc_outputs)
            with counting_pairs() as pairs:
                logits, one = self.engine.apply_prefill(self.module, batch,
                                                        one)
            insert_pages(self.cache, one, pages, seq.length)
            seq.rng = rid_generator(seq.rid, logits.device)
        with scope("s2m3.prefill.read") as read:
            tok = select_token(logits[0], seq.rng,
                               temperature=req.temperature)
            n_pairs = _total(pairs)
            experts = {}
            if n_pairs is None:
                seq.tokens.append(int(tok))
            else:
                tok, n_pairs = torch.stack([tok.to(torch.int32),
                                            n_pairs]).tolist()
                seq.tokens.append(tok)
                self._c_pairs.inc(n_pairs)
                experts = {"expert_pairs": n_pairs,
                           "expert_rows": pairs.rows}
        return disp, read, experts

    def _seq_done(self, seq: _GenSeq) -> bool:
        req = seq.request
        return (len(seq.tokens) >= max(int(req.max_new_tokens), 1)
                or seq.tokens[-1] == req.eos_id)

    def _admit_all(self) -> list[_GenSeq]:
        finished = []
        scope = self.tracer.scope
        while True:
            with scope("s2m3.decode.admit"):
                with self._lock:
                    seq = self._pop_admittable()
            if seq is None:
                break
            try:
                disp, read, experts = self._prefill(seq)
            except Exception:
                # a failed prefill must not strand the admitted row,
                # its pages, or the worst-case reservation — the leak
                # the model checker's pages/no-leak invariant flags
                with self._lock:
                    self._finish_locked(seq)
                raise
            with scope("s2m3.decode.admit"):
                seq.timeline.append(self.tracer.record(
                    self.module, "prefill", disp.t0, read.t1, rid=seq.rid,
                    parent=seq.parent, prompt_tokens=len(seq.request.prompt),
                    prefix_len=seq.length, dispatch_s=disp.dur, syncs=1,
                    **experts))
                self._c_prefills.inc()
                if self._seq_done(seq):
                    with self._lock:
                        self._finish_locked(seq)
                    finished.append(seq)
                else:
                    # residency span: every decode tick of this sequence
                    # parents under it
                    seq.decode_sid = self.tracer.begin(
                        self.module, "decode", rid=seq.rid,
                        parent=seq.parent)
        return finished

    @staticmethod
    def graph_engages(rt, live) -> bool:
        """Whether a tick over ``live`` runs as the graph's replay: a
        CUDA decoder without a mesh, every live row greedy."""
        return (rt.device.type == "cuda" and rt.bundle.mesh is None
                and all(seq.request.temperature <= 0.0 for _, seq in live))

    def _greedy_step(self, tokens, tables, lengths):
        """The step the graph holds: the paged decode step over every row,
        then the batch's greedy picks, (rows,) int32, and after them the
        step's routed pairs where the decoder has MoE layers (the rows its
        held experts compute, fixed by the shapes, kept in
        ``_step_rows``)."""
        with counting_pairs() as pairs:
            logits, _ = self.engine.apply_paged_decode(
                self.module, tokens, self.cache, tables, lengths)
        self._step_rows = pairs.rows
        picks = greedy(logits)
        n_pairs = _total(pairs)
        return picks if n_pairs is None else torch.cat([picks, n_pairs[None]])

    def _graph_step(self, rt, tokens, tables, lengths):
        """Fill the graph's inputs and replay it; at pointers the graph
        has not baked in (the first tick, or the parameters or the pool
        rebound) run the step eagerly and capture it instead.  Returns
        the picks on the device and whether the tick replayed."""
        g = self._graph
        if g is None:
            g = self._graph = _StepGraph(*tables.shape, rt.device)
        g.fill(tokens, tables, lengths)
        key = tuple(t.data_ptr()
                    for t in tree_leaves((rt.params, self.cache)))
        if g.key == key:
            self._c_replays.inc()
            return g.replay(), True
        picks = self._greedy_step(*g.inputs)
        g.capture(self._greedy_step, key)
        self._c_captures.inc()
        return picks, False

    def _decode_once(self) -> tuple[list[_GenSeq], int]:
        """One batched decode step over all live rows.  Batch formation
        (incl. page extension) under the lock; dispatch outside it.
        Every row's ``decode_tick`` span is the step's dispatch
        (``dispatch_s``: the tokens', tables' and lengths' copies and
        the graph's replay, or the eager step's launches) and then the
        picks' reads (``syncs``: 1 for the greedy rows, which is all of
        them on a replay, and 1 for each sampled row); ``graph`` is 1
        where the tick replayed the graph."""
        scope = self.tracer.scope
        with scope("s2m3.decode.form"):
            with self._lock:
                tokens = np.zeros((self.rows.max_slots, 1), np.int32)
                live = sorted(self.live.items())
                if not live:
                    return [], 0
                for row, seq in live:
                    # the step inserts at position length: make sure the
                    # owning page exists (reservation guarantees success)
                    added = self.pool.extend(seq.rid, seq.length + 1)
                    if added:
                        table = self.pool.block_table(seq.rid)
                        self.tables[row, :len(table)] = table
                    tokens[row, 0] = seq.tokens[-1]
                tables = self.tables.copy()
                lengths = self.lengths.copy()
                pages_live = self.pool.n_live_pages
                self._c_steps.inc()
                if len({seq.request.model for _, seq in live}) >= 2:
                    self._c_xtask.inc()
        rt = self.engine.decoder_runtime(self.module)
        graphed = self.graph_engages(rt, live)
        replayed = False
        n_pairs = None
        with scope("s2m3.decode.dispatch") as disp:
            if graphed:
                out, replayed = self._graph_step(rt, tokens, tables, lengths)
            else:
                with counting_pairs() as pairs:
                    out, _ = self.engine.apply_paged_decode(
                        self.module, torch.from_numpy(tokens), self.cache,
                        torch.from_numpy(tables), torch.from_numpy(lengths))
        with scope("s2m3.decode.read") as read:
            if graphed:
                top = out.tolist()
                picks, reads = {row: top[row] for row, _ in live}, 1
                if len(top) > len(tokens):
                    n_pairs = top[-1]
            else:
                picks, reads = pick_tokens(out, live)
                if pairs.pairs:
                    n_pairs = int(_total(pairs))
                    self._step_rows = pairs.rows
                    reads += 1
        with scope("s2m3.decode.retire"):
            extra = {} if n_pairs is None else {
                "expert_pairs": n_pairs, "expert_rows": self._step_rows}
            if n_pairs is not None:
                self._c_pairs.inc(n_pairs)
            for row, seq in live:
                self.tracer.record(self.module, "decode_tick", disp.t0,
                                   read.t1, rid=seq.rid,
                                   parent=seq.decode_sid, rows=len(live),
                                   pages_live=pages_live,
                                   dispatch_s=disp.dur, syncs=reads,
                                   graph=int(replayed), **extra)
            finished = []
            with self._lock:
                for row, seq in live:
                    seq.length += 1
                    self.lengths[row] = seq.length
                    self.pool.used_tokens[seq.rid] = seq.length
                    seq.tokens.append(picks[row])
                    self._c_tokens.inc()
                    if self._seq_done(seq):
                        seq.timeline.append(
                            self.tracer.end(seq.decode_sid, t1=self._now()))
                        self._finish_locked(seq)
                        finished.append(seq)
        return finished, len(live)

    def tick(self) -> TickReport:
        """One scheduler service round: admit what fits, then one
        batched decode step.  Returns the finished sequences."""
        with self._lock:
            if self._busy:
                return TickReport([], 0, 0)
            self._busy = True
        try:
            p0 = self.prefills
            finished = self._admit_all()
            prefills = self.prefills - p0
            more, batch = self._decode_once()
            return TickReport(finished + more, prefills, batch)
        finally:
            with self._lock:
                self._busy = False

    # -- introspection ---------------------------------------------------
    def state_view(self):
        """Snapshot this stream as a ``repro_torch.analysis.invariants``
        ``StateView`` so the runtime-tagged invariant subset can be
        evaluated against live serving state (see
        ``ServeScheduler.check_invariants``)."""
        from repro_torch.analysis.invariants import SeqView, StateView, WaitView
        with self._lock:
            free = set(self.pool._free)
            owners: dict[int, object] = {}
            multi: list[int] = []
            for rid, pages in self.pool.tables.items():
                for p in pages:
                    if p in owners or p in free:
                        multi.append(p)
                    owners[p] = rid
            live = tuple(
                SeqView(
                    rid=seq.rid,
                    held_pages=len(self.pool.tables.get(seq.rid, ())),
                    worst_pages=self._worst.get(seq.rid, 0),
                    remaining_tokens=max(
                        int(seq.request.max_new_tokens) - len(seq.tokens), 0),
                    deadline=(seq.request.slo_deadline
                              if seq.request.slo_deadline is not None
                              else float("inf")),
                    model=seq.request.model)
                for _, seq in sorted(self.live.items()))
            waiting = tuple(
                WaitView(rid=seq.rid,
                         worst_pages=self.pool.pages_for(
                             self._worst_tokens(seq.request)),
                         deadline=deadline, model=seq.request.model)
                for deadline, _, _, seq in sorted(self.waiting))
            return StateView(
                pages_total=self.pool.n_pages,
                pages_free=self.pool.n_free,
                page_owners=owners,
                page_multiowner=tuple(multi),
                page_size=self.page_size,
                rows_total=self.rows.max_slots,
                rows_live=self.rows.n_live,
                live=live,
                waiting=waiting,
                terminal=not self.live and not self.waiting,
            )

    # -- stats ----------------------------------------------------------
    def stats_dict(self) -> dict[str, Any]:
        with self._lock:
            frag = self.pool.fragmentation()
            return {
                "decode_steps": self.decode_steps,
                "decode_tokens": self.decode_tokens,
                "prefills": self.prefills,
                "cross_task_decode_batches": self.cross_task_decode_batches,
                "decode_rows": self.rows.max_slots,
                "live_rows": len(self.live),
                "waiting": len(self.waiting),
                "pages_total": frag["pages_total"],
                "pages_live": frag["pages_live"],
                "pages_peak": frag["pages_peak"],
                "page_occupancy": round(
                    frag["pages_live"] / frag["pages_total"], 4),
                "internal_frag": frag["internal_frag"],
            }
