"""Paged KV-cache allocation for continuous batching.

The decode cache is a global pool of fixed-size pages — every
attention-cache leaf is ``(layers, n_pages, page_size, ...)`` — and
``PagePool`` hands out pages and maintains the per-sequence *block
tables* that the paged ``decode_attention`` kernel consumes.  Pages are
recycled LIFO so a hot working set stays small; ``fragmentation()``
reports how much of the live pages' token capacity is actually filled
(internal fragmentation is the price of fixed-size paging).

``insert_pages`` writes a batch-1 prefill cache into the pool in place
(``index_copy_``) where the JAX package rebinds a donated buffer; into a
sharded pool (DTensors of a mesh-built bundle) each rank writes its tile.

``SlotPool`` remains as the *row* allocator: the batched decode launch
has a fixed leading batch axis, and each live sequence owns one row in
it (tokens/lengths/table rows).  Both allocators guard against
double-free — releasing a non-live slot/sequence raises instead of
corrupting the free list (previously two requests could be handed the
same slot).
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import sharding
from repro_torch.common.pytree import tree_map


class PagesExhausted(RuntimeError):
    """The page pool cannot satisfy an allocation; admission control
    should have prevented this — treat it as a scheduler bug."""


class SlotPool:
    """Fixed-capacity batch-row allocator with a double-free guard."""

    def __init__(self, max_slots: int):
        self.max_slots = max_slots
        self._free = list(range(max_slots))[::-1]
        self.lengths = [0] * max_slots
        self.live = [False] * max_slots

    def alloc(self) -> int | None:
        if not self._free:
            return None
        s = self._free.pop()
        self.live[s] = True
        return s

    def release(self, slot: int):
        if not self.live[slot]:
            raise ValueError(
                f"SlotPool.release: slot {slot} is not live (double "
                "free would hand the same slot to two requests)")
        self.live[slot] = False
        self.lengths[slot] = 0
        self._free.append(slot)

    @property
    def n_live(self) -> int:
        return sum(self.live)


class PagePool:
    """Fixed-size KV pages + per-sequence block tables.

    ``alloc(seq, n_tokens)`` claims enough pages for ``n_tokens``;
    ``extend(seq, new_len)`` grows a live sequence's table as decode
    crosses page boundaries; ``free(seq)`` returns the pages (guarded
    against double free).  ``used_tokens`` tracks the filled prefix of
    each sequence so ``fragmentation()`` can report internal slack.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError("n_pages and page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self._free = list(range(n_pages))[::-1]
        self.tables: dict[object, list[int]] = {}
        self.used_tokens: dict[object, int] = {}
        self.pages_peak = 0

    # -- capacity -------------------------------------------------------
    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_live_pages(self) -> int:
        return self.n_pages - len(self._free)

    @property
    def n_seqs(self) -> int:
        return len(self.tables)

    def pages_for(self, n_tokens: int) -> int:
        return -(-max(n_tokens, 0) // self.page_size) if n_tokens else 0

    def can_alloc(self, n_tokens: int) -> bool:
        return self.pages_for(max(n_tokens, 1)) <= len(self._free)

    # -- lifecycle ------------------------------------------------------
    def alloc(self, seq, n_tokens: int) -> list[int]:
        """Claim pages for a new sequence holding ``n_tokens``; at least
        one page is always allocated so the block table is never empty."""
        if seq in self.tables:
            raise ValueError(f"PagePool.alloc: sequence {seq!r} already live")
        need = max(self.pages_for(n_tokens), 1)
        if need > len(self._free):
            raise PagesExhausted(
                f"PagePool.alloc: need {need} pages for {seq!r}, only "
                f"{len(self._free)} free of {self.n_pages}")
        pages = [self._free.pop() for _ in range(need)]
        self.tables[seq] = pages
        self.used_tokens[seq] = max(n_tokens, 0)
        self.pages_peak = max(self.pages_peak, self.n_live_pages)
        return pages

    def extend(self, seq, new_len: int) -> list[int]:
        """Grow a live sequence to ``new_len`` tokens; returns the pages
        added (possibly empty when the current tail page still has room)."""
        pages = self.tables.get(seq)
        if pages is None:
            raise ValueError(f"PagePool.extend: sequence {seq!r} not live")
        need = max(self.pages_for(new_len), 1) - len(pages)
        if need > len(self._free):
            raise PagesExhausted(
                f"PagePool.extend: need {need} more pages for {seq!r}, "
                f"only {len(self._free)} free of {self.n_pages}")
        added = [self._free.pop() for _ in range(max(need, 0))]
        pages.extend(added)
        self.used_tokens[seq] = max(self.used_tokens[seq], new_len)
        self.pages_peak = max(self.pages_peak, self.n_live_pages)
        return added

    def free(self, seq) -> None:
        """Return a sequence's pages to the pool.  Raises on a sequence
        that is not live — the SlotPool double-free guard, ported."""
        pages = self.tables.pop(seq, None)
        if pages is None:
            raise ValueError(
                f"PagePool.free: sequence {seq!r} is not live (double "
                "free would hand the same pages to two sequences)")
        self.used_tokens.pop(seq, None)
        self._free.extend(reversed(pages))

    # -- views ----------------------------------------------------------
    def block_table(self, seq) -> list[int]:
        return list(self.tables[seq])

    def table_array(self, seqs, n_max: int) -> np.ndarray:
        """(len(seqs), n_max) int32 block-table array for the paged
        kernel; missing/short rows pad with 0 (masked by lengths)."""
        out = np.zeros((len(seqs), n_max), np.int32)
        for i, seq in enumerate(seqs):
            pages = self.tables.get(seq, ())
            if len(pages) > n_max:
                raise ValueError(
                    f"PagePool.table_array: sequence {seq!r} owns "
                    f"{len(pages)} pages > n_max={n_max}")
            out[i, :len(pages)] = pages
        return out

    def fragmentation(self) -> dict:
        """Internal-fragmentation accounting: how much of the live
        pages' token capacity is actually filled."""
        live = self.n_live_pages
        cap = live * self.page_size
        used = sum(self.used_tokens.values())
        return {
            "pages_total": self.n_pages,
            "pages_free": len(self._free),
            "pages_live": live,
            "pages_peak": self.pages_peak,
            "tokens_capacity": cap,
            "tokens_used": used,
            "slack_tokens": cap - used,
            "internal_frag": round(1.0 - used / cap, 4) if cap else 0.0,
        }


# ---------------------------------------------------------------------------
# cache tree helpers
# ---------------------------------------------------------------------------

def insert_pages(paged_cache, one_cache, page_ids, n_tokens: int):
    """Copy a batch-1 *dense* prefill cache into the page pool, in
    place.  Returns the (same) paged cache.

    Paged leaves are (layers, n_pages, page_size, ...); dense leaves
    are (layers, 1, T, ...) with T >= the pages' token span.  The first
    ``len(page_ids) * page_size`` positions are copied page-by-page;
    garbage past ``n_tokens`` lands in the owned pages' tails, where the
    length mask hides it.

    A DTensor pool (a mesh-built bundle's) holds on each rank a tile:
    pages over the data axes, each page's slots over "model"; the dense
    cache splits its sequence into contiguous parts over "model"
    instead.  The one-row cache is gathered whole on each rank (through
    ``sharding.local_as``), and each rank copies the tile's slots of the
    pages it holds.
    """
    def one(pages, dense):
        if sharding.is_dtensor(pages):
            return _insert_tile(pages, dense, page_ids)
        ps = pages.shape[2]
        span = len(page_ids) * ps
        chunks = dense[:, 0, :span].reshape(
            dense.shape[0], len(page_ids), ps, *dense.shape[3:])
        ids = torch.as_tensor(page_ids, dtype=torch.long, device=pages.device)
        pages.index_copy_(1, ids, chunks.to(pages.dtype))
        return pages

    tree_map(one, paged_cache, one_cache)
    return paged_cache


def _insert_tile(pages, dense, page_ids):
    """``insert_pages`` for one DTensor pool leaf (layers, n_pages,
    page_size, ...): this rank's tile of pages [p0, p0 + P) and slots
    [s0, s0 + ps) written from the whole one-row cache."""
    from torch.distributed.tensor import Replicate

    from repro_torch.layers.attention import pool_tile

    mesh = pages.device_mesh
    loc = pages.to_local()
    P, ps = loc.shape[1:3]
    p0, _, s0, _ = pool_tile(pages[0])[1]     # a layer's pool: its tile
    whole = sharding.local_as(dense, mesh, [Replicate()] * mesh.ndim)
    held = [(i, p - p0) for i, p in enumerate(page_ids) if p0 <= p < p0 + P]
    if held:
        n, page_size = len(page_ids), pages.shape[2]
        chunks = whole[:, 0, :n * page_size].reshape(
            whole.shape[0], n, page_size, *whole.shape[3:])[:, :, s0:s0 + ps]
        dev = loc.device
        src = torch.as_tensor([i for i, _ in held], dtype=torch.long,
                              device=dev)
        dst = torch.as_tensor([j for _, j in held], dtype=torch.long,
                              device=dev)
        loc.index_copy_(1, dst, chunks.index_select(1, src).to(loc.dtype))
    return pages
