"""Paged KV cache: fixed page pool + per-slot block tables (port of
``repro.serve.kvcache``, without the prefix index and spill of later
slices).

A pool of fixed-size pages is shared by all serving slots; each slot owns a
block table, a row of page ids. A slot's cache always holds the contiguous
positions 0..len-1, so the read mask is a function of the per-slot fill
count alone and recycled pages need no invalidation.

Page 0 is a reserved scratch page: idle slots and left-padded prompt
positions write there, and nothing ever reads it. The allocator
(``PagePool``) is host-side numpy; ``prefill_page_index`` runs on the
device of its tensors.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

SCRATCH_PAGE = 0


@dataclasses.dataclass(frozen=True)
class PageSpec:
    """Geometry of the page pool."""

    n_pages: int          # total pages, including the reserved scratch page
    page_size: int        # tokens per page
    max_pages: int        # block-table width (pages a single slot may hold)

    @property
    def max_len(self) -> int:
        return self.max_pages * self.page_size

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)


def default_page_spec(n_slots: int, max_len: int,
                      page_size: int = 16) -> PageSpec:
    """Fully-provisioned pool: every slot can hold max_len tokens."""
    max_pages = -(-max_len // page_size)
    return PageSpec(n_pages=1 + n_slots * max_pages, page_size=page_size,
                    max_pages=max_pages)


class PagePool:
    """Host-side refcounted page allocator and per-slot block tables.

    Decode only ever writes to a slot's own tail pages (idle slots all
    target the scratch page), so a page's writers never collide."""

    def __init__(self, spec: PageSpec, n_slots: int):
        self.spec = spec
        self.n_slots = n_slots
        self._free = list(range(spec.n_pages - 1, SCRATCH_PAGE, -1))
        self.tables = np.full((n_slots, spec.max_pages), -1, np.int32)
        self.refcount = np.zeros(spec.n_pages, np.int32)

    @property
    def n_free(self) -> int:
        return len(self._free)

    def can_alloc(self, n_tokens: int) -> bool:
        """True when a request of ``n_tokens`` could be admitted now (a
        request wider than one block-table row never can)."""
        need = self.spec.pages_for(n_tokens)
        return need <= self.spec.max_pages and need <= len(self._free)

    def alloc(self, slot: int, n_tokens: int) -> None:
        """Map ``slot`` to fresh pages for n_tokens."""
        need = self.spec.pages_for(n_tokens)
        if need > self.spec.max_pages:
            raise ValueError(f"request needs {need} pages > block-table "
                             f"width {self.spec.max_pages}")
        if need > len(self._free):
            raise RuntimeError(f"page pool exhausted: need {need}, free "
                               f"{len(self._free)}")
        if np.any(self.tables[slot] != -1):
            raise RuntimeError(f"slot {slot} already mapped")
        pages = [self._free.pop() for _ in range(need)]
        self.refcount[pages] += 1
        self.tables[slot, :need] = pages

    def release(self, slot: int) -> None:
        """Drop ``slot``'s references; pages free when nobody holds them."""
        for p in self.tables[slot]:
            if p < 0:
                continue
            self.refcount[p] -= 1
            if self.refcount[p] < 0:
                raise RuntimeError(f"page {int(p)} over-released")
            if self.refcount[p] == 0:
                self._free.append(int(p))
        self.tables[slot] = -1

    def check_invariants(self) -> None:
        """Raise if refcounts, free list and tables disagree: every page's
        refcount equals its holder count, free and held pages are disjoint,
        and no page is lost or duplicated (free + held = n_pages - 1)."""
        held = self.tables[self.tables >= 0].astype(np.int64)
        counts = np.bincount(held, minlength=self.spec.n_pages)
        problems = []
        if not np.array_equal(self.refcount, counts):
            problems.append("refcounts out of sync with holders")
        free = set(self._free)
        if len(free) != len(self._free):
            problems.append("duplicate free-list entries")
        referenced = {int(p) for p in np.nonzero(counts)[0]}
        if free & referenced:
            problems.append("page both free and referenced")
        if SCRATCH_PAGE in free or SCRATCH_PAGE in referenced:
            problems.append("scratch page allocated")
        if len(free) + len(referenced) != self.spec.n_pages - 1:
            problems.append("pages lost or duplicated")
        if problems:
            raise AssertionError("; ".join(problems))


def prefill_page_index(bt_rows: torch.Tensor, positions: torch.Tensor,
                       page_size: int):
    """Map a prefill batch's prompt positions to (page, offset) indices.

    bt_rows: (B, maxp) the admitted slots' block tables; positions: (B, L)
    absolute positions, -1 for left padding, which routes to the scratch
    page. Returns (B, L) int64 pages and offsets."""
    valid = positions >= 0
    idx = (torch.where(valid, positions, 0) // page_size).clamp(
        0, bt_rows.shape[1] - 1).to(torch.int64)
    pages = torch.where(
        valid, torch.gather(bt_rows.to(torch.int64), 1, idx).clamp_min(0),
        SCRATCH_PAGE)
    offs = torch.where(valid, positions % page_size, 0).to(torch.int64)
    return pages, offs
