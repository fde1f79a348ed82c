"""Paged KV cache: fixed page pool + per-slot block tables + the prefix
index (port of ``repro.serve.kvcache``, without the spill and hold of the
overload slice).

A pool of fixed-size pages is shared by all serving slots; each slot owns a
block table, a row of page ids. A slot's cache always holds the contiguous
positions 0..len-1, so the read mask is a function of the per-slot fill
count alone and recycled pages need no invalidation.

Page 0 is a reserved scratch page: idle slots and left-padded prompt
positions write there, and nothing ever reads it. The allocator
(``PagePool``) is host-side numpy; ``prefill_page_index`` runs on the
device of its tensors. The prefix index's page keys are the JAX package's
byte for byte (blake2b chained over each page's int32 tokens).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Optional

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
    """Host-side refcounted page allocator, per-slot block tables and the
    prefix index.

    Decode only ever writes to a slot's own tail pages (idle slots all
    target the scratch page), so a page's writers never collide. With
    ``prefix_cache`` the pool keeps an index over *full* prompt pages: a
    request whose prompt starts with an indexed run of pages is stitched
    onto them (referenced, not copied). Only whole pages of prompt tokens
    are shared, so a shared page holds frozen positions and needs no
    copy-on-write. The index holds one reference per cached page, so a
    cached page outlives its last slot; index-only pages (refcount 1) are
    evicted when fresh allocations outrun the free list."""

    def __init__(self, spec: PageSpec, n_slots: int,
                 prefix_cache: bool = False):
        self.spec = spec
        self.n_slots = n_slots
        self.prefix_cache = prefix_cache
        self._free = list(range(spec.n_pages - 1, SCRATCH_PAGE, -1))
        self.tables = np.full((n_slots, spec.max_pages), -1, np.int32)
        self.refcount = np.zeros(spec.n_pages, np.int32)
        # chained page key -> page id, in insertion order (eviction takes
        # the oldest; a hit moves its key to the end). key_k = blake2b(
        # key_{k-1} || page k's int32 token bytes) commits to the whole
        # prefix up to page k's end. Parent links and per-key counts of
        # cached children find chain leaves in O(1)
        self._prefix_index: OrderedDict[bytes, int] = OrderedDict()
        self._parent: dict[bytes, Optional[bytes]] = {}
        # key -> live entries whose parent link is key (the key itself
        # need not be live: a dropped head's children keep the link)
        self._children: dict[bytes, int] = {}
        # bumped on every index change; admission caches a blocked queue
        # head's lookup under it
        self.generation = 0

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_cached(self) -> int:
        """Pages held by the prefix index (some may also be held by
        slots)."""
        return len(self._prefix_index)

    def _n_evictable(self, exclude=()) -> int:
        ex = set(exclude)
        return sum(1 for p in self._prefix_index.values()
                   if self.refcount[p] == 1 and p not in ex)

    def can_alloc(self, n_tokens: int, shared_pages=()) -> bool:
        """True when a request of ``n_tokens`` could be admitted now (a
        request wider than one block-table row never can).
        ``shared_pages`` are prefix pages the request reuses: they cut the
        fresh pages it needs and do not count as evictable headroom."""
        need = self.spec.pages_for(n_tokens)
        if need > self.spec.max_pages:
            return False
        need -= len(shared_pages)
        return need <= len(self._free) + self._n_evictable(shared_pages)

    def _prefix_keys(self, tokens: np.ndarray, n_pages: int) -> list[bytes]:
        """Chained keys of the first ``n_pages`` full pages of tokens."""
        toks = np.ascontiguousarray(np.asarray(tokens, np.int32))
        ps = self.spec.page_size
        keys, prev = [], b""
        for k in range(n_pages):
            h = hashlib.blake2b(prev, digest_size=16)
            h.update(toks[k * ps:(k + 1) * ps].tobytes())
            prev = h.digest()
            keys.append(prev)
        return keys

    def lookup_prefix(self, tokens: np.ndarray) -> list[int]:
        """Pages of the longest indexed run of full pages covering a
        *strict* prefix of tokens (at most len - 1 tokens, so a suffix
        prefill always has a token left to give the last logits)."""
        if not self.prefix_cache:
            return []
        n_full = (len(tokens) - 1) // self.spec.page_size
        pages = []
        for key in self._prefix_keys(tokens, n_full):
            page = self._prefix_index.get(key)
            if page is None:
                break
            self._prefix_index.move_to_end(key)
            pages.append(page)
        return pages

    def register_prefix(self, tokens: np.ndarray, slot: int) -> int:
        """Publish ``slot``'s full prompt pages into the index once the
        prompt is prefilled (the page at len // page_size, partial or
        about to take decode tokens, never is). Keys already indexed are
        refreshed. Returns the number of pages added."""
        if not self.prefix_cache:
            return 0
        n_full = len(tokens) // self.spec.page_size
        added = 0
        parent = None
        for k, key in enumerate(self._prefix_keys(tokens, n_full)):
            if key in self._prefix_index:
                self._prefix_index.move_to_end(key)
                parent = key
                continue
            page = int(self.tables[slot, k])
            if page < 0:
                raise RuntimeError(f"slot {slot} prefix page {k} not mapped")
            self._prefix_index[key] = page
            self._parent[key] = parent
            if parent is not None:
                self._children[parent] = self._children.get(parent, 0) + 1
            self.refcount[page] += 1                # the index's reference
            self.generation += 1
            added += 1
            parent = key
        return added

    def _drop_entry(self, key: bytes) -> None:
        """Remove one index entry and its page reference. The count of
        ``key``'s own children stays: they remain cached, and it keeps leaf
        detection exact if the key is registered again."""
        page = self._prefix_index.pop(key)
        parent = self._parent.pop(key)
        if parent is not None:
            self._children[parent] -= 1
            if not self._children[parent]:
                del self._children[parent]
        self.generation += 1
        self.refcount[page] -= 1
        if self.refcount[page] == 0:
            self._free.append(int(page))

    def _evict_one(self) -> None:
        """Drop one index-only (refcount 1) page to the free list: the
        oldest with no cached child (a chain leaf; dropping a head would
        strand the entries below it), else the oldest evictable one."""
        fallback = None
        for key, page in self._prefix_index.items():
            if self.refcount[page] != 1:
                continue
            if fallback is None:
                fallback = key
            if not self._children.get(key):
                fallback = key
                break
        if fallback is None:
            raise RuntimeError("no evictable prefix-cache page")
        self._drop_entry(fallback)

    def clear_prefix_cache(self) -> int:
        """Drop every index entry (pages held by live slots keep those
        references). Returns the number of entries dropped."""
        n = len(self._prefix_index)
        while self._prefix_index:
            self._drop_entry(next(iter(self._prefix_index)))
        return n

    def alloc(self, slot: int, n_tokens: int, shared_pages=()) -> None:
        """Map ``slot`` to pages for n_tokens: ``shared_pages`` (prefix
        hits, referenced) in front of fresh tail pages, evicting index-only
        pages when the free list runs out."""
        need = self.spec.pages_for(n_tokens)
        if need > self.spec.max_pages:
            raise ValueError(f"request needs {need} pages > block-table "
                             f"width {self.spec.max_pages}")
        shared = [int(p) for p in shared_pages]
        fresh = need - len(shared)
        if fresh > len(self._free) + self._n_evictable(shared):
            raise RuntimeError(f"page pool exhausted: need {fresh} fresh, "
                               f"free {len(self._free)}")
        if np.any(self.tables[slot] != -1):
            raise RuntimeError(f"slot {slot} already mapped")
        # the shared references first, so eviction below cannot take them
        for p in shared:
            self.refcount[p] += 1
        pages = []
        for _ in range(fresh):
            if not self._free:
                self._evict_one()
            page = self._free.pop()
            self.refcount[page] += 1
            pages.append(page)
        self.tables[slot, :need] = shared + pages

    def release(self, slot: int) -> None:
        """Drop ``slot``'s references; pages free when nobody (no slot, not
        the index) holds them."""
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
        """Raise if refcounts, free list, tables and index disagree: every
        page's refcount equals its holders (slots and the index), free and
        held pages are disjoint, no page is lost or duplicated (free + held
        = n_pages - 1), and parent links and child counts match the
        index."""
        held = self.tables[self.tables >= 0].astype(np.int64)
        counts = np.bincount(held, minlength=self.spec.n_pages)
        for page in self._prefix_index.values():
            counts[page] += 1
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
        if set(self._parent) != set(self._prefix_index):
            problems.append("parent links out of sync with index entries")
        children: dict = {}
        for par in self._parent.values():
            if par is not None:
                children[par] = children.get(par, 0) + 1
        if children != self._children:
            problems.append("cached-child counts out of sync")
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
