"""Paged KV cache: fixed page pool + per-slot block tables + the prefix
index, and the page bookkeeping of preemption (port of
``repro.serve.kvcache``).

A pool of fixed-size pages is shared by all serving slots; each slot owns a
block table, a row of page ids. A slot's cache always holds the contiguous
positions 0..len-1, so the read mask is a function of the per-slot fill
count alone and recycled pages need no invalidation.

Page 0 is a reserved scratch page: idle slots and left-padded prompt
positions write there, and nothing ever reads it. The allocator
(``PagePool``) is host-side numpy; ``prefill_page_index`` runs on the
device of its tensors. The prefix index's page keys are the JAX package's
byte for byte (blake2b chained over each page's int32 tokens).

Preemption: ``spill(slot)`` checkpoints a victim slot's mapping so the
slot and its exclusively owned pages can go to a higher-class request,
and ``restore(slot, snap)`` re-stitches an equivalent block table later.
Pages the slot shares (prefix-index entries, other slots' stitches) are
*kept by reference*: the snapshot holds one reference on each, so they
stay on the device untouched and a spill never copies a prefix page. Only
exclusively owned live pages go to the caller's ``copy_out`` for host
storage. Spill and ``hold`` references are counted apart, so
``check_invariants`` proves conservation across the whole preempt ->
spill -> restore lifecycle and across fault-injected holds.

Tensor parallelism: each rank's pools hold its kv-head slice of every
page (``pool_head_dim`` names that dim; the engine builds a rank's pools
from its head-local config). The page axes are never split, so the
allocator, the block tables and the fill counts here are the same on
every rank and need no exchange.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Any, Callable, Optional

import numpy as np
import torch

SCRATCH_PAGE = 0

# the paged pool leaves of a cache tree; each is (L, P, page, KVH[, hd]),
# its page axis 1
POOL_KEYS = ("k_pool", "v_pool", "k_scale_pool", "v_scale_pool")


def pool_head_dim(key: str, ndim: int) -> int:
    """Index of the kv-head dim of a paged pool leaf: value pools are
    (..., P, page, KVH, hd), scale pools (..., P, page, KVH)."""
    return ndim - 2 if key in ("k_pool", "v_pool") else ndim - 1


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


@dataclasses.dataclass
class SpillSnapshot:
    """Checkpoint of one slot's page mapping taken by ``PagePool.spill``.

    ``kept`` pages stay resident on the device: the snapshot holds one
    reference on each, so neither the free list nor prefix eviction can
    reclaim them while the request sits preempted. ``copied`` pages were
    exclusively owned; their contents went to the spill caller's
    ``copy_out`` and the pages back to the free list, so the positions
    recorded here only say where in the rebuilt table the host data goes.
    ``host`` is what ``copy_out`` returned (the engine's gathered pool
    pages as numpy, in host RAM)."""

    n_pages: int                     # pages the slot had mapped (its budget)
    n_live: int                      # tokens whose KV was resident at spill
    kept: list                       # (table position, page id) by reference
    copied: list                     # table positions whose data spilled
    host: Any = None                 # copy_out's payload
    restored: Optional[list] = None  # the fresh page ids restore picked for
    #                                  the copied positions, in their order:
    #                                  where the engine scatters ``host``
    checksum: Optional[int] = None   # crc32 of ``host`` taken at spill time,
    #                                  verified before the scatter


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
        # references held by live SpillSnapshots and by hold() (fault
        # injection): counted into refcount so neither eviction nor free can
        # take such a page, and kept apart so check_invariants can account
        # for them
        self._spill_refs = np.zeros(spec.n_pages, np.int32)
        self._hold_refs = np.zeros(spec.n_pages, np.int32)

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

    # ---------------------------------------------------- preemption spill
    def slot_owned_pages(self, slot: int) -> int:
        """Mapped pages only this slot holds (refcount 1): what a preemption
        would give back. The scheduler skips a victim that owns none."""
        row = self.tables[slot]
        return int(sum(1 for p in row if p >= 0 and self.refcount[p] == 1))

    def spill(self, slot: int, n_live_tokens: int,
              copy_out: Callable[[list], Any]) -> SpillSnapshot:
        """Checkpoint and unmap ``slot``; returns the snapshot ``restore``
        takes. Pages of refcount > 1 are kept by reference (the snapshot
        takes one reference each; their contents never move). Exclusively
        owned pages holding live tokens (positions 0..n_live_tokens - 1)
        go to ``copy_out`` before any page is released, so the caller can
        read them off the device; they and the dead tail pages (budget for
        decode, never written) then return to the free list."""
        row = self.tables[slot]
        n_mapped = int(np.sum(row >= 0))
        if n_mapped == 0:
            raise RuntimeError(f"slot {slot} has nothing to spill")
        live = self.spec.pages_for(n_live_tokens)
        if live > n_mapped:
            raise RuntimeError(f"slot {slot}: {n_live_tokens} live tokens "
                               f"exceed its {n_mapped}-page mapping")
        kept, copied = [], []
        for i in range(n_mapped):
            page = int(row[i])
            if self.refcount[page] > 1:
                kept.append((i, page))
            elif i < live:
                # owned and written: its contents exist nowhere else (an
                # index page has the index's reference, so refcount >= 2)
                copied.append(i)
        host = copy_out([int(row[i]) for i in copied]) if copied else None
        snap = SpillSnapshot(n_pages=n_mapped, n_live=n_live_tokens,
                             kept=kept, copied=copied, host=host)
        for _, page in kept:
            self.refcount[page] += 1
            self._spill_refs[page] += 1
        self.release(slot)
        return snap

    def can_restore(self, snap: SpillSnapshot) -> bool:
        """True when the fresh pages a restore needs are available now."""
        fresh = snap.n_pages - len(snap.kept)
        return fresh <= len(self._free) + self._n_evictable()

    def restore(self, slot: int, snap: SpillSnapshot) -> list[int]:
        """Re-stitch ``slot``'s block table from a spill snapshot: kept
        pages at their old positions (the snapshot's reference becomes the
        slot's), a fresh page at every other position. Returns the fresh
        ids at the ``copied`` positions, in order (also ``snap.restored``):
        where the caller scatters the host data back. Dead-tail positions
        get fresh unwritten pages, masked by the fill count as in any
        allocation."""
        if np.any(self.tables[slot] != -1):
            raise RuntimeError(f"slot {slot} already mapped")
        fresh_n = snap.n_pages - len(snap.kept)
        if fresh_n > len(self._free) + self._n_evictable():
            raise RuntimeError(f"page pool exhausted on restore: need "
                               f"{fresh_n} fresh, free {len(self._free)}")
        kept_pos = {i for i, _ in snap.kept}
        copied_pos = set(snap.copied)
        for i, page in snap.kept:
            self.tables[slot, i] = page
            self._spill_refs[page] -= 1
            if self._spill_refs[page] < 0:
                raise RuntimeError("spill reference over-released")
        out = []
        for i in range(snap.n_pages):
            if i in kept_pos:
                continue
            if not self._free:
                self._evict_one()
            page = self._free.pop()
            self.refcount[page] += 1
            self.tables[slot, i] = page
            if i in copied_pos:
                out.append(page)
        snap.restored = out
        return out

    def discard_spill(self, snap: SpillSnapshot) -> None:
        """Drop a snapshot without restoring it (its request was shed or
        cancelled): release its kept-page references."""
        for _, page in snap.kept:
            self._spill_refs[page] -= 1
            self.refcount[page] -= 1
            if self._spill_refs[page] < 0 or self.refcount[page] < 0:
                raise RuntimeError(f"page {page} over-released")
            if self.refcount[page] == 0:
                self._free.append(int(page))
        snap.kept = []

    # --------------------------------------------------- fault injection
    def hold(self, n: int) -> list[int]:
        """Pin up to ``n`` free pages (simulated exhaustion): they leave the
        free list and take a reference, so admission sees a smaller pool.
        Holding never evicts; returns the pages held."""
        pages = [self._free.pop() for _ in range(min(n, len(self._free)))]
        for p in pages:
            self.refcount[p] += 1
            self._hold_refs[p] += 1
        return pages

    def release_hold(self, pages: list[int]) -> None:
        """Return pages pinned by ``hold`` to the free list."""
        for p in pages:
            self._hold_refs[p] -= 1
            self.refcount[p] -= 1
            if self._hold_refs[p] < 0 or self.refcount[p] < 0:
                raise RuntimeError(f"page {p} over-released")
            if self.refcount[p] == 0:
                self._free.append(int(p))

    # ------------------------------------------------- snapshot / restore
    def state_dict(self) -> dict:
        """The allocator's whole state, by value, for engine snapshots. The
        free list keeps its order and the index its insertion order: the
        pages a restored engine hands out next are the uninterrupted
        engine's."""
        return {
            "free": list(self._free),
            "tables": self.tables.copy(),
            "refcount": self.refcount.copy(),
            "spill_refs": self._spill_refs.copy(),
            "hold_refs": self._hold_refs.copy(),
            "generation": self.generation,
            "prefix_index": [(k.hex(), int(p))
                             for k, p in self._prefix_index.items()],
            "parent": [(k.hex(), None if p is None else p.hex())
                       for k, p in self._parent.items()],
            "children": [(k.hex(), int(n))
                         for k, n in self._children.items()],
        }

    def load_state_dict(self, state: dict) -> None:
        self._free = [int(p) for p in state["free"]]
        self.tables = np.asarray(state["tables"], np.int32).copy()
        self.refcount = np.asarray(state["refcount"], np.int32).copy()
        self._spill_refs = np.asarray(state["spill_refs"], np.int32).copy()
        self._hold_refs = np.asarray(state["hold_refs"], np.int32).copy()
        self.generation = int(state["generation"])
        self._prefix_index = OrderedDict(
            (bytes.fromhex(k), int(p)) for k, p in state["prefix_index"])
        self._parent = {bytes.fromhex(k):
                        (None if p is None else bytes.fromhex(p))
                        for k, p in state["parent"]}
        self._children = {bytes.fromhex(k): int(n)
                          for k, n in state["children"]}

    def check_invariants(self) -> None:
        """Raise if refcounts, free list, tables and index disagree: every
        page's refcount equals its holders (slots, the index, spill
        snapshots and holds), free and held pages are disjoint, no page is
        lost or duplicated (free + held = n_pages - 1), and parent links
        and child counts match the index."""
        held = self.tables[self.tables >= 0].astype(np.int64)
        counts = np.bincount(held, minlength=self.spec.n_pages)
        for page in self._prefix_index.values():
            counts[page] += 1
        problems = []
        if np.any(self._spill_refs < 0) or np.any(self._hold_refs < 0):
            problems.append("negative spill or hold refcount")
        counts = counts + self._spill_refs + self._hold_refs
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
