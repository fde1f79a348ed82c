"""Continuous-batching scheduler: FIFO admission queue + slot/page
bookkeeping (port of ``repro.serve.scheduler`` without priorities,
preemption or deadlines, which come in a later slice).

A request is admitted only when a slot is free AND the page pool can cover
its whole budget (prompt + max_new tokens), so a running request never
hits pool exhaustion mid-decode. A request whose budget exceeds the
block-table width can never be admitted; it is retired as ``rejected``
instead of blocking the queue.

With ``prefix_share=True`` admission consults the pool's prefix index:
the pages of the prompt's cached full-page prefix are stitched into the
slot's block table (referenced, not copied), only the rest of the budget
takes fresh pages, and ``req.n_shared`` tells the engine how many prompt
tokens it need not prefill.

Model-free: the execution core lives in serve/engine.py.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.serve.kvcache import PagePool


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle state."""

    rid: int
    prompt: np.ndarray              # (L,) int32
    max_new: int
    arrival: float = 0.0
    priority: int = 0               # SLO class label: 0 interactive, 1 batch
    #                                 (admission is FIFO in this slice)
    tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    rejected: bool = False          # structurally un-admittable (too wide)
    n_shared: int = 0               # prompt tokens served from the prefix cache
    admitted_at: Optional[float] = None
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None

    @property
    def n_prompt(self) -> int:
        return int(self.prompt.shape[0])

    @property
    def budget(self) -> int:
        """Worst-case tokens this request may occupy in the cache."""
        return self.n_prompt + self.max_new

    @property
    def ttft(self) -> Optional[float]:
        """Time to first token, from arrival (None until one is emitted)."""
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token after the first."""
        if (self.first_token_at is None or self.finished_at is None
                or len(self.tokens) < 2):
            return None
        return ((self.finished_at - self.first_token_at)
                / (len(self.tokens) - 1))


class Scheduler:
    """FIFO admission over a fixed slot pool backed by a PagePool."""

    def __init__(self, n_slots: int, pool: PagePool,
                 prefix_share: bool = False):
        self.n_slots = n_slots
        self.pool = pool
        self.prefix_share = prefix_share
        self._pending: list[Request] = []     # submitted, sorted by arrival
        self.queue: deque[Request] = deque()  # arrived, waiting for a slot
        self.slots: list[Optional[Request]] = [None] * n_slots
        self._retired: list[Request] = []
        # ((rid, pool generation), shared pages) of the blocked queue head,
        # so a head waiting for pages does not hash its prompt every tick
        self._hol_lookup: Optional[tuple[tuple[int, int], list[int]]] = None

    def submit(self, req: Request) -> None:
        # ties keep submission order
        bisect.insort(self._pending, req, key=lambda r: r.arrival)

    def _ingest(self, now: float) -> None:
        i = bisect.bisect_right(self._pending, now, key=lambda r: r.arrival)
        self.queue.extend(self._pending[:i])
        del self._pending[:i]

    def admit(self, now: float = 0.0) -> list[tuple[int, Request]]:
        """Admit arrived requests in FIFO order into free slots while pages
        last; the queue head blocks everything behind it. Returns (slot,
        request) pairs in admission order."""
        self._ingest(now)
        out = []
        while self.queue:
            req = self.queue[0]
            if self.pool.spec.pages_for(req.budget) > self.pool.spec.max_pages:
                self.queue.popleft()
                req.rejected = True
                req.done = True
                req.finished_at = now
                self._retired.append(req)
                continue
            shared: list[int] = []
            if self.prefix_share:
                state = (req.rid, self.pool.generation)
                if self._hol_lookup and self._hol_lookup[0] == state:
                    shared = self._hol_lookup[1]
                else:
                    # safe across blocked ticks: eviction runs only inside
                    # alloc, and every index change bumps the generation
                    shared = self.pool.lookup_prefix(req.prompt)
                    self._hol_lookup = (state, shared)
            free = [s for s, r in enumerate(self.slots) if r is None]
            if not free or not self.pool.can_alloc(req.budget,
                                                   shared_pages=shared):
                break
            self.queue.popleft()
            slot = free[0]
            self.pool.alloc(slot, req.budget, shared_pages=shared)
            req.n_shared = len(shared) * self.pool.spec.page_size
            req.admitted_at = now
            req.slot = slot
            self.slots[slot] = req
            out.append((slot, req))
        return out

    def retire(self, slot: int, now: float = 0.0) -> None:
        req = self.slots[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} holds no request")
        self.pool.release(slot)
        self.slots[slot] = None
        req.done = True
        req.finished_at = now
        req.slot = -1
        self._retired.append(req)

    def active_slots(self) -> list[int]:
        return [s for s, r in enumerate(self.slots) if r is not None]

    def all_done(self) -> bool:
        return (not self._pending and not self.queue
                and all(r is None for r in self.slots))

    @property
    def finished(self) -> list[Request]:
        return list(self._retired)

    def drain_finished(self) -> list[Request]:
        """Pop everything retired since the last drain."""
        out, self._retired = self._retired, []
        return out
