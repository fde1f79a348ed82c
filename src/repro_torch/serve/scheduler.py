"""Continuous-batching scheduler: admission queues + slot/page bookkeeping
(port of ``repro.serve.scheduler``).

Admission is priority-ordered FIFO over SLO classes (0 interactive, 1
batch): within a class requests admit in arrival order, the interactive
queue head is considered before the batch head, and *aging* promotes a
batch request to interactive standing once it has waited ``age_promote``
time units, so interactive pressure can delay batch work but never starve
it. A request is admitted only when a slot is free AND the page pool
covers its whole budget (prompt + max_new tokens), so a running request
never hits pool exhaustion mid-decode. A request whose budget exceeds the
block-table width can never be admitted; it is retired as ``rejected``.

With a ``preempt_hook`` (the engine's KV spill), a true interactive head
that cannot be admitted may evict a running batch request: the victim's
pages spill (owned live pages to host RAM, shared prefix pages kept by
reference, see kvcache.SpillSnapshot), its slot frees, and it re-queues at
the front of its class with its progress, to be restored when capacity
returns. Aged batch requests gain admission standing but never the right
to preempt. Queued requests past their ``deadline`` are shed; the engine
cancels running ones and quarantines faulted ones through ``cancel`` and
``quarantine``, and every decision lands in the ``events`` log.

With ``prefix_share=True`` admission consults the pool's prefix index:
the pages of the prompt's cached full-page prefix are stitched into the
slot's block table (referenced, not copied), only the rest of the budget
takes fresh pages, and ``req.n_shared`` tells the engine how many prompt
tokens it need not prefill.

Model-free: the execution core (and the spill's data movement) lives in
serve/engine.py.

Admission is tensor-parallel-invariant: pages and budgets are counted in
tokens, and under TP serving the KV pools split along the kv-head dim
only, so every rank holds its head slice of every page and runs this
scheduler to the same decisions with no exchange. ``tp`` is taken only
to pin that contract.
"""
from __future__ import annotations

import bisect
import dataclasses
from collections import deque
from typing import Callable, Optional

import numpy as np

from repro_torch.serve.kvcache import PagePool, SpillSnapshot

INTERACTIVE, BATCH = 0, 1
N_CLASSES = 2


@dataclasses.dataclass
class Request:
    """One generation request and its lifecycle state."""

    rid: int
    prompt: np.ndarray              # (L,) int32
    max_new: int
    arrival: float = 0.0
    priority: int = INTERACTIVE     # SLO class: 0 interactive, 1 batch
    deadline: Optional[float] = None   # absolute; past it the request is
    #                                    shed from the queue or cancelled
    tokens: list = dataclasses.field(default_factory=list)
    slot: int = -1
    done: bool = False
    rejected: bool = False          # structurally un-admittable (too wide)
    shed: bool = False              # dropped from the queue past deadline
    cancelled: bool = False         # stopped mid-run past deadline
    error: Optional[str] = None     # quarantine reason (non-finite logits,
    #                                 a corrupted spill snapshot)
    n_shared: int = 0               # prompt tokens served from the prefix cache
    admitted_at: Optional[float] = None   # first admission (not re-admits)
    first_token_at: Optional[float] = None
    finished_at: Optional[float] = None
    # preemption lifecycle
    n_preempts: int = 0             # times evicted mid-run
    spill: Optional[SpillSnapshot] = None   # set while preempted
    prefill_done: bool = False      # had it reached decode when preempted?
    queue_wait: float = 0.0         # time waiting for a slot, summed over
    #                                 re-admissions
    _enqueued_at: float = 0.0       # start of the current wait

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


# a request by value for engine snapshots: every field but the prompt
# array and the spill snapshot, which are converted
_REQ_SCALARS = ("rid", "max_new", "arrival", "priority", "deadline", "slot",
                "done", "rejected", "shed", "cancelled", "error", "n_shared",
                "admitted_at", "first_token_at", "finished_at", "n_preempts",
                "prefill_done", "queue_wait", "_enqueued_at")


def _req_state(req: Request) -> dict:
    d = {f: getattr(req, f) for f in _REQ_SCALARS}
    d["prompt"] = np.asarray(req.prompt, np.int32)
    d["tokens"] = list(req.tokens)
    s = req.spill
    d["spill"] = None if s is None else {
        "n_pages": s.n_pages, "n_live": s.n_live,
        "kept": [(int(i), int(p)) for i, p in s.kept],
        "copied": [int(i) for i in s.copied],
        "host": s.host, "checksum": s.checksum,
    }
    return d


def _req_from_state(d: dict) -> Request:
    req = Request(rid=int(d["rid"]), prompt=np.asarray(d["prompt"], np.int32),
                  max_new=int(d["max_new"]))
    for f in _REQ_SCALARS:
        setattr(req, f, d[f])
    req.tokens = list(d["tokens"])
    s = d["spill"]
    if s is not None:
        req.spill = SpillSnapshot(
            n_pages=int(s["n_pages"]), n_live=int(s["n_live"]),
            kept=[(int(i), int(p)) for i, p in s["kept"]],
            copied=[int(i) for i in s["copied"]],
            host=s["host"], checksum=s["checksum"])
    return req


class Scheduler:
    """Priority admission over a fixed slot pool backed by a PagePool.

    ``age_promote``: waiting time (in the units of ``now``: steps under the
    virtual clock, seconds under a wall clock) after which a batch request
    competes at interactive standing; None disables aging.
    ``preempt_hook(slot, req, now)``: the engine's callback that spills the
    victim's KV and returns its SpillSnapshot; installing it enables
    preemption."""

    def __init__(self, n_slots: int, pool: PagePool,
                 prefix_share: bool = False, tp: int = 1,
                 age_promote: Optional[float] = None,
                 preempt_hook: Optional[
                     Callable[[int, Request, float], SpillSnapshot]] = None):
        # the page budget must not scale with tp: block tables stay host
        # arrays, the same on every rank
        if tp < 1:
            raise ValueError(f"tp must be >= 1, got {tp}")
        if type(pool.tables) is not np.ndarray:
            raise TypeError("block tables must stay host-side (the same on "
                            "every rank) under TP")
        self.n_slots = n_slots
        self.pool = pool
        self.tp = tp
        self.prefix_share = prefix_share
        self.age_promote = age_promote
        self.preempt_hook = preempt_hook
        self._pending: list[Request] = []     # submitted, sorted by arrival
        self.queues: list[deque[Request]] = [deque() for _ in range(N_CLASSES)]
        self.slots: list[Optional[Request]] = [None] * n_slots
        self._retired: list[Request] = []
        # (event, now, rid, slot) in decision order: "admit", "restore",
        # "preempt", "reject", "shed", "cancel", "quarantine"
        self.events: list[tuple] = []
        self.n_preemptions = 0
        self.n_restored = 0
        self.n_rejected = 0
        self.n_finished_ok = 0          # retired complete (not rejected)
        self.n_finished_preempted = 0   # ... of which were evicted >= once
        # a retiring request counts in exactly one of ok / rejected / shed
        # / cancelled / quarantined
        self.n_shed = 0
        self.n_cancelled = 0
        self.n_quarantined = 0
        # ((rid, pool generation), shared pages) of the blocked queue head,
        # so a head waiting for pages does not hash its prompt every tick
        self._hol_lookup: Optional[tuple[tuple[int, int], list[int]]] = None

    # ------------------------------------------------------------- intake
    @property
    def queue(self) -> list[Request]:
        """All waiting requests, class then arrival."""
        return [r for q in self.queues for r in q]

    def submit(self, req: Request) -> None:
        if not 0 <= req.priority < N_CLASSES:
            raise ValueError(f"priority must be 0 (interactive) .. "
                             f"{N_CLASSES - 1} (batch), got {req.priority}")
        req._enqueued_at = req.arrival
        # ties keep submission order
        bisect.insort(self._pending, req, key=lambda r: r.arrival)

    def _ingest(self, now: float) -> None:
        i = bisect.bisect_right(self._pending, now, key=lambda r: r.arrival)
        for req in self._pending[:i]:
            self.queues[req.priority].append(req)
        del self._pending[:i]

    # ---------------------------------------------------------- admission
    def _eff_priority(self, req: Request, now: float) -> int:
        """The class the request competes in now: its own, or interactive
        once it has waited past the promotion threshold."""
        if (self.age_promote is not None
                and now - req._enqueued_at >= self.age_promote):
            return INTERACTIVE
        return req.priority

    def _head(self, now: float, skipped=()) -> Optional[Request]:
        """The best waiting candidate: lowest (effective class, arrival,
        rid) among the queue heads (FIFO within a class; an aged batch head
        with an earlier arrival outranks a fresher interactive one).
        ``skipped`` classes are passed over (the idle deadlock valve)."""
        best, best_key = None, None
        for cls, q in enumerate(self.queues):
            if not q or cls in skipped:
                continue
            r = q[0]
            key = (self._eff_priority(r, now), r.arrival, r.rid)
            if best_key is None or key < best_key:
                best, best_key = r, key
        return best

    def _pick_victim(self, candidate: Request, need_pages: bool,
                     exclude=()) -> Optional[int]:
        """The latest-arriving running request of a strictly lower class
        (ties by rid, then slot). When pages (not slots) are short, a victim
        that owns no page is skipped: spilling it frees nothing. ``exclude``
        slots (filled in this admit call, not yet started by the engine) are
        never victims."""
        best, best_key = None, None
        for slot, req in enumerate(self.slots):
            if req is None or req.priority <= candidate.priority:
                continue
            if slot in exclude:
                continue
            if need_pages and self.pool.slot_owned_pages(slot) == 0:
                continue
            key = (req.arrival, req.rid, slot)
            if best_key is None or key > best_key:
                best, best_key = slot, key
        return best

    def _admit_one(self, req: Request, slot: int, now: float,
                   shared: list[int]) -> None:
        self.queues[req.priority].remove(req)
        req.queue_wait += now - req._enqueued_at
        if req.spill is not None:
            self.pool.restore(slot, req.spill)   # the engine scatters data
            self.n_restored += 1
            self.events.append(("restore", now, req.rid, slot))
        else:
            self.pool.alloc(slot, req.budget, shared_pages=shared)
            req.n_shared = len(shared) * self.pool.spec.page_size
            req.admitted_at = now
            self.events.append(("admit", now, req.rid, slot))
        self.slots[slot] = req
        req.slot = slot

    def _preempt(self, slot: int, now: float) -> None:
        """Evict the request in ``slot``: the hook spills its KV, then it
        re-queues at the front of its class with its original arrival."""
        req = self.slots[slot]
        req.spill = self.preempt_hook(slot, req, now)
        self.slots[slot] = None
        req.slot = -1
        req.n_preempts += 1
        req._enqueued_at = now
        self.queues[req.priority].appendleft(req)
        self.n_preemptions += 1
        self.events.append(("preempt", now, req.rid, slot))

    def admit(self, now: float = 0.0) -> list[tuple[int, Request]]:
        """Admit waiting requests into free slots while pages last, shedding
        expired ones first. Never raises for a submitted request (a budget
        wider than a block-table row is retired as ``rejected``). Returns
        (slot, request) pairs in admission order; a request with ``spill``
        set is a *restore*: the engine scatters its KV back before stepping
        it."""
        self._ingest(now)
        self._shed_expired(now)
        out = []
        skipped: set[int] = set()
        while True:
            req = self._head(now, skipped)
            if req is None:
                break
            if self.pool.spec.pages_for(req.budget) > self.pool.spec.max_pages:
                self.queues[req.priority].remove(req)
                req.rejected = True
                req.done = True
                req.finished_at = now
                self.n_rejected += 1
                self.events.append(("reject", now, req.rid, -1))
                self._retired.append(req)
                continue
            shared: list[int] = []
            if self.prefix_share and req.spill is None:
                state = (req.rid, self.pool.generation)
                if self._hol_lookup and self._hol_lookup[0] == state:
                    shared = self._hol_lookup[1]
                else:
                    # safe across blocked ticks: eviction runs only inside
                    # alloc, and every index change bumps the generation
                    shared = self.pool.lookup_prefix(req.prompt)
                    self._hol_lookup = (state, shared)
            free = [s for s, r in enumerate(self.slots) if r is None]
            fits = (self.pool.can_restore(req.spill) if req.spill is not None
                    else self.pool.can_alloc(req.budget, shared_pages=shared))
            if free and fits:
                slot = free[0]
                self._admit_one(req, slot, now, shared)
                out.append((slot, req))
                continue
            # blocked: a true interactive head may evict a batch victim
            # (aged batch heads may not); each eviction either opens the
            # way or the victims run out
            if (self.preempt_hook is not None
                    and req.priority == INTERACTIVE):
                victim = self._pick_victim(req, need_pages=bool(free),
                                           exclude={s for s, _ in out})
                if victim is not None:
                    self._preempt(victim, now)
                    continue
            if not any(r is not None for r in self.slots) and not out:
                # deadlock valve: nothing runs, so no retire will ever free
                # the pages this head waits for (spill snapshots can pin
                # pages with nothing running): let another class through
                skipped.add(req.priority)
                continue
            break                     # head-of-line blocks on slots/pages
        return out

    # -------------------------------------------------- deadlines / faults
    def _shed_expired(self, now: float) -> int:
        """Drop queued requests past their deadline. A shed preempted
        request discards its spill snapshot (releasing its kept pages)."""
        n = 0
        for q in self.queues:
            expired = [r for r in q
                       if r.deadline is not None and now > r.deadline]
            for req in expired:
                q.remove(req)
                if req.spill is not None:
                    self.pool.discard_spill(req.spill)
                    req.spill = None
                req.queue_wait += now - req._enqueued_at
                req.shed = True
                req.done = True
                req.finished_at = now
                self.n_shed += 1
                self.events.append(("shed", now, req.rid, -1))
                self._retired.append(req)
                n += 1
        return n

    def _retire_as(self, slot: int, now: float) -> Request:
        """Free ``slot``'s pages and retire its request (done at ``now``)."""
        req = self.slots[slot]
        if req is None:
            raise RuntimeError(f"slot {slot} holds no request")
        self.pool.release(slot)
        self.slots[slot] = None
        req.slot = -1
        req.done = True
        req.finished_at = now
        self._retired.append(req)
        return req

    def cancel(self, slot: int, now: float) -> None:
        """Cancel the running request in ``slot`` (past its deadline). The
        engine clears its own slot mirrors around this call."""
        req = self._retire_as(slot, now)
        req.cancelled = True
        self.n_cancelled += 1
        self.events.append(("cancel", now, req.rid, slot))

    def quarantine(self, slot: int, now: float, reason: str) -> None:
        """Retire the request in ``slot`` with an error status (non-finite
        logits, a corrupted spill snapshot): its pages free, never counted
        as ok."""
        req = self._retire_as(slot, now)
        req.error = reason
        self.n_quarantined += 1
        self.events.append(("quarantine", now, req.rid, slot))

    def retire(self, slot: int, now: float = 0.0) -> None:
        req = self._retire_as(slot, now)
        self.n_finished_ok += 1
        if req.n_preempts:
            self.n_finished_preempted += 1

    # ------------------------------------------------------------- status
    def active_slots(self) -> list[int]:
        return [s for s, r in enumerate(self.slots) if r is not None]

    def all_done(self) -> bool:
        return (not self._pending and not any(self.queues)
                and all(r is None for r in self.slots))

    @property
    def finished(self) -> list[Request]:
        return list(self._retired)

    def drain_finished(self) -> list[Request]:
        """Pop everything retired since the last drain."""
        out, self._retired = self._retired, []
        return out

    def stats(self) -> dict:
        """Accounting, cumulative across drains: ``n_rejected`` requests
        never ran, ``n_finished_preempted`` finished despite an eviction."""
        return {k: getattr(self, k) for k in self._COUNTERS}

    # ------------------------------------------------- snapshot / restore
    _COUNTERS = ("n_preemptions", "n_restored", "n_rejected",
                 "n_finished_ok", "n_finished_preempted", "n_shed",
                 "n_cancelled", "n_quarantined")

    def state_dict(self) -> dict:
        """The whole scheduler state, by value, for engine snapshots: each
        request once (keyed by rid), every membership list by rid. The
        head-of-line lookup cache is dropped: it is rebuilt lazily and
        re-validated against the pool generation."""
        reqs = {}
        for req in self._pending:
            reqs[req.rid] = _req_state(req)
        for q in self.queues:
            for req in q:
                reqs[req.rid] = _req_state(req)
        for req in self.slots:
            if req is not None:
                reqs[req.rid] = _req_state(req)
        for req in self._retired:
            reqs[req.rid] = _req_state(req)
        return {
            "requests": reqs,
            "pending": [r.rid for r in self._pending],
            "queues": [[r.rid for r in q] for q in self.queues],
            "slots": [None if r is None else r.rid for r in self.slots],
            "retired": [r.rid for r in self._retired],
            "events": [tuple(e) for e in self.events],
            "counters": {k: getattr(self, k) for k in self._COUNTERS},
        }

    def load_state_dict(self, state: dict) -> dict:
        """Rebuild the state from ``state_dict``; returns the rid -> Request
        map, so the engine re-links its own views to the same objects."""
        by_rid = {int(rid): _req_from_state(s)
                  for rid, s in state["requests"].items()}
        self._pending = [by_rid[r] for r in state["pending"]]
        self.queues = [deque(by_rid[r] for r in q) for q in state["queues"]]
        self.slots = [None if r is None else by_rid[r]
                      for r in state["slots"]]
        self._retired = [by_rid[r] for r in state["retired"]]
        self.events = [tuple(e) for e in state["events"]]
        for k in self._COUNTERS:
            setattr(self, k, int(state["counters"][k]))
        self._hol_lookup = None
        return by_rid
