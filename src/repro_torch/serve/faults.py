"""Deterministic fault injection for the continuous-batching engine (port of
``repro.serve.faults``).

Every fault is pinned to an engine *step index* (the ``step()`` call
count, under the virtual clock a pure function of the trace), so a
``FaultPlan`` is a seeded schedule that replays exactly. The engine
consumes the plan in ``step()`` (``ContinuousEngine._apply_faults``); each
kind exercises one path:

  nan_logits      poison one slot's decode logits with NaN; the isfinite
                  sentinel in the decode block quarantines that slot
                  (retired with ``error``, pages freed) without touching
                  the co-batched slots' tokens.
  pool_exhaust    pin free pages for a few steps so admission sees a full
                  pool; scheduling waits or preempts, and the pages come
                  back on schedule.
  step_exception  raise ``FaultInjected`` out of ``step()``: a simulated
                  process crash. ``run_resilient`` rebuilds the engine and
                  resumes from the last snapshot.
  spill_corrupt   flip a byte of the next spill snapshot's host payload;
                  the checksum taken at spill time catches it on restore
                  and the request is quarantined.
  latency_spike   jump the virtual clock, aging every queued request at
                  once (deadline shedding and aging both fire).
  kernel_fault    fail the next decode dispatch: it raises
                  ``FaultInjected`` instead of launching. The port has no
                  second read to fall back to (the JAX package retries on
                  its gather read), so this is a crash like step_exception:
                  ``run_resilient`` recovers it from the last snapshot, and
                  a plain ``run()`` raises.

``run_resilient`` owns the plan across crashes: the fault that crashed is
dropped from the plan handed to the rebuilt engine (a real crash does not
repeat because the process restarted), while every other fault stays and
re-fires when the restored engine replays its steps.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np

FAULT_KINDS = ("nan_logits", "pool_exhaust", "step_exception",
               "spill_corrupt", "latency_spike", "kernel_fault")


class FaultInjected(RuntimeError):
    """An injected crash (a step_exception or a failed decode dispatch)."""

    def __init__(self, fault: "Fault"):
        super().__init__(f"injected fault: {fault}")
        self.fault = fault


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled failure at engine step ``step`` (``n_steps_total``).
    ``slot`` targets nan_logits (-1: slot 0); ``pages`` and ``duration``
    give pool_exhaust's pinned pages and steps, and latency_spike's jump
    of the virtual clock."""

    step: int
    kind: str
    slot: int = -1
    pages: int = 0
    duration: int = 0

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"one of {FAULT_KINDS}")


class FaultPlan:
    """An immutable fault schedule in canonical order."""

    def __init__(self, faults: Sequence[Fault] = (),
                 seed: Optional[int] = None):
        self.faults = tuple(sorted(
            faults, key=lambda f: (f.step, FAULT_KINDS.index(f.kind),
                                   f.slot, f.pages, f.duration)))
        self.seed = seed

    def __len__(self) -> int:
        return len(self.faults)

    def __iter__(self):
        return iter(self.faults)

    def __repr__(self) -> str:
        return f"FaultPlan(seed={self.seed}, n={len(self.faults)})"

    def at(self, step: int) -> list[Fault]:
        """Faults scheduled for engine step ``step``, in canonical order."""
        return [f for f in self.faults if f.step == step]

    def drop(self, fault: Fault) -> "FaultPlan":
        """A new plan without one occurrence of ``fault``."""
        rest = list(self.faults)
        rest.remove(fault)
        return FaultPlan(rest, seed=self.seed)

    @classmethod
    def seeded(cls, seed: int, *, n_steps: int = 64, n_slots: int = 8,
               n_faults: int = 6,
               kinds: Sequence[str] = ("nan_logits", "pool_exhaust",
                                       "latency_spike", "kernel_fault",
                                       "spill_corrupt"),
               crashes: int = 0) -> "FaultPlan":
        """A reproducible schedule, draw for draw the JAX package's (numpy's
        ``default_rng``): ``n_faults`` failures of ``kinds`` over the first
        ``n_steps`` steps, plus ``crashes`` step_exceptions."""
        rng = np.random.default_rng(seed)
        faults = []
        for _ in range(n_faults):
            kind = str(rng.choice(list(kinds)))
            faults.append(Fault(
                step=int(rng.integers(1, max(2, n_steps))), kind=kind,
                slot=int(rng.integers(0, n_slots)),
                pages=int(rng.integers(1, 9)),
                duration=int(rng.integers(1, 5))))
        for _ in range(crashes):
            faults.append(Fault(step=int(rng.integers(1, max(2, n_steps))),
                                kind="step_exception"))
        return cls(faults, seed=seed)


def run_resilient(build_engine: Callable[[], object], trace, *,
                  faults: Optional[FaultPlan] = None,
                  snapshot_every: int = 8, store_dir: Optional[str] = None,
                  max_steps: int = 200_000) -> dict:
    """Crash-tolerant trace replay: snapshot every ``snapshot_every``
    steps, and when a step raises ``FaultInjected``, build a fresh engine
    and restore the last snapshot; in-flight work replays from there with
    the same greedy tokens.

    ``build_engine`` constructs an engine identical to the one that crashed;
    with ``store_dir`` every snapshot goes through
    ``checkpoint.store.save_snapshot`` / ``load_snapshot``. Returns the
    engine, the traffic report, the drained requests, ``n_crashes``,
    ``crashes`` (the faults that crashed, in order) and ``n_snapshots``."""
    from repro_torch.checkpoint.store import load_snapshot, save_snapshot
    from repro_torch.serve.traffic import summarize

    plan = faults if faults is not None else FaultPlan()
    eng = build_engine()
    eng.faults = plan
    for it in trace:
        eng.submit(it.prompt, max_new=it.max_new, arrival=it.arrival,
                   priority=it.priority,
                   deadline=getattr(it, "deadline", None))
    snap = eng.snapshot()      # a crash before the first periodic snapshot
    #                            is still recoverable
    crashes = []
    n_snapshots = steps = 0
    while not eng.sched.all_done():
        if steps >= max_steps:
            raise RuntimeError(f"resilient loop exceeded {max_steps} steps")
        steps += 1
        try:
            eng.step(float(eng.t))
            eng.t += 1
        except FaultInjected as e:
            plan = plan.drop(e.fault)
            crashes.append(e.fault)
            eng = build_engine()
            eng.faults = plan
            eng.restore(snap)
            continue
        if snapshot_every and steps % snapshot_every == 0:
            snap = eng.snapshot()
            if store_dir is not None:
                save_snapshot(store_dir, snap)
                snap = load_snapshot(store_dir)
            n_snapshots += 1
    done = sorted(eng.sched.drain_finished(), key=lambda r: r.rid)
    report = summarize(done)
    report["scheduler"] = eng.sched.stats()
    report["spill"] = {"spilled_pages": eng.n_spilled_pages,
                       "restored_pages": eng.n_restored_pages}
    report["faults"] = eng.fault_stats()
    # the drained requests, not submit's handles: a restored engine rebuilt
    # its Request objects from the snapshot
    report["requests"] = done
    return {"engine": eng, "report": report, "requests": done,
            "n_crashes": len(crashes), "crashes": crashes,
            "n_snapshots": n_snapshots}
