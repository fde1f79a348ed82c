"""Deterministic traffic harness for the continuous-batching engine (port
of ``repro.serve.traffic``).

Builds *seeded* arrival traces (Poisson trickle, bursty on/off overload,
or uniform) and replays them through an engine. The trace builder is the
JAX package's, draw for draw: it uses numpy's ``default_rng`` there too,
so the same arguments give the same trace in both packages. Under the
engine's virtual clock (``run()`` with no wall clock ticks ``now`` once
per scheduler step) every admission and retirement lands at an integer
step that is a pure function of (trace seed, engine config).

Metrics are reported per SLO class (interactive/batch): TTFT and TPOT
percentiles, end-to-end latency, queue wait and goodput — completed
tokens per unit of virtual (or wall) time — with the preempted, shed,
cancelled and quarantined requests counted apart (a request retired
without a complete answer is not served).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

CLASS_NAMES = {0: "interactive", 1: "batch"}


@dataclasses.dataclass
class TraceItem:
    """One request of a traffic trace (engine-agnostic)."""

    arrival: float
    prompt: np.ndarray
    max_new: int
    priority: int = 0
    deadline: Optional[float] = None    # absolute, like `arrival`


def make_trace(*, kind: str = "poisson", n: int = 32, rate: float = 4.0,
               seed: int = 0, vocab_size: int = 256,
               prompt_len: tuple[int, int] = (8, 48),
               max_new: tuple[int, int] = (8, 32),
               batch_frac: float = 0.5,
               burst_len: float = 4.0, idle_len: float = 8.0,
               burst_rate_mult: float = 8.0,
               shared_prefix: int = 0,
               deadline: Optional[float] = None) -> list[TraceItem]:
    """Build a seeded arrival trace.

    kind="poisson": exponential inter-arrivals at `rate`.
    kind="bursty":  on/off overload — arrivals cluster in bursts of
        `burst_len` time units at `rate * burst_rate_mult`, separated by
        idle gaps of `idle_len`.
    kind="uniform": n arrivals evenly spaced over n/rate time units.

    Every `1/batch_frac`-th request (deterministically, not sampled) is
    batch-class; prompt and decode lengths come from the seeded rng.
    `shared_prefix` prepends a common system prompt to every request.
    `deadline` gives every request an SLO of that many time units after
    its arrival.
    """
    rng = np.random.default_rng(seed)
    if kind == "poisson":
        arrivals = np.cumsum(rng.exponential(1.0 / rate, n))
    elif kind == "uniform":
        arrivals = np.arange(n) / rate
    elif kind == "bursty":
        arrivals, t = [], 0.0
        while len(arrivals) < n:
            burst_end = t + burst_len
            while t < burst_end and len(arrivals) < n:
                t += float(rng.exponential(1.0 / (rate * burst_rate_mult)))
                arrivals.append(t)
            t = burst_end + idle_len
        arrivals = np.asarray(arrivals)
    else:
        raise ValueError(f"unknown trace kind {kind!r}")
    system = rng.integers(0, vocab_size, shared_prefix)
    stride = int(round(1.0 / batch_frac)) if batch_frac > 0 else 0
    items = []
    for i in range(n):
        plen = int(rng.integers(prompt_len[0], prompt_len[1] + 1))
        mnew = int(rng.integers(max_new[0], max_new[1] + 1))
        prompt = np.concatenate([system,
                                 rng.integers(0, vocab_size, plen)])
        prio = 1 if (stride and i % stride == stride - 1) else 0
        items.append(TraceItem(
            arrival=float(arrivals[i]), prompt=prompt, max_new=mnew,
            priority=prio,
            deadline=(None if deadline is None
                      else float(arrivals[i]) + deadline)))
    return items


def replay(engine, trace: Sequence[TraceItem], *, clock=None,
           max_steps: int = 200_000) -> dict:
    """Submit a trace and drain it; returns the metrics report with the
    scheduler's and the spill's counters and the engine's fault counters.

    With ``clock=None`` the engine's virtual clock drives time (one step()
    call per time unit); pass a wall clock callable for real-time
    measurement. The report carries the submitted requests under
    "requests" so callers can assert token streams."""
    reqs = [engine.submit(it.prompt, max_new=it.max_new,
                          arrival=it.arrival, priority=it.priority,
                          deadline=it.deadline)
            for it in trace]
    done = engine.run(clock=clock, max_steps=max_steps)
    makespan = max((r.finished_at for r in done if r.finished_at is not None),
                   default=0.0)
    report = summarize(done, makespan=makespan)
    report["scheduler"] = engine.sched.stats()
    report["spill"] = {"spilled_pages": engine.n_spilled_pages,
                       "restored_pages": engine.n_restored_pages}
    report["faults"] = engine.fault_stats()
    report["requests"] = reqs
    return report


def _pct(xs: list, q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def _failed(r) -> bool:
    """Retired without a complete answer: rejected, shed, cancelled or
    quarantined."""
    return bool(r.rejected or r.shed or r.cancelled or r.error)


def _class_metrics(reqs: list, makespan: float) -> dict:
    served = [r for r in reqs if not _failed(r)]
    ttft = [r.ttft for r in served if r.ttft is not None]
    tpot = [r.tpot for r in served if r.tpot is not None]
    lat = [r.finished_at - r.arrival for r in served
           if r.finished_at is not None]
    tokens = sum(len(r.tokens) for r in served)
    return {
        "n": len(reqs),
        "n_served": len(served),
        "n_rejected": sum(1 for r in reqs if r.rejected),
        "n_preempted": sum(1 for r in reqs if r.n_preempts > 0),
        "n_shed": sum(1 for r in reqs if r.shed),
        "n_cancelled": sum(1 for r in reqs if r.cancelled),
        "n_error": sum(1 for r in reqs if r.error),
        "tokens": tokens,
        "goodput_tok_per_t": tokens / makespan if makespan > 0 else 0.0,
        "ttft_p50": _pct(ttft, 50), "ttft_p95": _pct(ttft, 95),
        "ttft_p99": _pct(ttft, 99),
        "tpot_p50": _pct(tpot, 50), "tpot_p95": _pct(tpot, 95),
        "latency_p50": _pct(lat, 50), "latency_p95": _pct(lat, 95),
        "queue_wait_p95": _pct([r.queue_wait for r in served], 95),
    }


def summarize(done: Sequence, *, makespan: Optional[float] = None) -> dict:
    """Per-class + overall percentile report over drained requests. Time
    units follow the clock that produced the stamps: virtual steps or
    seconds."""
    done = list(done)
    if makespan is None:
        makespan = max((r.finished_at for r in done
                        if r.finished_at is not None), default=0.0)
    by_cls: dict[int, list] = {}
    for r in done:
        by_cls.setdefault(r.priority, []).append(r)
    return {"makespan": makespan,
            "overall": _class_metrics(done, makespan),
            "classes": {CLASS_NAMES.get(c, str(c)): _class_metrics(rs,
                                                                   makespan)
                        for c, rs in sorted(by_cls.items())}}


def format_report(report: dict, *, unit: str = "steps") -> str:
    """Human-readable per-class table for launcher output."""
    lines = [f"{'class':<12} {'n':>4} {'srv':>4} {'rej':>4} {'pre':>4} "
             f"{'shd':>4} {'cxl':>4} {'err':>4} "
             f"{'ttft p50':>9} {'ttft p95':>9} {'tpot p50':>9} "
             f"{'lat p95':>9} {'goodput':>9}"]
    rows = [("overall", report["overall"])]
    rows += list(report["classes"].items())
    for name, m in rows:
        lines.append(
            f"{name:<12} {m['n']:>4} {m['n_served']:>4} "
            f"{m['n_rejected']:>4} {m['n_preempted']:>4} "
            f"{m['n_shed']:>4} {m['n_cancelled']:>4} {m['n_error']:>4} "
            f"{m['ttft_p50']:>9.2f} {m['ttft_p95']:>9.2f} "
            f"{m['tpot_p50']:>9.2f} {m['latency_p95']:>9.2f} "
            f"{m['goodput_tok_per_t']:>9.2f}")
    lines.append(f"(times in {unit}; goodput = completed tokens / makespan; "
                 f"shd/cxl = deadline shed/cancelled, err = quarantined)")
    if "faults" in report:
        f = report["faults"]
        lines.append(
            f"faults: {f['n_faults_applied']} injected, "
            f"{f['n_nonfinite']} non-finite quarantines, "
            f"{f['n_spill_checksum_fails']} corrupt spills caught, "
            f"{f['n_shed']} shed, {f['n_cancelled']} cancelled")
    return "\n".join(lines)
