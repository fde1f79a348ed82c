"""Compile-count sanitizer: compile-like events per (site, variant).

Port of ``repro.analysis.sanitize``. The port has no jit, so it counts
the events that play a compile's part here, each the first time the
process meets its key:

  * ``kernel_load``: a kernel library built or loaded
    (``kernels/build.py::load``);
  * ``autotune_search``: a cold shape class measured by the tuner
    (``kernels/autotune.py``, ``RTORCH_AUTOTUNE=1``);
  * ``plan``: a miss of the resolved-plan cache of kernels 1-5
    (``kernels/autotune.py``), through which every launch of them plans;
  * the engine's step entry points at a new shape-bucket variant
    (``serve/engine.py``: ``paged_prefill``, ``sample_first``,
    ``spill_gather``, ``spill_scatter``, ``paged_decode_scan``,
    ``spec_block``), keyed as the JAX engine keys their jits.

:func:`note_trace` counts one event for its key, under
``RTORCH_SANITIZE=1`` only; the sites call it on their cache misses.
:func:`note_variant` is the engine's: a process-wide set of the variants
already run stands for the JAX package's process-wide jit caches, so a
variant counts once, the first time any engine runs it.

Budget: each key is one compile-like event, so the budget is **1 per
key**; a second event for a key means a cache was defeated by something
outside the key (a planner cache cleared, a library loaded twice).

CLI (``python -m repro_torch.analysis.sanitize [--device cpu]``, on the
card by default): builds a small TINY-family model, packs it W4 g32,
replays the seeded bursty trace of ``serve/traffic.py``, then replays it
again on a fresh engine in the same process. The second replay must add
**zero** events and no key may exceed its budget; it exits non-zero
otherwise.
"""
from __future__ import annotations

import argparse
import os
import sys
from collections import Counter
from typing import Dict, Optional, Tuple

from repro_torch.debug_flags import PREFIX, sanitize_enabled

Key = Tuple[str, Tuple[Tuple[str, object], ...]]

_trace_counts: Counter = Counter()
# the engine's step variants this process has run (the jit caches' part)
_variants: set = set()


def _key(name: str, key: dict) -> Key:
    return (name, tuple(sorted(key.items())))


def note_trace(name: str, **key) -> None:
    """Record one compile-like event of site ``name`` for the variant
    described by ``key``. Call it where the site's cache misses. A no-op
    (one flag check) unless RTORCH_SANITIZE=1."""
    if not sanitize_enabled():
        return
    _trace_counts[_key(name, key)] += 1


def note_variant(name: str, **key) -> None:
    """An engine step entry point about to run at variant ``key``: one
    event the first time this process runs it, none after."""
    if not sanitize_enabled():
        return
    k = _key(name, key)
    if k not in _variants:
        _variants.add(k)
        _trace_counts[k] += 1


def trace_counts() -> Dict[Key, int]:
    return dict(_trace_counts)


def reset_trace_counts() -> None:
    """Clear the counts (the variants already run stay run, as the JAX
    package's jit caches stay compiled)."""
    _trace_counts.clear()


def new_traces(baseline: Dict[Key, int]) -> Dict[Key, int]:
    """Events since ``baseline`` (a trace_counts() snapshot): {key: extra
    count}. Empty means the caches absorbed the workload."""
    return {k: c - baseline.get(k, 0) for k, c in _trace_counts.items()
            if c > baseline.get(k, 0)}


def budget_violations(max_per_key: int = 1) -> Dict[Key, int]:
    """Keys counted more than ``max_per_key`` times."""
    return {k: c for k, c in _trace_counts.items() if c > max_per_key}


def _fmt(name: str, key) -> str:
    return f"{name}({', '.join(f'{k}={v}' for k, v in key)})"


def format_report(baseline: Optional[Dict[Key, int]] = None) -> str:
    lines = [f"sanitize: {sum(_trace_counts.values())} events across "
             f"{len(_trace_counts)} keys"]
    for (name, key), count in sorted(_trace_counts.items(), key=str):
        lines.append(f"  {_fmt(name, key)}: {count}")
    if baseline is not None:
        fresh = new_traces(baseline)
        lines.append(f"sanitize: {sum(fresh.values())} new events since "
                     "baseline" + ("" if fresh else " (cache-stable)"))
    return "\n".join(lines)


# the CLI's model: TINY cut to 2 layers of d 64, as the JAX package's
CLI_MODEL = dict(n_repeats=2, d_model=64, head_dim=16, d_ff=128)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--quant-bits", type=int, default=4,
                    help="pack the model at these bits, group 32 (0: float)")
    args = ap.parse_args(argv)
    # the CLI is the one writer of its own flag
    os.environ.setdefault(PREFIX + "SANITIZE", "1")
    if not sanitize_enabled():
        print(f"sanitize: {PREFIX}SANITIZE is explicitly disabled",
              flush=True)
        return 2
    # deferred: note_trace must import anywhere without the engine
    from repro_torch.configs import TINY
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ContinuousEngine
    from repro_torch.serve.traffic import make_trace, replay

    cfg = TINY.replace(**CLI_MODEL)
    params = init_lm(cfg, seed=0, device=args.device)
    trace = make_trace(kind="bursty", n=args.requests, seed=0,
                       vocab_size=cfg.vocab_size)
    kw = dict(n_slots=4, device=args.device, quant_bits=args.quant_bits,
              quant_group=32 if args.quant_bits else 0)
    reset_trace_counts()
    rep1 = replay(ContinuousEngine(cfg, params, **kw), trace)
    first = trace_counts()
    print(format_report(), flush=True)
    # a fresh engine in the same process: every variant already ran
    rep2 = replay(ContinuousEngine(cfg, params, **kw), trace)
    fresh, over = new_traces(first), budget_violations(max_per_key=1)
    ok = True
    if fresh:
        ok = False
        print(f"sanitize: FAIL: {sum(fresh.values())} new events on the "
              "second replay (a cache defeated):")
        for (name, key), count in sorted(fresh.items(), key=str):
            print(f"  {_fmt(name, key)}: +{count}")
    if over:
        ok = False
        print("sanitize: FAIL: the per-key budget (1) exceeded:")
        for (name, key), count in sorted(over.items(), key=str):
            print(f"  {_fmt(name, key)}: {count}")
    if ([list(r.tokens) for r in rep1["requests"]]
            != [list(r.tokens) for r in rep2["requests"]]):
        ok = False
        print("sanitize: FAIL: the two replays' tokens differ")
    if ok:
        print("sanitize: OK: the second replay added zero events and every "
              "key counted once")
    return 0 if ok else 1


if __name__ == "__main__":
    # under `python -m` this file runs as __main__ while the sites import
    # the canonical module: delegate to it, so the counts they write are
    # the counts read here
    from repro_torch.analysis.sanitize import main as _main
    sys.exit(_main())
