"""Start the ranks of a multi-device run: one process per rank, each in
one ``torch.distributed`` process group.

``run_ranks(fn, world, backend=...)`` spawns ``world`` processes (the
``spawn`` start method), joins each to a process group through a
``FileStore`` (no port to pick, so runs side by side cannot collide),
calls ``fn(rank, world, *args)`` in each and returns their results in
rank order. A rank that raises, or ranks that outlast ``timeout``, fail
the call with the rank's traceback, and every rank still running is
killed: a hung collective never outlives its caller.

The backend is chosen, never switched quietly: ``default_backend`` maps
the CPU to ``gloo`` and the card to ``nccl``, and a caller may ask for
another. Several ranks on one card need ``gloo``: NCCL refuses two ranks
on one device.
"""
from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def default_backend(device: str) -> str:
    """``gloo`` for the CPU, ``nccl`` for the card."""
    return "gloo" if torch.device(device).type == "cpu" else "nccl"


def _rank_main(rank: int, world: int, backend: str, store: str,
               fn: Callable, args: tuple, out) -> None:
    # one intra-op thread a rank: ranks share the host's cores
    torch.set_num_threads(1)
    try:
        dist.init_process_group(backend, init_method=f"file://{store}",
                                rank=rank, world_size=world)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except BaseException:      # reported to the parent, which raises
        out.put((rank, False, traceback.format_exc()))


def run_ranks(fn: Callable, world: int, *, backend: str, args: tuple = (),
              timeout: float = 600.0,
              store_dir: Optional[str] = None) -> list:
    """``[fn(rank, world, *args) for rank in range(world)]``, each rank in
    its own process in one process group. ``fn`` and ``args`` must pickle
    (``fn`` by import path) and so must each result. The FileStore lives
    in a temporary directory under ``store_dir`` (the system's default
    without one)."""
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    with tempfile.TemporaryDirectory(dir=store_dir) as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, backend, store, fn, args, out),
                             daemon=True)
                 for r in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        results: dict[int, object] = {}
        try:
            while len(results) < world:
                left = deadline - time.monotonic()
                try:
                    rank, ok, value = out.get(timeout=max(left, 0.01))
                except queue.Empty:
                    missing = sorted(set(range(world)) - set(results))
                    raise RuntimeError(
                        f"ranks {missing} of {world} did not finish within "
                        f"{timeout:.0f} s") from None
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{value}")
                results[rank] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
    return [results[r] for r in range(world)]
