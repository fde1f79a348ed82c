"""Which gloo collectives take CUDA tensors with all ranks on one card,
and what an all-reduce of a decode step's activations costs there.

    python3 tools/gloo_probe.py

Spawns 2 and then 4 ranks on the one card (one process group each, a
FileStore in a temporary directory) and, on every rank, runs each
collective the port's multi-device paths use on CUDA tensors:
``all_reduce`` SUM and MAX, ``all_gather`` (and ``all_gather_into_tensor``),
``all_to_all_single`` and ``broadcast``, printing for each whether it ran
and what it returned; then the mean time of 200 back-to-back
``all_reduce`` calls of an (8, 2048) f32 tensor (llama3.2-1b's decode
activations at 8 slots), measured on the host clock around a device
synchronise. NCCL refuses two ranks on one device, so this is what lets
one card hold a tensor-parallel run. Needs one card.
"""
from __future__ import annotations

import json
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _rank(rank: int, world: int, store: str, out) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    res = {}

    def probe(name, fn):
        try:
            t0 = time.perf_counter()
            value = fn()
            torch.cuda.synchronize()
            res[name] = dict(ok=True, out=value, s=time.perf_counter() - t0)
        except (RuntimeError, ValueError) as e:
            res[name] = dict(ok=False, err=f"{type(e).__name__}: {e}"[:300])

    def reduce(op):
        x = torch.full((8, 2048), float(rank + 1), device=dev)
        dist.all_reduce(x, op=op)
        return float(x[0, 0])

    def gather():
        x = torch.full((4, 3), float(rank), device=dev)
        parts = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(parts, x)
        return [float(p[0, 0]) for p in parts]

    def gather_into():
        x = torch.full((4, 3), float(rank), device=dev)
        y = torch.empty((world * 4, 3), device=dev)
        dist.all_gather_into_tensor(y, x)
        return y[:, 0].tolist()

    def all_to_all():
        x = torch.arange(world * 2, dtype=torch.float32,
                         device=dev) + 100 * rank
        y = torch.empty_like(x)
        dist.all_to_all_single(y, x)
        return y.tolist()

    def broadcast():
        x = torch.full((3,), float(rank), device=dev)
        dist.broadcast(x, 0)
        return x.tolist()

    probe("all_reduce_sum", lambda: reduce(dist.ReduceOp.SUM))
    probe("all_reduce_max", lambda: reduce(dist.ReduceOp.MAX))
    probe("all_gather", gather)
    probe("all_gather_into_tensor", gather_into)
    probe("all_to_all_single", all_to_all)
    probe("broadcast", broadcast)
    x = torch.ones((8, 2048), device=dev)
    for _ in range(10):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(200):
        dist.all_reduce(x)
    torch.cuda.synchronize()
    res["all_reduce_8x2048_ms"] = (time.perf_counter() - t0) / 200 * 1e3
    out.put((rank, res))
    dist.destroy_process_group()


def main() -> None:
    print(torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0))
    ctx = mp.get_context("spawn")
    for world in (2, 4):
        with tempfile.TemporaryDirectory() as tmp:
            out = ctx.Queue()
            procs = [ctx.Process(target=_rank,
                                 args=(r, world, f"{tmp}/store", out))
                     for r in range(world)]
            t0 = time.perf_counter()
            for p in procs:
                p.start()
            results = sorted(out.get(timeout=300) for _ in procs)
            for p in procs:
                p.join(60)
        print(f"world {world}: {time.perf_counter() - t0:.1f} s")
        for rank, res in results:
            print(rank, json.dumps(res))


if __name__ == "__main__":
    main()
