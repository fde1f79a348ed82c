"""The collectives the port's multi-device paths run over a mesh axis.

Each takes the axis by name and finds the process group through the
active mesh (``distributed/sharding.py::sharding_ctx``), as the JAX
package's ``psum`` / ``pmax`` / ``all_to_all`` / ``all_gather`` take an
axis name inside ``shard_map``. An axis of one rank is the identity. A
collective asked for with no mesh active, or on an axis the mesh lacks,
raises: a row-parallel partial sum is never returned unreduced.

The backend is the process group's: ``nccl`` across cards, ``gloo`` for
ranks on the CPU, and ``gloo`` for several ranks on one card (NCCL refuses
two ranks on one device). gloo takes CUDA tensors for all four
collectives here (probed on an H100 with torch 2.11: ``all_reduce`` SUM
and MAX, ``all_gather``, ``all_to_all_single``), so nothing stages
through host memory by hand.

``counts`` counts the calls of each collective in this process and
``nbytes`` the bytes each sent (all-reduce and all-to-all: the result's
size; all-gather: the input's), so a caller can read what a step moved
(``launch/roofline.py::collective_bytes``); ``reset_counts`` zeroes both.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import active_mesh

counts: dict[str, int] = {"all_reduce": 0, "all_gather": 0,
                          "all_to_all": 0}
nbytes: dict[str, int] = dict.fromkeys(counts, 0)


def reset_counts() -> None:
    for k in counts:
        counts[k] = 0
        nbytes[k] = 0


def _count(kind: str, x: torch.Tensor) -> None:
    counts[kind] += 1
    nbytes[kind] += x.numel() * x.element_size()


def _group(axis: str):
    """(process group or None, axis size) of ``axis`` on the active
    mesh."""
    mesh = active_mesh()
    if mesh is None:
        raise RuntimeError(f"a collective over {axis!r} needs an active "
                           f"mesh (sharding_ctx)")
    if axis not in mesh.shape:
        raise RuntimeError(f"the active mesh has no axis {axis!r}: "
                           f"{mesh.shape}")
    return mesh.group(axis), mesh.shape[axis]


def axis_index(axis: str) -> int:
    """This rank's coordinate on ``axis`` of the active mesh."""
    _group(axis)
    return active_mesh().axis_index(axis)


def axis_size(axis: str) -> int:
    return _group(axis)[1]


def all_reduce(x: torch.Tensor, axis: str, op: str = "sum") -> torch.Tensor:
    """``x`` reduced over ``axis`` ("sum", "max" or "mean"); a new tensor,
    the same on every rank of the axis."""
    group, size = _group(axis)
    if size == 1:
        return x
    out = x.contiguous().clone()
    red = dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM
    dist.all_reduce(out, op=red, group=group)
    _count("all_reduce", out)
    if op == "mean":
        out = out / size
    return out


def all_gather(x: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    group, size = _group(axis)
    if size == 1:
        return x
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=group)
    _count("all_gather", x)
    return torch.cat(parts, dim=dim)


def all_to_all(x: torch.Tensor, axis: str) -> torch.Tensor:
    """Split ``x`` along dim 0 into one equal chunk per rank of ``axis``
    and send chunk j to rank j; returns the chunks received, in source
    rank order along dim 0 (``all_to_all_single``)."""
    group, size = _group(axis)
    if size == 1:
        return x
    if x.shape[0] % size:
        raise ValueError(f"all_to_all: dim 0 of {tuple(x.shape)} does not "
                         f"split over {size} ranks")
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _count("all_to_all", out)
    return out
