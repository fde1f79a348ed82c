"""Device meshes over ``torch.distributed`` (port of ``repro.launch.mesh``).

A ``Mesh`` names the axes of the world of ranks ("data", "model", and
"pod" across pods), their sizes, this rank's coordinate on each, and one
process group per axis: the ranks that differ from this one on that axis
alone. Ranks are laid out row-major over the axes, the last axis
fastest, as ``jax.make_mesh`` lays out devices. An axis of size 1 needs no
group. A mesh of one rank needs no process group at all. Each axis also
has a ``gloo`` group over the same ranks for host values (the serving
clock), which is the axis's own group when the backend is ``gloo``.

Functions, not module constants: importing this module touches no
process group.
"""
from __future__ import annotations

import itertools
import math
from typing import Optional

import torch.distributed as dist


class Mesh:
    """Axis names, sizes, this rank's coordinates and a process group per
    axis. ``shape`` is a dict axis -> size, as a JAX mesh's."""

    def __init__(self, shape: tuple[int, ...], axes: tuple[str, ...], *,
                 rank: int, groups: dict, host_groups: Optional[dict] = None):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))
        self.rank = rank
        self.coords = dict(zip(axes, _coords(rank, shape)))
        self._groups = groups
        self._host_groups = groups if host_groups is None else host_groups

    def axis_index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        """This rank's process group along ``axis`` (None when the axis has
        one rank)."""
        if axis not in self.shape:
            raise KeyError(f"mesh has no axis {axis!r}: {self.shape}")
        return self._groups.get(axis)

    def host_group(self, axis: str):
        """The ``gloo`` group along ``axis``, for CPU tensors."""
        self.group(axis)
        return self._host_groups.get(axis)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"


def _coords(rank: int, shape) -> tuple[int, ...]:
    out = []
    for size in reversed(shape):
        out.append(rank % size)
        rank //= size
    return tuple(reversed(out))


def make_mesh(shape: tuple[int, ...], axes: tuple[str, ...]) -> Mesh:
    """A mesh over the initialised process group, whose world size must be
    the product of ``shape``; raises otherwise, as ``jax.make_mesh`` does
    for a device count that is not the mesh's. Every rank must call it, in
    the same order (each axis's groups are made collectively)."""
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    need = math.prod(shape)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != need:
        raise ValueError(f"mesh {dict(zip(axes, shape))} needs {need} "
                         f"ranks, the process group has {world}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    host = dist.is_initialized() and dist.get_backend() != "gloo"
    groups, host_groups = {}, {}
    for i, axis in enumerate(axes):
        if shape[i] == 1:
            continue
        # every line along axis i: the other axes' coordinates fixed
        others = [range(s) for j, s in enumerate(shape) if j != i]
        for fixed in itertools.product(*others):
            members = []
            for c in range(shape[i]):
                coord = list(fixed)
                coord.insert(i, c)
                members.append(_rank_of(coord, shape))
            group = dist.new_group(members)
            host_group = (dist.new_group(members, backend="gloo") if host
                          else group)
            if rank in members:
                groups[axis] = group
                host_groups[axis] = host_group
    return Mesh(tuple(shape), tuple(axes), rank=rank, groups=groups,
                host_groups=host_groups)


def _rank_of(coord, shape) -> int:
    r = 0
    for c, s in zip(coord, shape):
        r = r * s + c
    return r


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The production mesh: (data 16, model 16), or with ``multi_pod``
    (pod 2, data 16, model 16); 256 or 512 ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes)


def make_mesh_from_plan(shape: tuple[int, ...],
                        axes: tuple[str, ...]) -> Mesh:
    """The elastic path: whatever mesh launch/elastic.py planned."""
    return make_mesh(shape, axes)


def chips_in_mesh(mesh) -> int:
    return math.prod(mesh.shape.values())

