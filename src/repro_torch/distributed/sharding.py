"""Logical-axis sharding: rules mapping logical axis names to mesh axes
(port of ``repro.distributed.sharding``).

Models and params are described by *logical* axis names ("batch", "mlp",
"vocab", ...). A rules table maps those to the axes of a mesh
(``launch/mesh.py``), and ``spec_for`` resolves the names of one tensor
to a ``ShardSpec`` (the counterpart of JAX's ``PartitionSpec``): per
dim, the mesh axis (or axes) that split it, or None. It drops an axis the mesh lacks, an axis that does not divide
the dim, and an axis already used by an earlier dim, as the JAX package
does.

The port runs one process per rank (``torch.distributed``), so a spec is
not a placement request to a compiler: ``distributed/partitioning.py``
cuts each rank's shard out of a whole tree by it. ``lc`` is therefore a
no-op here (there is no compiler to constrain); it is kept so model code
reads as the JAX package's. ``sharding_ctx`` activates a mesh for the
code below it: row-parallel linears and the expert-parallel MoE find
their process groups through ``active_mesh()``.
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Union

import torch

Axes = Union[None, str, tuple[str, ...]]

# Mesh axis carrying tensor parallelism for serving: heads, kv-heads, the
# MLP hidden dim and the paged KV pools' kv-head dim split over it, and
# row-parallel linears all-reduce over it (partitioning.py,
# ``serve_param_shardings``, has the placement contract).
TP_AXIS = "model"

# Default logical -> mesh rules for the (pod, data, model) production mesh.
DEFAULT_RULES: dict[str, Axes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "embed_fsdp": ("pod", "data"),   # param embed dim when FSDP is on
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qk_dim": None,
    "mlp": "model",
    "expert": "model",
    "capacity": None,
    "kv_seq": None,
    "kv_lora": None,
    "conv": None,
    "ssm_heads": "model",
    "ssm_state": None,
    "norm": None,
    "pos": None,
}


class ShardSpec(tuple):
    """Per dim of a tensor, the mesh axis (a name, a tuple of names) that
    splits it, or None: the counterpart of ``jax.sharding.PartitionSpec``,
    a tuple of the same entries."""

    def __new__(cls, *axes):
        # a one-axis tuple is that axis, as JAX normalises it
        return super().__new__(cls, (
            a[0] if isinstance(a, tuple) and len(a) == 1 else a
            for a in axes))

    def __repr__(self) -> str:
        return f"ShardSpec{tuple(self)!r}"


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, Axes] = dict(DEFAULT_RULES)


_CTX = _Ctx()


@contextlib.contextmanager
def sharding_ctx(mesh, rules: Optional[dict[str, Axes]] = None):
    """Activate a mesh and logical rules for the code inside."""
    old = (_CTX.mesh, _CTX.rules)
    _CTX.mesh = mesh
    _CTX.rules = {**DEFAULT_RULES, **(rules or {})}
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = old


def active_mesh():
    return _CTX.mesh


def _flat(axes: Axes) -> tuple[str, ...]:
    if axes is None:
        return ()
    return (axes,) if isinstance(axes, str) else tuple(axes)


def _axis_size(mesh, axes: Axes) -> int:
    return math.prod(mesh.shape[a] for a in _flat(axes))


def spec_for(shape: Sequence[int], names: Sequence[Optional[str]],
             mesh=None, rules: Optional[dict[str, Axes]] = None
             ) -> ShardSpec:
    """Resolve logical names to a ShardSpec, dropping axes the mesh
    lacks, axes that do not divide their dim, and a mesh axis a second
    time. ``mesh`` is anything with a ``shape`` dict (axis -> size); with
    none (and none active) every named axis is kept."""
    mesh = mesh or _CTX.mesh
    rules = rules or _CTX.rules
    out = []
    used: set = set()
    for dim, name in zip(shape, names):
        axes = rules.get(name) if name else None
        if axes is not None and mesh is not None:
            # drop axes the mesh does not have (e.g. "pod" on one pod)
            flat = tuple(a for a in _flat(axes) if a in mesh.shape)
            axes = None if not flat else (flat[0] if len(flat) == 1
                                          else flat)
            if axes is not None and dim % _axis_size(mesh, axes) != 0:
                axes = None          # not divisible: leave it whole
        if axes is not None:
            flat = _flat(axes)
            if any(a in used for a in flat):
                axes = None          # a mesh axis appears once per spec
            else:
                used.update(flat)
        out.append(axes)
    return ShardSpec(*out)


def lc(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Logical sharding constraint: a no-op in the port (each rank already
    holds its shard, and there is no compiler to constrain). The rank
    check stays, so a wrong annotation still fails."""
    if len(names) != x.ndim:
        raise ValueError(f"lc: {len(names)} names for rank-{x.ndim} tensor")
    return x
