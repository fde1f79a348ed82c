"""The tuned kernels' spaces of launch choices, and the template version.

Counterpart of ``repro.kernels.template``. There, the Pallas kernels are
generated from templates in this module and the tile sizes are free
parameters. In the port the CUDA sources under ``csrc/`` are the
templates (their geometry is fixed at compile time), and what a launch
may choose is the cut of its work into blocks. This module holds:

  * ``TEMPLATE_VERSION``: a hash of ``csrc/*`` and the planner modules
    (``kernels/build.py::source_hash``). The tuner's JSON cache
    (``kernels/autotune.py``) carries it, so choices measured against
    other sources or other planners are ignored wholesale;
  * for each tuned kernel, its choices, how a choice becomes a plan for a
    call's real shape (through the fixed planner's own code), a validator
    and an enumerator of the candidates the tuner's search measures:

    - kernels 1 and 3 (``kernels/dequant_matmul.py``): the body (STREAM
      or TILE) and the K splits;
    - kernels 4 and 5 (``kernels/expert_dequant_matmul.py``): the
      capacity tile (n8 tiles a block, so the chunks over C) and the K
      splits; the strips over N are the source's STRIP;
    - kernel 2 (``kernels/paged_attention.py``): the cluster size
      ``n_split``.

The constraints stay with the planners that use them (the shared-memory
and grid limits of ``packed_operands.py``, ``tile_takes``, ``k_unit``,
the W8A8 int32 guard, ``geometry`` and MAX_SPLIT); the validators here
call them. Kernels 6 and 7 keep their fixed planners.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

from repro_torch.kernels import build
from repro_torch.kernels import dequant_matmul as dq
from repro_torch.kernels import expert_dequant_matmul as edq
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels.packed_operands import (MAX_GRID_Z, MAX_SMEM,
                                                 int32_sum_fits)

_HERE = Path(__file__).resolve().parent
PLANNER_MODULES = ("dequant_matmul.py", "expert_dequant_matmul.py",
                   "paged_attention.py", "packed_operands.py", "template.py")


def _template_version() -> str:
    return build.source_hash(sorted((_HERE / "csrc").iterdir())
                             + [_HERE / m for m in PLANNER_MODULES])


TEMPLATE_VERSION = _template_version()

# the search's K splits: dense_sweep's (tools/dense_sweep.py) for the dense
# bodies, the same powers of two for the expert kernels; the streaming
# body is searched up to the sweep's largest M
STREAM_SPLITS = (1, 2, 4, 8, 16, 32, 64)
TILE_SPLITS = (1, 2, 4, 8)
EXPERT_SPLITS = (1, 2, 4, 8, 16, 32)
STREAM_SEARCH_MAX_M = 512


def _int(ent, field: str) -> int:
    v = ent[field]
    if not isinstance(v, int) or isinstance(v, bool):
        raise ValueError(f"{field}={v!r} is not an integer")
    return v


def _check_splits(splits: int, k_per_split: int, k: int, unit: int,
                  want: int) -> None:
    """Every split a whole number of ``unit`` rows, none empty, and as
    many as the choice names."""
    if (splits != want or k_per_split % unit
            or splits * k_per_split < k or (splits - 1) * k_per_split >= k):
        raise ValueError(f"{want} splits of K {k} in units of {unit} "
                         f"rebuild as {splits} of {k_per_split}")


# --------------------------------------------------- kernels 1 and 3 (dense)

def dense_choice(p: dq.DensePlan) -> dict:
    return {"body": p.body, "splits": p.splits}


def dense_plan_from(choice: dict, m: int, k: int, n: int, bits: int,
                    groups: int, *, int8: bool) -> dq.DensePlan:
    """The plan of ``choice`` at the call's shape, cut by the fixed
    planner's code (``plan_stream`` / ``plan_tile``, then ``split_k``).
    Raises ValueError (or KeyError / TypeError on a malformed choice) if
    it breaks a constraint."""
    body, splits = _int(choice, "body"), _int(choice, "splits")
    if int8:
        dq.check_int32(k, groups, bits)
    if body == dq.STREAM:
        base = dq.plan_stream(m, k, n, bits, groups, int8=int8)
    elif body == dq.TILE:
        base = dq.plan_tile(m, k, n, bits, groups, int8=int8)
    else:
        raise ValueError(f"body {body} is neither STREAM nor TILE")
    if not 1 <= splits <= MAX_GRID_Z:
        raise ValueError(f"{splits} splits exceed the grid")
    p = dq.split_k(base, k, groups, splits, int8=int8)
    _check_splits(p.splits, p.k_per_split, k,
                  dq.k_unit(body, k, groups, int8=int8), splits)
    if p.smem > MAX_SMEM:
        raise ValueError(f"{p.smem} bytes of shared memory")
    return p


def valid_dense(choice, m: int, k: int, n: int, bits: int, groups: int, *,
                int8: bool) -> Optional[dq.DensePlan]:
    """``dense_plan_from``'s plan, or None if the choice is invalid."""
    try:
        return dense_plan_from(choice, m, k, n, bits, groups, int8=int8)
    except (KeyError, TypeError, ValueError):
        return None


def dense_candidates(m: int, k: int, n: int, bits: int, groups: int, *,
                     int8: bool) -> list[dict]:
    """The search's choices at ``m`` rows, the fixed plan's first: the
    streaming body (up to STREAM_SEARCH_MAX_M rows) at STREAM_SPLITS, the
    tile (where it takes the scales) at TILE_SPLITS, each kept where it
    rebuilds exactly."""
    fixed = dense_choice(dq.plan(m, k, n, bits, groups, int8=int8))
    cands = [fixed]
    bodies = []
    if m <= STREAM_SEARCH_MAX_M:
        bodies.append((dq.STREAM, STREAM_SPLITS))
    if dq.tile_takes(k, groups):
        bodies.append((dq.TILE, TILE_SPLITS))
    for body, splits in bodies:
        for s in splits:
            ch = {"body": body, "splits": s}
            if ch not in cands and valid_dense(ch, m, k, n, bits, groups,
                                               int8=int8):
                cands.append(ch)
    return cands


# ----------------------------------------------- kernels 4 and 5 (experts)

def expert_choice(p: edq.ExpertPlan) -> dict:
    return {"nt": p.nt, "splits": p.splits}


def expert_plan_from(choice: dict, e: int, c: int, k: int, n: int,
                     bits: int, groups: int, *,
                     x_bytes: int) -> edq.ExpertPlan:
    """The plan of ``choice`` at the call's shape (``plan_with``). Raises
    ValueError (or KeyError / TypeError) if it breaks a constraint: a
    capacity tile whose ring does not fit, a grid past its z limit, an
    empty split, or for the W8A8 kernel an int32 sum that could
    overflow."""
    nt, splits = _int(choice, "nt"), _int(choice, "splits")
    srows = edq.ring_scale_rows(k, groups, x_bytes)
    if nt not in edq.fitting_tiles(bits, x_bytes, srows):
        raise ValueError(f"capacity tile {nt} does not fit")
    if not 1 <= splits <= MAX_GRID_Z // e:
        raise ValueError(f"{splits} splits of {e} experts exceed the grid")
    p = edq.plan_with(e, c, k, n, bits, groups, x_bytes=x_bytes, nt=nt,
                      splits=splits)
    _check_splits(p.splits, p.k_per_split, k,
                  edq.k_unit(k, groups, x_bytes), splits)
    if x_bytes == 1 and not int32_sum_fits(bits, min(k // groups,
                                                     p.k_per_split)):
        raise ValueError(f"{p.k_per_split} rows per int32 sum could "
                         f"overflow")
    return p


def valid_expert(choice, e: int, c: int, k: int, n: int, bits: int,
                 groups: int, *, x_bytes: int) -> Optional[edq.ExpertPlan]:
    try:
        return expert_plan_from(choice, e, c, k, n, bits, groups,
                                x_bytes=x_bytes)
    except (KeyError, TypeError, ValueError):
        return None


def expert_candidates(e: int, c: int, k: int, n: int, bits: int,
                      groups: int, *, x_bytes: int) -> list[dict]:
    """The search's choices, the fixed plan's first: every capacity tile
    that fits, at EXPERT_SPLITS, each kept where it rebuilds exactly."""
    fixed = expert_choice(edq.plan(e, c, k, n, bits, groups,
                                   x_bytes=x_bytes))
    cands = [fixed]
    for nt in edq.fitting_tiles(bits, x_bytes,
                                edq.ring_scale_rows(k, groups, x_bytes)):
        for s in EXPERT_SPLITS:
            ch = {"nt": nt, "splits": s}
            if ch not in cands and valid_expert(ch, e, c, k, n, bits,
                                                groups, x_bytes=x_bytes):
                cands.append(ch)
    return cands


# ------------------------------------------------------- kernel 2 (paged)

def paged_choice(n_split: int) -> dict:
    return {"n_split": n_split}


def paged_split_from(choice: dict, s: int, kvh: int, w: int, page_size: int,
                     rows: int, hd: int, hd_v: int, kv: str) -> int:
    """The cluster size of ``choice``: 1 to MAX_SPLIT blocks, on a shape
    whose shared memory fits (``plan_paged``'s check, which raises)."""
    n = _int(choice, "n_split")
    pa.plan_paged(s, kvh, w, page_size, rows, hd, hd_v, kv)
    if not 1 <= n <= pa.MAX_SPLIT:
        raise ValueError(f"n_split {n} not in 1..{pa.MAX_SPLIT}")
    return n


def valid_paged(choice, s: int, kvh: int, w: int, page_size: int,
                rows: int, hd: int, hd_v: int,
                kv: str) -> Optional[int]:
    try:
        return paged_split_from(choice, s, kvh, w, page_size, rows, hd,
                                hd_v, kv)
    except (KeyError, TypeError, ValueError):
        return None


def paged_candidates(s: int, kvh: int, w: int, page_size: int, rows: int,
                     hd: int, hd_v: int, kv: str) -> list[dict]:
    """Every cluster size, the fixed plan's first."""
    fixed = pa.plan_paged(s, kvh, w, page_size, rows, hd, hd_v, kv)
    return [paged_choice(fixed)] + [paged_choice(n)
                                    for n in range(1, pa.MAX_SPLIT + 1)
                                    if n != fixed]
