"""CUDA kernel: fused low-bit dequantize + matmul (``csrc/dequant_matmul.cu``).

Replaces the TPU kernel ``dequant_matmul_pallas``
(src/repro/kernels/dequant_matmul.py). The kernel has two bodies, chosen
by M: at decode the weight-streaming kernel of the expert matmuls as one
expert (``csrc/stream_dequant.cuh`` on ``csrc/expert_stream.cuh``), at
prefill a pipelined tensor-core tile (``csrc/prefill_tile.cuh``). The
sources' headers say what bounds it on the H100 and what the design does
about it; its plain version is ``kernels/ref.py::dequant_matmul_ref``.

``plan`` is the one fixed planner of both dense packed matmuls (this one
and the W8A8 matmul, ``kernels/w8a8_matmul.py``): it picks the body by
M, leaves the cut into blocks to that body's planner (``plan_stream``,
``plan_tile``) and guards the W8A8 kernel's int32 sums. ``run`` asks the
tuner (``kernels/autotune.py``) for the plan, which is ``plan``'s unless
a tuned entry for the shape class is in force.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels import expert_dequant_matmul as edq
from repro_torch.kernels.packed_operands import (FLOATS, MAX_GRID_Z,
                                                 MAX_SMEM, SMS,
                                                 check_bf16_groups,
                                                 check_operands,
                                                 int32_sum_fits)

launches = 0
# launches on a bf16 x (also counted in ``launches``)
launches_bf16 = 0

# the bodies, as the C entry points take them
STREAM, TILE = 0, 1
# the streaming body serves up to this many token rows, the tile more: the
# largest M of the card's sweep of both bodies (``tools/dense_sweep.py``,
# PERF.md §6) at which the streaming body led on both of llama's 2048 x
# 8192 and 2048 x 2048. The W8A8 tile multiplies int8 at twice the bf16
# rate, so it overtakes the streaming body at fewer rows
STREAM_MAX_M = {"dequant_matmul": 96, "w8a8_matmul": 32}
# the streaming body's K splits: until the grid holds STREAM_TARGET_BLOCKS
# blocks, down to one ring stage a split (the expert kernels' numbers suit
# 403 MB stacks, not 0.5-18 MiB linears); the best split count of the
# sweep at M = 8 on each of llama's four shapes and Mixtral's two
STREAM_TARGET_BLOCKS = 3 * SMS
STREAM_MIN_STAGES = 1
# the tile's geometry (csrc/prefill_tile.cuh): token rows of a block tile
# and K rows of a ring stage (its columns, ring depth and shared memory:
# ``tile_geometry``)
TILE_M, TILE_K = 128, 64
# the tile's K splits: only while the tiles leave SMs idle (one block an
# SM), each split at least TILE_MIN_STAGES stages
TILE_MIN_STAGES = 4


@dataclass(frozen=True)
class DensePlan:
    """How a launch cuts (M, K) x (K, N): ``body`` STREAM (``nt`` n8 tiles
    of token rows a block, ``row_blocks`` chunks of 8 * nt rows,
    ``col_blocks`` strips of edq.STRIP columns) or TILE (``row_blocks`` x
    ``col_blocks`` tiles of TILE_M rows and ``tile_geometry``'s columns);
    K in ``splits`` ranges of
    ``k_per_split`` rows; ``smem`` bytes of shared memory a block."""
    body: int
    nt: int
    row_blocks: int
    col_blocks: int
    splits: int
    k_per_split: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.row_blocks * self.col_blocks * self.splits


@dataclass(frozen=True)
class TileGeometry:
    """The tile of one kernel (``Geo`` of the header): ``columns`` weight
    columns a block (256; 128 for grouped W8A8, whose second set of
    accumulators would not fit), ``look`` stages fetched ahead (4, or 3
    where 4 would not fit), ``smem`` bytes of ring and operand buffers."""
    columns: int
    look: int
    smem: int


def tile_geometry(bits: int, *, int8: bool, grouped: bool) -> TileGeometry:
    columns = 128 if int8 and grouped else 256
    x_row = TILE_K * (1 if int8 else 2) + 16   # and an operand row
    srows = 0 if int8 and not grouped else 1
    # a stage: its packed rows (8 K rows take `bits` bytes, each row padded
    # by 16), TILE_M x rows and its scale rows
    stage = (TILE_K // 8 * bits * (columns + 16) + TILE_M * x_row
             + srows * columns * 4)
    operands = 2 * columns * x_row
    look = 4 if 5 * stage + operands <= MAX_SMEM else 3
    return TileGeometry(columns, look, (look + 1) * stage + operands)


def tile_takes(k: int, groups: int) -> bool:
    """True when the tile takes the scales: per-channel, or groups of
    whole ring stages."""
    return groups == 1 or (k // groups) % TILE_K == 0


def k_unit(body: int, k: int, groups: int, *, int8: bool) -> int:
    """K rows a split of ``body`` holds a whole number of: its ring stage
    (edq.STAGE_K streaming, TILE_K the tile), and for the W8A8 kernel's
    scale groups whole groups."""
    step = edq.STAGE_K if body == STREAM else TILE_K
    return math.lcm(step, k // groups) if int8 and groups > 1 else step


def split_k(p: DensePlan, k: int, groups: int, splits: int, *,
            int8: bool) -> DensePlan:
    """``p`` with K cut into ``splits`` equal ranges of whole ``k_unit``s,
    fewer where that would leave a split empty."""
    unit = k_unit(p.body, k, groups, int8=int8)
    units = -(-k // unit)
    per = -(-units // max(1, min(splits, units)))
    return dataclasses.replace(p, splits=-(-units // per),
                               k_per_split=per * unit)


def plan_stream(m: int, k: int, n: int, bits: int, groups: int, *,
                int8: bool) -> DensePlan:
    """The streaming body's plan: one expert of the expert planner, with
    this module's split numbers."""
    p = edq.plan(1, m, k, n, bits, groups, x_bytes=1 if int8 else 4,
                 target_blocks=STREAM_TARGET_BLOCKS,
                 min_stages=STREAM_MIN_STAGES)
    return DensePlan(STREAM, p.nt, p.chunks, p.strips, p.splits,
                     p.k_per_split, p.smem)


def plan_tile(m: int, k: int, n: int, bits: int, groups: int, *,
              int8: bool) -> DensePlan:
    """The tile's plan: K split in whole stages (and, for the W8A8
    kernel's groups, whole groups) only while the tiles are fewer than
    the SMs, each split at least TILE_MIN_STAGES stages."""
    if not tile_takes(k, groups):
        raise ValueError(f"the tile takes no groups of {k // groups} rows")
    geo = tile_geometry(bits, int8=int8, grouped=groups > 1)
    tiles_m, tiles_n = -(-m // TILE_M), -(-n // geo.columns)
    unit = k_unit(TILE, k, groups, int8=int8)
    splits = max(1, min(SMS // (tiles_m * tiles_n),
                        -(-k // unit) * unit // (TILE_K * TILE_MIN_STAGES),
                        MAX_GRID_Z))
    return split_k(DensePlan(TILE, 0, tiles_m, tiles_n, 1, k, geo.smem),
                   k, groups, splits, int8=int8)


def check_int32(k: int, groups: int, bits: int) -> None:
    """Raise ValueError if the W8A8 kernel's exact int32 sum could
    overflow: one sum covers a group, or all of K per-channel (K splits
    add their sums in int32), whatever the plan."""
    rows = k // groups
    if not int32_sum_fits(bits, rows):
        raise ValueError(f"w8a8_matmul: {rows} rows per int32 sum could "
                         f"overflow")


@functools.lru_cache(maxsize=4096)
def plan(m: int, k: int, n: int, bits: int, groups: int, *,
         int8: bool) -> DensePlan:
    """Cut the dense product into blocks: ``plan_stream`` for M up to the
    kernel's STREAM_MAX_M rows and for scale groups the tile does not
    take, else ``plan_tile``. For the W8A8 kernel, raises ValueError if an exact
    int32 sum could overflow. Cached: every linear of a model asks again
    at every step."""
    if int8:
        check_int32(k, groups, bits)
    most = STREAM_MAX_M["w8a8_matmul" if int8 else "dequant_matmul"]
    if m > most and tile_takes(k, groups):
        return plan_tile(m, k, n, bits, groups, int8=int8)
    return plan_stream(m, k, n, bits, groups, int8=int8)


def workspace_bytes(p: DensePlan, m: int, k: int, n: int, *,
                    int8: bool, x_bf16: bool = False) -> int:
    """Scratch a launch needs: kernel 1's tile takes bf16(x) of an f32 x
    first (M x K, padded to 256 bytes: ``xb_bytes`` of the header; a bf16
    x is read as it is), then with K split either body takes splits x M x
    N 4-byte partials."""
    xb = (-(-m * k * 2 // 256) * 256
          if p.body == TILE and not int8 and not x_bf16 else 0)
    return xb + (p.splits * m * n * 4 if p.splits > 1 else 0)


def _lib(name: str):
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        ints = 9 if name == "w8a8_matmul" else 11
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * ints + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def run(name: str, x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
        *, bits: int, group_size: int, k: int,
        out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Check, plan and launch dense kernel ``name``: the dequant matmul on
    f32 or bf16 x writing ``out_dtype`` (f32 or bf16), or the W8A8 matmul
    on int8 x (its scale groups whole 16-row K steps) writing f32, x (M,
    K). Returns the (M, N) output; the caller counts the launch."""
    int8 = name == "w8a8_matmul"
    check_operands(name, x, torch.int8 if int8 else FLOATS, qw,
                   scale, bits=bits, group_size=group_size, k=k,
                   experts=False)
    if int8 and group_size != -1 and group_size % 16:
        raise ValueError(f"{name}: a scale group of {group_size} rows is "
                         f"not a multiple of 16")
    if out_dtype not in (FLOATS[:1] if int8 else FLOATS):
        raise ValueError(f"{name}: no {out_dtype} output")
    check_bf16_groups(name, x, k, scale.shape[-2])
    m, n = x.shape[-2], qw.shape[-1]
    if m == 0:
        return torch.empty((0, n), dtype=out_dtype, device=x.device)
    # imported here: the tuner imports this module for its fixed planner
    from repro_torch.kernels import autotune
    p = autotune.dense_plan(name, m, k, n, bits, scale.shape[-2])
    return launch(name, x, qw, scale, p, bits=bits, k=k,
                  out_dtype=out_dtype)


def launch(name: str, x: torch.Tensor, qw: torch.Tensor,
           scale: torch.Tensor, p: DensePlan, *, bits: int, k: int,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch dense kernel ``name`` on checked operands as plan ``p``
    cuts it (``run``'s; the card's sweep of bodies and splits passes its
    own). A plan is x's dtype's too: a bf16 x only shrinks the ring.
    Returns the (M, N) output in ``out_dtype``."""
    int8 = name == "w8a8_matmul"
    x_bf16 = x.dtype == torch.bfloat16
    m, n = x.shape[-2], qw.shape[-1]
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    nbytes = workspace_bytes(p, m, k, n, int8=int8, x_bf16=x_bf16)
    work = (torch.empty(nbytes, dtype=torch.uint8, device=x.device)
            if nbytes else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dtypes = () if int8 else (int(x_bf16),
                              int(out_dtype == torch.bfloat16))
    code = _lib(name)(x.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                      out.data_ptr(),
                      None if work is None else work.data_ptr(),
                      m, k, n, scale.shape[-2], bits, p.body, p.nt,
                      p.splits, p.k_per_split, *dtypes, stream)
    build.check(name, code)
    return out


def dequant_matmul_cuda(x: torch.Tensor, qw: torch.Tensor,
                        scale: torch.Tensor, *, bits: int, group_size: int,
                        k: int, out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """x (M, K) f32 or bf16 @ packed qw (packed_rows(K), N) uint8 with
    scale (G, N) f32 -> (M, N) ``out_dtype`` (f32 or bf16), on the card.
    Raises on anything the kernel does not take."""
    global launches, launches_bf16
    out = run("dequant_matmul", x, qw, scale, bits=bits,
              group_size=group_size, k=k, out_dtype=out_dtype)
    if out.numel():                      # an empty x launches nothing
        launches += 1
        launches_bf16 += x.dtype == torch.bfloat16
    return out
