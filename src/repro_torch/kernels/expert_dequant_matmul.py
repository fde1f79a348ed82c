"""CUDA kernel: every expert of an MoE layer's packed linear in one fused
dequantize + matmul launch (``csrc/expert_dequant_matmul.cu``).

Replaces the TPU kernel ``expert_dequant_matmul_pallas``
(src/repro/kernels/expert_dequant_matmul.py). The kernel streams each
expert's packed weight strip once through a shared-memory ring and
multiplies on the tensor cores with the weight as the wide operand
(``csrc/expert_stream.cuh``, shared with the expert W8A8 kernel); the
sources' headers say what bounds it on the H100 and what the design does
about it. Its plain version is ``kernels/ref.py::expert_dequant_matmul_ref``.

``plan`` cuts the work of both expert kernels into blocks; it is the one
fixed place their strips, capacity chunks and K splits are chosen
(``plan_with`` builds the plan of a given capacity tile and split count,
``plan``'s and a tuned entry's).

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch

from repro_torch.kernels import build
from repro_torch.kernels.packed_operands import (FLOATS, MAX_GRID_Z,
                                                 MAX_SMEM, SMS,
                                                 check_bf16_groups,
                                                 check_operands,
                                                 int32_sum_fits)

launches = 0
# launches on a bf16 x (also counted in ``launches``)
launches_bf16 = 0

# the kernels' geometry (csrc/expert_stream.cuh): a block's strip of
# output columns, the K rows of a ring stage, the ring's stages and the
# padding of a staged packed row per bit width
STRIP = 256
STAGE_K = 128
STAGES = 3
ROW_PAD = {2: 32, 3: 32, 4: 16, 8: 16}
# blocks that give each of the H100's 132 SMs about 8 (three are
# resident at a time at decode): K is split until the grid holds this
# many, so the last wave of blocks is a small part of the launch
TARGET_BLOCKS = 8 * SMS
# a split walks at least this many stages (the ring's fill is amortized)
MIN_STAGES_PER_SPLIT = 4
# n8 tiles of capacity rows a block may hold (both kernels; with 8, the
# f32 x rows of a prefill chunk grow the ring to one block an SM)
CAPACITY_TILES = (1, 2, 4)


@dataclass(frozen=True)
class ExpertPlan:
    """How a launch cuts (E, C, K) x (E, K, N): ``nt`` n8 tiles of capacity
    rows a block (chunks of 8 * nt rows), ``chunks`` of them over C,
    ``strips`` of STRIP columns over N, and K in ``splits`` ranges of
    ``k_per_split`` rows; ``smem`` bytes of ring a block."""
    nt: int
    chunks: int
    strips: int
    splits: int
    k_per_split: int
    smem: int
    experts: int

    @property
    def blocks(self) -> int:
        return self.experts * self.splits * self.chunks * self.strips


def scale_rows(k: int, groups: int) -> int:
    """Scale rows a ring stage holds (``scale_rows`` of the header): 1 for
    per-channel scales or a group of whole stages, the most groups a stage
    touches for a group of whole 16-row K steps, 0 for any other group
    (read per value)."""
    group = k // groups
    if groups == 1 or group % STAGE_K == 0:
        return 1
    if group % 16:
        return 0
    return min(STAGE_K // 16, (STAGE_K - 16) // group + 2)


def stage_bytes(bits: int, nt: int, x_bytes: int, srows: int) -> int:
    """Shared memory of one ring stage: its packed weight rows, its 8 * nt
    x rows and its scale rows (``stage_bytes`` of the header)."""
    values, nbytes = (8, 3) if bits == 3 else (8 // bits, 1)
    w = STAGE_K // values * nbytes * (STRIP + ROW_PAD[bits])
    x_row = STAGE_K * x_bytes + (64 if x_bytes == 4 else 16)
    return w + 8 * nt * x_row + srows * STRIP * 4


def plan(e: int, c: int, k: int, n: int, bits: int, groups: int, *,
         x_bytes: int, target_blocks: int = TARGET_BLOCKS,
         min_stages: int = MIN_STAGES_PER_SPLIT) -> ExpertPlan:
    """Cut the expert product into blocks. The capacity tile is the fewest
    n8 tiles of CAPACITY_TILES that hold C, else the largest whose ring fits
    shared memory (C then takes several chunks). K is split, in whole
    stages (and, for the W8A8 kernel's grouped scales, whole groups), only
    while the strips, chunks and experts give fewer than ``target_blocks``
    blocks, each split walking at least ``min_stages`` stages; no split is
    empty. (The dense kernels' decode body plans as one expert with its
    own two numbers: ``kernels/dequant_matmul.py::plan_stream``.)"""
    fitting = fitting_tiles(bits, x_bytes,
                            ring_scale_rows(k, groups, x_bytes))
    nt = next((t for t in fitting if 8 * t >= c), fitting[-1])
    unit = k_unit(k, groups, x_bytes)
    units = -(-k // unit)
    tiles = e * -(-c // (8 * nt)) * -(-n // STRIP)
    splits = max(1, min(-(-target_blocks // tiles),
                        units * unit // (STAGE_K * min_stages),
                        MAX_GRID_Z // e))
    return plan_with(e, c, k, n, bits, groups, x_bytes=x_bytes, nt=nt,
                     splits=splits)


def ring_scale_rows(k: int, groups: int, x_bytes: int) -> int:
    """Scale rows a ring stage holds for an x of ``x_bytes`` bytes: the
    W8A8 kernel reads per-channel scales once, not through the ring."""
    return 0 if x_bytes == 1 and groups == 1 else scale_rows(k, groups)


def fitting_tiles(bits: int, x_bytes: int, srows: int) -> list[int]:
    """The capacity tiles of CAPACITY_TILES whose ring fits shared
    memory."""
    return [t for t in CAPACITY_TILES
            if STAGES * stage_bytes(bits, t, x_bytes, srows) <= MAX_SMEM]


def k_unit(k: int, groups: int, x_bytes: int) -> int:
    """K rows a split holds a whole number of: a ring stage, and for the
    W8A8 kernel's grouped scales whole groups."""
    if x_bytes == 1 and groups > 1:
        return math.lcm(STAGE_K, k // groups)
    return STAGE_K


def plan_with(e: int, c: int, k: int, n: int, bits: int, groups: int, *,
              x_bytes: int, nt: int, splits: int) -> ExpertPlan:
    """The plan of capacity tile ``nt`` with K cut into ``splits`` equal
    ranges of whole ``k_unit``s, fewer where that would leave a split
    empty (``plan``'s cut, and a tuned entry's)."""
    unit = k_unit(k, groups, x_bytes)
    units = -(-k // unit)
    per = -(-units // max(1, min(splits, units)))
    return ExpertPlan(nt=nt, chunks=-(-c // (8 * nt)), strips=-(-n // STRIP),
                      splits=-(-units // per), k_per_split=per * unit,
                      smem=STAGES * stage_bytes(
                          bits, nt, x_bytes,
                          ring_scale_rows(k, groups, x_bytes)),
                      experts=e)


def launch(name: str, x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
           *, bits: int, group_size: int, k: int,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Check, plan and launch expert kernel ``name``: the dequant matmul
    on f32 or bf16 x writing ``out_dtype`` (f32 or bf16), or the W8A8
    matmul on int8 x writing f32 (its scale groups whole 16-row K steps,
    and no exact int32 group sum able to overflow), on the (E, C, K)
    capacity buffer x and the (E, ...) packed stack. The plan is the
    tuner's (``kernels/autotune.py``: ``plan``'s unless a tuned entry is
    in force). Returns the (E, C, N) output; the caller counts the
    launch."""
    int8 = name == "expert_w8a8_matmul"
    check_operands(name, x, torch.int8 if int8 else FLOATS, qw,
                   scale, bits=bits, group_size=group_size, k=k,
                   experts=True)
    if out_dtype not in (FLOATS[:1] if int8 else FLOATS):
        raise ValueError(f"{name}: no {out_dtype} output")
    check_bf16_groups(name, x, k, scale.shape[-2])
    group_rows = k if group_size == -1 else group_size
    if int8 and group_size != -1 and group_rows % 16:
        raise ValueError(f"{name}: a scale group of {group_rows} rows is not "
                         f"a multiple of 16")
    if x.shape[0] > MAX_GRID_Z:
        raise ValueError(f"{name}: {x.shape[0]} experts exceed the grid")
    e, c = x.shape[:2]
    n = qw.shape[-1]
    if c == 0 or e == 0:
        return torch.empty((e, c, n), dtype=out_dtype, device=x.device)
    # imported here: the tuner imports this module for its fixed planner
    from repro_torch.kernels import autotune
    p = autotune.expert_plan(name, e, c, k, n, bits, scale.shape[-2])
    # one exact int32 sum covers at most a group (or a split's rows)
    rows = min(group_rows, p.k_per_split)
    if int8 and not int32_sum_fits(bits, rows):
        raise ValueError(f"{name}: {rows} rows per int32 sum could overflow")
    return launch_plan(name, x, qw, scale, p, bits=bits, k=k,
                       out_dtype=out_dtype)


def launch_plan(name: str, x: torch.Tensor, qw: torch.Tensor,
                scale: torch.Tensor, p: ExpertPlan, *, bits: int, k: int,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Launch expert kernel ``name`` on checked operands as plan ``p``
    cuts it (``launch``'s; the tuner's search passes its candidates). A
    plan is x's dtype's too: a bf16 x only shrinks the ring. Returns the
    (E, C, N) output in ``out_dtype``."""
    int8 = name == "expert_w8a8_matmul"
    e, c = x.shape[:2]
    n = qw.shape[-1]
    groups = scale.shape[-2]
    out = torch.empty((e, c, n), dtype=out_dtype, device=x.device)
    work = (torch.empty((e, p.splits, c, n), dtype=torch.float32,
                        device=x.device) if p.splits > 1 else None)
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * (
            9 if int8 else 11) + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(x.device).cuda_stream
    dtypes = () if int8 else (int(x.dtype == torch.bfloat16),
                              int(out_dtype == torch.bfloat16))
    code = fn(x.data_ptr(), qw.data_ptr(), scale.data_ptr(), out.data_ptr(),
              None if work is None else work.data_ptr(), e, c, k, n, groups,
              bits, p.nt, p.splits, p.k_per_split, *dtypes, stream)
    build.check(name, code)
    return out


def expert_dequant_matmul_cuda(x: torch.Tensor, qw: torch.Tensor,
                               scale: torch.Tensor, *, bits: int,
                               group_size: int, k: int,
                               out_dtype: torch.dtype = torch.float32
                               ) -> torch.Tensor:
    """x (E, C, K) f32 or bf16 @ packed qw (E, packed_rows(K), N) uint8
    with scale (E, G, N) f32 -> (E, C, N) ``out_dtype`` (f32 or bf16), on
    the card, in one launch. Raises on anything the kernel does not
    take."""
    global launches, launches_bf16
    out = launch("expert_dequant_matmul", x, qw, scale, bits=bits,
                 group_size=group_size, k=k, out_dtype=out_dtype)
    if out.numel():
        launches += 1
        launches_bf16 += x.dtype == torch.bfloat16
    return out
