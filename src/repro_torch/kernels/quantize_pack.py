"""CUDA kernel: RTN quantize + pack of a weight stack
(``csrc/quantize_pack.cu``).

Replaces the TPU kernel ``quantize_pack_pallas``
(src/repro/kernels/quantize.py). A thread owns 4 columns and a run of
RUN_ROWS rows of K; a block walks tiles of QUADS column quads x RUNS runs
over a grid of a few waves. ``plan_pack`` gives the tiles and the grid
from the shape. The source's header says what bounds it on the H100 and
what the design does about it; its plain version is
``kernels/ref.py::quantize_pack_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from repro_torch.core.quant.types import pack_layout, packed_rows
from repro_torch.kernels import build
from repro_torch.kernels.packed_operands import SMS

launches = 0

# the source's geometry (csrc/quantize_pack.cu): column quads and runs a
# tile (the block is QUADS x RUNS threads), columns a thread, rows of K a
# thread's run
QUADS = 32
RUNS = 8
COLS = 4
RUN_ROWS = 8
# the planner: a grid of 16 blocks for each SM (8 waves of 2), 2112 on the
# H100; fewer were slower there and more gained nothing
# (tools/stats_pack_sweep.py)
GRID_BLOCKS = 16 * SMS


class PackPlan(NamedTuple):
    run: int           # packed groups a thread's run
    quad_blocks: int   # tiles across N
    run_blocks: int    # tiles down the packed groups of K
    tiles: int         # every stack index's tiles
    blocks: int        # the grid


def plan_pack(b: int, k: int, n: int, bits: int) -> PackPlan:
    """The tiles of a (b, K, N) stack, and the grid that walks them:
    GRID_BLOCKS blocks, or one a tile when there are fewer tiles."""
    values = pack_layout(bits)[1]
    run = RUN_ROWS // values
    quad_blocks = -(-n // (QUADS * COLS))
    run_blocks = -(-(-(-k // values)) // (run * RUNS))
    tiles = b * run_blocks * quad_blocks
    if tiles >= 2 ** 31:
        raise ValueError(f"quantize_pack: {tiles} tiles, want < 2^31")
    return PackPlan(run, quad_blocks, run_blocks, tiles,
                    min(tiles, GRID_BLOCKS))


def vector_ok(n: int, w: torch.Tensor, scale: torch.Tensor,
              out: torch.Tensor) -> bool:
    """Vector loads and stores: N a multiple of 4, w on 16 bytes (8 for
    bf16), scale on 16 and out on 4."""
    align = 8 if w.dtype == torch.bfloat16 else 16
    return (n % COLS == 0 and w.data_ptr() % align == 0
            and scale.data_ptr() % 16 == 0 and out.data_ptr() % 4 == 0)


def _lib():
    fn = build.load("quantize_pack").quantize_pack
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def quantize_pack_cuda(w: torch.Tensor, scale: torch.Tensor, *,
                       bits: int) -> torch.Tensor:
    """w (..., K, N) f32 or bf16, scale (..., G, N) f32 with G dividing K
    -> packed uint8 (..., packed_rows(K), N), every leading index in one
    launch, on the card. Raises on anything the kernel does not take."""
    global launches
    if not w.is_cuda:
        raise ValueError("quantize_pack: w must be a CUDA tensor")
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"quantize_pack: bits={bits} not in (2, 3, 4, 8)")
    if w.ndim < 2 or w.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"quantize_pack: want w (..., K, N) f32 or bf16, "
                         f"got {tuple(w.shape)} {w.dtype}")
    lead, (k, n) = w.shape[:-2], w.shape[-2:]
    g = scale.shape[-2] if scale.ndim == w.ndim else 0
    if not (scale.dtype == torch.float32 and scale.shape[:-2] == lead
            and g > 0 and k % g == 0 and scale.shape[-1] == n):
        raise ValueError(f"quantize_pack: want scale {tuple(lead)} + (G, "
                         f"{n}) f32 with G dividing K={k}, got "
                         f"{tuple(scale.shape)} {scale.dtype}")
    if scale.device != w.device:
        raise ValueError("quantize_pack: w and scale must be on one device")
    b = math.prod(lead)
    w, scale = w.contiguous(), scale.contiguous()
    out = torch.empty(lead + (packed_rows(k, bits), n), dtype=torch.uint8,
                      device=w.device)
    if out.numel() == 0:
        return out
    p = plan_pack(b, k, n, bits)
    stream = torch.cuda.current_stream(w.device).cuda_stream
    code = _lib()(w.data_ptr(), scale.data_ptr(), out.data_ptr(), b, k, n, g,
                  bits, int(w.dtype == torch.bfloat16),
                  int(vector_ok(n, w, scale, out)), p.blocks, stream)
    build.check("quantize_pack", code)
    launches += 1
    return out
