"""CUDA kernel: per-channel mean and population variance of a (T, C)
activation (``csrc/channel_stats.cu``).

Replaces the TPU kernel ``channel_stats_pallas``
(src/repro/kernels/channel_stats.py). The source's header says what
bounds it on the H100, what the design does about it and why it computes
the two-pass variance where the TPU kernel returned E[x^2] - mean^2; its
plain version is ``kernels/ref.py::channel_stats_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0

# the kernel's tile of rows (csrc/channel_stats.cu) and channels a block
TILE_ROWS, STRIP = 256, 32
# blocks that keep every one of the H100's 132 SMs busy several times over
TARGET_BLOCKS = 2048


def plan_ranges(t: int, c: int) -> tuple[int, int]:
    """(rows_per_range, ranges): the row ranges of stage 1, whole tiles
    each, enough of them with the channel strips to fill the card, none
    empty. A function of the shape only, so the sums' order is too."""
    tiles = -(-t // TILE_ROWS)
    strips = -(-c // STRIP)
    ranges = max(1, min(tiles, -(-TARGET_BLOCKS // strips)))
    per = -(-tiles // ranges)
    return per * TILE_ROWS, -(-tiles // per)


def _lib():
    fn = build.load("channel_stats").channel_stats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def channel_stats_cuda(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, C) f32 or bf16 -> (mean (C,), var (C,)) f32 over T, the
    population variance, on the card. Raises on anything the kernel does
    not take."""
    global launches
    if not x.is_cuda:
        raise ValueError("channel_stats: x must be a CUDA tensor")
    if x.ndim != 2 or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"channel_stats: want x (T, C) f32 or bf16, got "
                         f"{tuple(x.shape)} {x.dtype}")
    t, c = x.shape
    if t == 0 or c == 0:
        raise ValueError(f"channel_stats: empty x {tuple(x.shape)}")
    x = x.contiguous()
    rows, ranges = plan_ranges(t, c)
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    var = torch.empty(c, dtype=torch.float32, device=x.device)
    work = torch.empty((2, ranges, c), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _lib()(x.data_ptr(), mean.data_ptr(), var.data_ptr(),
                  work.data_ptr(), t, c, rows, ranges,
                  int(x.dtype == torch.bfloat16), stream)
    build.check("channel_stats", code)
    launches += 1
    return mean, var
