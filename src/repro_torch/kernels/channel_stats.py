"""CUDA kernel: per-channel mean and population variance of a (T, C)
activation (``csrc/channel_stats.cu``).

Replaces the TPU kernel ``channel_stats_pallas``
(src/repro/kernels/channel_stats.py). A launch is one thread-block
cluster per strip of STRIP channels: its ranks take every ranks-th stage
of the strip's rows, each thread streams its 16-byte slots through a
cp.async ring, and rank 0 merges the ranks in rank order through
distributed shared memory. ``plan_stats`` picks the cluster size from the
shape. The source's header says what bounds it on
the H100, what the design does about it and why it computes the two-pass
variance where the TPU kernel returned E[x^2] - mean^2; its plain version
is ``kernels/ref.py::channel_stats_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.packed_operands import SMS

launches = 0

# the source's geometry (csrc/channel_stats.cu): threads a block, channels
# a block, rows of a thread's tile, tiles of a thread in the ring, the
# largest cluster, bytes a thread copies of a row
THREADS = 256
STRIP = 64
TILE = 8
STAGES = 2
MAX_RANKS = 8
SLOT = 16
# the planner: about one block for every other SM. Fewer blocks walk the
# rows in fewer fronts, and on the H100 96 blocks of 3 ranks beat 160-256
# (tools/stats_pack_sweep.py), where each SM still pulls its share
TARGET_BLOCKS = SMS // 2


class StatsPlan(NamedTuple):
    ranks: int        # blocks of a strip's cluster
    strips: int       # clusters (grid y)
    stage_rows: int   # rows a block's stage covers
    stages: int       # stages of T, rank k taking k, k + ranks, ...


def width(bf16: bool) -> int:
    """Channels in a thread's 16-byte slot."""
    return SLOT // (2 if bf16 else 4)


def plan_stats(t: int, c: int, bf16: bool) -> StatsPlan:
    """The cluster size of a launch: enough clusters x ranks for about
    TARGET_BLOCKS, at most MAX_RANKS, and no rank without a stage. A
    function of the shape only, so the sums' order is too."""
    if t < 1 or c < 1:
        raise ValueError(f"channel_stats: empty x ({t}, {c})")
    stage_rows = THREADS // (STRIP // width(bf16)) * TILE
    strips = -(-c // STRIP)
    stages = -(-t // stage_rows)
    ranks = max(1, min(MAX_RANKS, stages, -(-TARGET_BLOCKS // strips)))
    return StatsPlan(ranks, strips, stage_rows, stages)


def vector_ok(c: int, bf16: bool, ptr: int) -> bool:
    """16-byte copies: every row's slots lie on 16 bytes."""
    return c % width(bf16) == 0 and ptr % 16 == 0


def _lib():
    fn = build.load("channel_stats").channel_stats
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
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
    bf16 = x.dtype == torch.bfloat16
    p = plan_stats(t, c, bf16)
    x = x.contiguous()
    mean = torch.empty(c, dtype=torch.float32, device=x.device)
    var = torch.empty(c, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _lib()(x.data_ptr(), mean.data_ptr(), var.data_ptr(), t, c,
                  p.ranks, int(bf16),
                  int(vector_ok(c, bf16, x.data_ptr())), stream)
    build.check("channel_stats", code)
    launches += 1
    return mean, var
