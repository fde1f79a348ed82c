"""CUDA kernel: fused low-bit dequantize + matmul (``csrc/dequant_matmul.cu``).

Replaces the TPU kernel ``dequant_matmul_pallas``
(src/repro/kernels/dequant_matmul.py). The source's header says what
bounds it on the H100 and what the design does about it; its plain
version is ``kernels/ref.py::dequant_matmul_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant.types import packed_rows
from repro_torch.kernels import build

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p])

# the kernel's output tile and K step (csrc/dequant_matmul.cu)
TILE_M, TILE_N, TILE_K = 64, 64, 32
# blocks that keep every one of the H100's 132 SMs busy several times over
TARGET_BLOCKS = 1024
# a split walks at least this many K steps, bounding the partials' traffic
MIN_STEPS_PER_SPLIT = 4


def plan_splits(m: int, k: int, n: int) -> tuple[int, int]:
    """(splits, k_per_split): cut K across blocks when the output tiles
    alone are too few to fill the card (the decode shapes). k_per_split is
    a whole number of K steps and no split is empty."""
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    steps = -(-k // TILE_K)
    splits = max(1, min(-(-TARGET_BLOCKS // tiles),
                        steps // MIN_STEPS_PER_SPLIT))
    per = -(-steps // splits)
    return -(-steps // per), per * TILE_K


def _lib():
    lib = build.load("dequant_matmul")
    fn = lib.dequant_matmul
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def dequant_matmul_cuda(x: torch.Tensor, qw: torch.Tensor,
                        scale: torch.Tensor, *, bits: int, group_size: int,
                        k: int) -> torch.Tensor:
    """x (M, K) f32 @ packed qw (packed_rows(K), N) uint8 with scale (G, N)
    f32 -> (M, N) f32, on the card. Raises on anything the kernel does not
    take."""
    global launches
    n = qw.shape[-1]
    want_g = 1 if group_size == -1 else k // group_size
    if not x.is_cuda:
        raise ValueError("dequant_matmul: x must be a CUDA tensor")
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"dequant_matmul: bits={bits} not in (2, 3, 4, 8)")
    if not (x.dtype == torch.float32 and x.ndim == 2 and x.shape[1] == k
            and qw.dtype == torch.uint8
            and tuple(qw.shape) == (packed_rows(k, bits), n)
            and scale.dtype == torch.float32
            and tuple(scale.shape) == (want_g, n)
            and (group_size == -1 or k % group_size == 0)):
        raise ValueError(
            f"dequant_matmul: want x (M, {k}) f32, qw "
            f"({packed_rows(k, bits)}, N) uint8, scale ({want_g}, N) f32 for "
            f"group_size={group_size}; got {tuple(x.shape)} {x.dtype}, "
            f"{tuple(qw.shape)} {qw.dtype}, {tuple(scale.shape)} "
            f"{scale.dtype}")
    if not (qw.device == x.device and scale.device == x.device):
        raise ValueError("dequant_matmul: x, qw and scale must be on one "
                         "device")
    if not (x.is_contiguous() and qw.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("dequant_matmul: operands must be contiguous")
    m = x.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if m == 0:
        return out
    splits, k_per_split = plan_splits(m, k, n)
    work = (torch.empty((splits, m, n), dtype=torch.float32, device=x.device)
            if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _lib()(x.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), None if work is None else work.data_ptr(),
                  m, k, n, want_g, bits, splits, k_per_split, stream)
    build.check("dequant_matmul", code)
    launches += 1
    return out
