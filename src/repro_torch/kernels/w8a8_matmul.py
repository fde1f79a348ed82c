"""CUDA kernel: int8 activations x packed low-bit weights on the int8
tensor cores (``csrc/w8a8_matmul.cu``).

Replaces the TPU kernel ``w8a8_matmul_pallas``
(src/repro/kernels/w8a8_matmul.py). The source's header says what bounds
it on the H100 and what the design does about it; its plain version is
``kernels/ref.py::w8a8_matmul_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant.types import packed_rows, qmax_for_bits
from repro_torch.kernels import build
from repro_torch.kernels.dequant_matmul import plan_splits

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p])

# the kernel's K slice (csrc/w8a8_matmul.cu; its tile and K step are the
# dequant matmul's, so the two share ``plan_splits``)
SLICE_K = 16


def _lib():
    lib = build.load("w8a8_matmul")
    fn = lib.w8a8_matmul
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def w8a8_matmul_cuda(xq: torch.Tensor, qw: torch.Tensor,
                     scale: torch.Tensor, *, bits: int, group_size: int,
                     k: int) -> torch.Tensor:
    """xq (M, K) int8 @ packed qw (packed_rows(K), N) uint8 with scale
    (G, N) f32 -> (M, N) f32 before the per-token rescale, on the card.
    Raises on anything the kernel does not take."""
    global launches
    n = qw.shape[-1]
    group_rows = k if group_size == -1 else group_size
    want_g = 1 if group_size == -1 else k // group_size
    if not xq.is_cuda:
        raise ValueError("w8a8_matmul: xq must be a CUDA tensor")
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"w8a8_matmul: bits={bits} not in (2, 3, 4, 8)")
    if not (xq.dtype == torch.int8 and xq.ndim == 2 and xq.shape[1] == k
            and qw.dtype == torch.uint8
            and tuple(qw.shape) == (packed_rows(k, bits), n)
            and scale.dtype == torch.float32
            and tuple(scale.shape) == (want_g, n)
            and (group_size == -1 or k % group_size == 0)):
        raise ValueError(
            f"w8a8_matmul: want xq (M, {k}) int8, qw "
            f"({packed_rows(k, bits)}, N) uint8, scale ({want_g}, N) f32 for "
            f"group_size={group_size}; got {tuple(xq.shape)} {xq.dtype}, "
            f"{tuple(qw.shape)} {qw.dtype}, {tuple(scale.shape)} "
            f"{scale.dtype}")
    if want_g > 1 and group_rows % SLICE_K:
        raise ValueError(f"w8a8_matmul: a scale group of {group_rows} rows "
                         f"is not a multiple of {SLICE_K}")
    if not (qw.device == xq.device and scale.device == xq.device):
        raise ValueError("w8a8_matmul: xq, qw and scale must be on one "
                         "device")
    if not (xq.is_contiguous() and qw.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError("w8a8_matmul: operands must be contiguous")
    m = xq.shape[0]
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    if m == 0:
        return out
    splits, k_per_split = plan_splits(m, k, n, group_rows)
    # one exact int32 sum covers at most a group (or a split's rows)
    rows = min(group_rows, k_per_split)
    if 127 * qmax_for_bits(bits) * rows >= 2 ** 31:
        raise ValueError(f"w8a8_matmul: {rows} rows per int32 sum could "
                         "overflow")
    work = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=xq.device) if splits > 1 else None)
    vec_x = int(k % 16 == 0 and xq.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    code = _lib()(xq.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                  out.data_ptr(), None if work is None else work.data_ptr(),
                  m, k, n, want_g, bits, splits, k_per_split, vec_x, stream)
    build.check("w8a8_matmul", code)
    launches += 1
    return out
