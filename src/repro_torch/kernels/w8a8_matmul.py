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

from repro_torch.core.quant.types import qmax_for_bits
from repro_torch.kernels import build
from repro_torch.kernels.dequant_matmul import check_operands, plan_splits

launches = 0

# the kernel's K slice (csrc/w8a8_matmul.cu; its tile and K step are the
# dequant matmul's, so the two share ``plan_splits``)
SLICE_K = 16


def _lib(name: str):
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def run(name: str, xq: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
        *, bits: int, group_size: int, k: int) -> torch.Tensor:
    """Check, plan and launch the W8A8 body as library ``name``: xq (M, K)
    int8. Returns the f32 output before the per-token rescale; the caller
    counts the launch."""
    check_operands(name, xq, torch.int8, qw, scale, bits=bits,
                   group_size=group_size, k=k, experts=False)
    n = qw.shape[-1]
    group_rows = k if group_size == -1 else group_size
    want_g = 1 if group_size == -1 else k // group_size
    if want_g > 1 and group_rows % SLICE_K:
        raise ValueError(f"{name}: a scale group of {group_rows} rows is not "
                         f"a multiple of {SLICE_K}")
    m = xq.shape[-2]
    out = torch.empty(xq.shape[:-1] + (n,), dtype=torch.float32,
                      device=xq.device)
    if m == 0:
        return out
    splits, k_per_split = plan_splits(m, k, n, group_rows)
    # one exact int32 sum covers at most a group (or a split's rows)
    rows = min(group_rows, k_per_split)
    if 127 * qmax_for_bits(bits) * rows >= 2 ** 31:
        raise ValueError(f"{name}: {rows} rows per int32 sum could overflow")
    work = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=xq.device) if splits > 1 else None)
    vec_x = int(k % 16 == 0 and xq.data_ptr() % 16 == 0)
    stream = torch.cuda.current_stream(xq.device).cuda_stream
    code = _lib(name)(xq.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                      out.data_ptr(),
                      None if work is None else work.data_ptr(),
                      m, k, n, want_g, bits, splits, k_per_split, vec_x,
                      stream)
    build.check(name, code)
    return out


def w8a8_matmul_cuda(xq: torch.Tensor, qw: torch.Tensor,
                     scale: torch.Tensor, *, bits: int, group_size: int,
                     k: int) -> torch.Tensor:
    """xq (M, K) int8 @ packed qw (packed_rows(K), N) uint8 with scale
    (G, N) f32 -> (M, N) f32 before the per-token rescale, on the card.
    Raises on anything the kernel does not take."""
    global launches
    out = run("w8a8_matmul", xq, qw, scale, bits=bits,
              group_size=group_size, k=k)
    if out.numel():
        launches += 1
    return out
