"""CUDA kernel: RTN quantize + pack of a weight stack
(``csrc/quantize_pack.cu``).

Replaces the TPU kernel ``quantize_pack_pallas``
(src/repro/kernels/quantize.py). The source's header says what bounds it
on the H100 and what the design does about it; its plain version is
``kernels/ref.py::quantize_pack_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.core.quant.types import pack_layout, packed_rows
from repro_torch.kernels import build

launches = 0


def _lib():
    fn = build.load("quantize_pack").quantize_pack
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
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
    if max(b, -(-k // pack_layout(bits)[1])) > 65535:
        raise ValueError(f"quantize_pack: at most 65535 stacked weights and "
                         f"packed groups of K, got {b} and K={k}")
    w, scale = w.contiguous(), scale.contiguous()
    out = torch.empty(lead + (packed_rows(k, bits), n), dtype=torch.uint8,
                      device=w.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(w.device).cuda_stream
    code = _lib()(w.data_ptr(), scale.data_ptr(), out.data_ptr(), b, k, n, g,
                  bits, int(w.dtype == torch.bfloat16), stream)
    build.check("quantize_pack", code)
    launches += 1
    return out
