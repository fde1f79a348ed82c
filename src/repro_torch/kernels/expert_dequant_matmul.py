"""CUDA kernel: every expert of an MoE layer's packed linear in one fused
dequantize + matmul launch (``csrc/expert_dequant_matmul.cu``).

Replaces the TPU kernel ``expert_dequant_matmul_pallas``
(src/repro/kernels/expert_dequant_matmul.py). The kernel is the dense
dequant matmul's body (``csrc/dequant_matmul.cuh``) with the expert on the
grid; the header says what bounds it on the H100 and what the design does
about it. Its plain version is ``kernels/ref.py::expert_dequant_matmul_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import dequant_matmul as _dq

launches = 0


def expert_dequant_matmul_cuda(x: torch.Tensor, qw: torch.Tensor,
                               scale: torch.Tensor, *, bits: int,
                               group_size: int, k: int) -> torch.Tensor:
    """x (E, C, K) f32 @ packed qw (E, packed_rows(K), N) uint8 with scale
    (E, G, N) f32 -> (E, C, N) f32, on the card, in one launch. Raises on
    anything the kernel does not take."""
    global launches
    out = _dq.run("expert_dequant_matmul", x, qw, scale, bits=bits,
                  group_size=group_size, k=k, experts=True)
    if out.numel():
        launches += 1
    return out
