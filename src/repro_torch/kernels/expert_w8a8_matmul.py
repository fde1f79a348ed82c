"""CUDA kernel: every expert of an MoE layer's packed linear in one int8 x
int8 launch on the tensor cores (``csrc/expert_w8a8_matmul.cu``).

Replaces the TPU kernel ``expert_w8a8_matmul_pallas``
(src/repro/kernels/expert_w8a8_matmul.py). The kernel streams each
expert's packed weight strip once through a shared-memory ring and
multiplies on the int8 tensor cores with the weight as the wide operand
(``csrc/expert_stream.cuh``, shared with the expert dequant matmul, whose
module holds the planner and launcher both use); the sources' headers say
what bounds it on the H100 and what the design does about it. Its plain
version is ``kernels/ref.py::expert_w8a8_matmul_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.expert_dequant_matmul import launch

launches = 0


def expert_w8a8_matmul_cuda(xq: torch.Tensor, qw: torch.Tensor,
                            scale: torch.Tensor, *, bits: int,
                            group_size: int, k: int) -> torch.Tensor:
    """xq (E, C, K) int8 @ packed qw (E, packed_rows(K), N) uint8 with
    scale (E, G, N) f32 -> (E, C, N) f32 before the per-token rescale, on
    the card, in one launch. Raises on anything the kernel does not
    take."""
    global launches
    out = launch("expert_w8a8_matmul", xq, qw, scale, bits=bits,
                 group_size=group_size, k=k)
    if out.numel():
        launches += 1
    return out
