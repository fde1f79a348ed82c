"""CUDA kernel: int8 activations x packed low-bit weights on the int8
tensor cores (``csrc/w8a8_matmul.cu``).

Replaces the TPU kernel ``w8a8_matmul_pallas``
(src/repro/kernels/w8a8_matmul.py). Like the dequant matmul it has two
bodies, chosen by M: at decode the expert W8A8 kernel's weight-streaming
body as one expert (``csrc/stream_w8a8.cuh``), at prefill the pipelined
tensor-core tile (``csrc/prefill_tile.cuh``). The sources' headers say
what bounds it on the H100 and what the design does about it; its plain
version is ``kernels/ref.py::w8a8_matmul_ref``. The planner and launcher
are the dequant matmul's (``kernels/dequant_matmul.py``).

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.dequant_matmul import run

launches = 0


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
