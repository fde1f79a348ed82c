"""Single entry point for every linear layer (port of ``repro.models.linear``).

A linear's params are {"w": W} or {"w": W, "b": b}. W is a float (K, N)
tensor or a packed ``QuantizedTensor``:

  * float tensor     -> ``torch.matmul`` in f32 (left to the library, as
    the JAX package leaves it to XLA);
  * QuantizedTensor  -> ``kernels.ops.dequant_matmul``: the CUDA
    dequant-matmul kernel on the card, its plain version on the CPU, for
    bits {2, 3, 4, 8}.

The W8A8 branch of the JAX package (act_bits == 8) waits for a later
slice.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.kernels import ops


def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """y = x @ w (+ b). x: (..., K) f32 -> (..., N) f32."""
    w = p["w"]
    if isinstance(w, QuantizedTensor):
        lead = x.shape[:-1]
        y = ops.dequant_matmul(x.reshape(-1, x.shape[-1]), w)
        y = y.reshape(*lead, w.n)
    else:
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if p.get("b") is not None:
        y = y + p["b"]
    return y


def init_dense(gen: torch.Generator, k: int, n: int, device) -> dict:
    std = 1.0 / (k ** 0.5)
    return {"w": torch.randn((k, n), generator=gen, device=device) * std}
