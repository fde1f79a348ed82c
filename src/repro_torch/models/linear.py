"""Single entry point for every linear layer (port of ``repro.models.linear``).

A linear's params are {"w": W} or {"w": W, "b": b}. W is a float (K, N)
tensor or a packed ``QuantizedTensor``:

  * float tensor                 -> ``torch.matmul`` in f32 (left to the
    library, as the JAX package leaves it to XLA);
  * QuantizedTensor              -> ``kernels.ops.dequant_matmul``: the
    CUDA dequant-matmul kernel on the card, its plain version on the CPU;
  * QuantizedTensor, act_bits 8  -> ``kernels.ops.w8a8_matmul``: per-token
    int8 activations, the CUDA int8 matmul kernel (its plain version on
    the CPU), per-token rescale;

for bits {2, 3, 4, 8}. ``reduce_axis`` marks a row-parallel call under
tensor parallelism (see ``dense``). Other ``act_bits`` (the JAX package's legacy
per-tensor fake-quant) are refused. ``dense_experts`` is the same for an
MoE layer's stacked (E, K, N) experts over its (E, C, K) capacity buffer:
a float stack goes to ``torch.matmul`` in f32, a packed one to the
expert-batched kernels (all E experts in one launch), as
``kernels.ops.expert_dequant_matmul`` or, with act_bits 8,
``kernels.ops.expert_w8a8_matmul``.

Gradients. The norm-tweaking loss differentiates through packed linears.
The dequant-matmul kernel has no derivative of its own, so it runs inside
``_DequantMatmul``, whose backward is ``grad @ dequantize(W).T`` in f32
(per expert for an expert stack) — what the JAX package's CPU path (an
f32 einsum over the dequantized weight) differentiates; the kernel's bf16
rounding of x counts as the identity. Only a call that records a gradient
goes through it: serving calls the kernel directly, without autograd's
per-call bookkeeping. The W8A8 kernels need no
such wrapper: their operand is the int8 codes, which carry no gradient,
so their output is a constant of x and the gradient reaches x only
through the per-token scale that rescales it (to each token's largest
|x|), exactly as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant.types import QuantizedTensor, dequantize
from repro_torch.distributed.collectives import all_reduce
from repro_torch.kernels import ops


class _DequantMatmul(torch.autograd.Function):
    """Forward: the dequant-matmul kernel, or for an (E, K, N) expert
    stack the expert-batched one; backward: plain f32 product."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
        ctx.qt = qt
        if qt.qw.ndim == 3:
            return ops.expert_dequant_matmul(x, qt)
        return ops.dequant_matmul(x, qt)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return torch.matmul(grad, dequantize(ctx.qt).transpose(-1, -2)), None


def _dense_quantized(w: QuantizedTensor, x: torch.Tensor,
                     reduce_axis: Optional[str] = None) -> torch.Tensor:
    """``reduce_axis`` (a row-parallel call: K split over that mesh axis)
    makes the A8 per-token activation grid global, its amax all-reduced
    with MAX; the sum of the partial outputs stays in ``dense``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float32)
    if w.act_bits == 8:
        y = ops.w8a8_matmul(x2, w, amax_axis=reduce_axis)
    elif w.act_bits == 0:
        y = (_DequantMatmul.apply(x2, w)
             if torch.is_grad_enabled() and x2.requires_grad
             else ops.dequant_matmul(x2, w))
    else:
        raise NotImplementedError(
            f"act_bits={w.act_bits}: only per-token int8 activations (8) "
            "are ported")
    return y.reshape(*lead, w.n)


def dense(p: dict, x: torch.Tensor, *,
          reduce_axis: Optional[str] = None) -> torch.Tensor:
    """y = x @ w (+ b). x: (..., K) f32 -> (..., N) f32.

    ``reduce_axis`` marks a *row-parallel* call under tensor parallelism:
    the weight's K dim is split over that mesh axis, so the rank's product
    is a partial sum, all-reduced before the bias is added (adding the
    replicated bias on every rank would count it ``tp`` times). Callers
    pass it only when ``cfg.tp > 1``, under the engine's mesh."""
    w = p["w"]
    if isinstance(w, QuantizedTensor):
        y = _dense_quantized(w, x, reduce_axis)
    else:
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    if reduce_axis is not None:
        y = all_reduce(y, reduce_axis)
    if p.get("b") is not None:
        y = y + p["b"]
    return y


def dense_experts(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Batched expert matmul: x (E, C, K) @ w (E, K, N) -> (E, C, N) f32
    (+ b (E, N))."""
    w = p["w"]
    if not isinstance(w, QuantizedTensor):
        y = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    elif w.act_bits == 8:
        y = ops.expert_w8a8_matmul(x, w)
    elif w.act_bits == 0:
        y = (_DequantMatmul.apply(x, w)
             if torch.is_grad_enabled() and x.requires_grad
             else ops.expert_dequant_matmul(x, w))
    else:
        raise NotImplementedError(
            f"act_bits={w.act_bits}: only per-token int8 activations (8) "
            "are ported")
    if p.get("b") is not None:
        y = y + p["b"][:, None, :]
    return y


def materialize(w, dtype=torch.float32) -> torch.Tensor:
    """A linear's weight as a plain ``dtype`` tensor: a packed leaf
    dequantized (f32, no bf16 rounding; no kernel), a float one cast. For
    MLA's absorbed decode, which multiplies by W_ukv's halves directly."""
    if isinstance(w, QuantizedTensor):
        return dequantize(w).to(dtype)
    return w.to(dtype)


def init_dense(gen: torch.Generator, k: int, n: int, device, *,
               bias: bool = False) -> dict:
    std = 1.0 / (k ** 0.5)
    p = {"w": torch.randn((k, n), generator=gen, device=device) * std}
    if bias:
        p["b"] = torch.zeros((n,), dtype=torch.float32, device=device)
    return p


def init_dense_experts(gen: torch.Generator, e: int, k: int, n: int,
                       device) -> dict:
    std = 1.0 / (k ** 0.5)
    return {"w": torch.randn((e, k, n), generator=gen, device=device) * std}
