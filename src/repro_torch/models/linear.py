"""Single entry point for every linear layer (port of ``repro.models.linear``).

A linear's params are {"w": W} or {"w": W, "b": b}. W is a float (K, N)
tensor or a packed ``QuantizedTensor``:

  * float tensor                 -> ``torch.matmul`` in the output dtype
    (left to the library, as the JAX package leaves it to XLA);
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

Dtypes follow the JAX package's: the output is ``dtype`` (x's by
default), every product sums in f32 and rounds once to it, and the
kernels read x (f32 or bf16) as it is and write ``dtype`` themselves, so
a bf16 model adds no cast pass around a packed linear.

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

from torch._subclasses.fake_tensor import is_fake

from repro_torch.core.quant.types import QuantizedTensor, dequantize
from repro_torch.distributed.collectives import all_reduce
from repro_torch.kernels import ops


def reads_as_is(*ts: torch.Tensor) -> bool:
    """True where ``matmul_f32`` hands bf16 operands to the product as they
    are: all bf16, on the card (or the dry run's fake tensors, which stand
    for it) and outside autograd."""
    return (all(t.dtype == torch.bfloat16 for t in ts)
            and (ts[0].device.type != "cpu" or is_fake(ts[0]))
            and not (torch.is_grad_enabled()
                     and any(t.requires_grad for t in ts)))


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """a @ b, 2-D or batched over a leading dim, summed in f32 and rounded
    once to ``dtype`` (f32 or bf16): the JAX package's
    ``preferred_element_type``. Two bf16 operands meet in the product as
    they are, which writes ``dtype`` itself: no f32 copy of either, the
    same values, since a bf16 product is exact in f32. That product sums
    in f32 on the card (and stands for the card on the dry run's fake
    tensors) and has no derivative with an f32 output, so on the CPU,
    under autograd and for f32 operands both are read as f32 instead."""
    if reads_as_is(a, b):
        mm = torch.mm if a.ndim == 2 else torch.bmm
        return mm(a, b) if dtype == a.dtype else mm(a, b, out_dtype=dtype)
    f32 = torch.float32
    return torch.matmul(a.to(f32), b.to(f32)).to(dtype)


class _DequantMatmul(torch.autograd.Function):
    """Forward: the dequant-matmul kernel, or for an (E, K, N) expert
    stack the expert-batched one, writing ``out_dtype``; backward: the
    plain f32 product, in x's dtype."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, qt: QuantizedTensor,
                out_dtype: torch.dtype) -> torch.Tensor:
        ctx.qt, ctx.x_dtype = qt, x.dtype
        return _dequant(x, qt, out_dtype)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        w = dequantize(ctx.qt).transpose(-1, -2)
        return (torch.matmul(grad.to(torch.float32), w).to(ctx.x_dtype),
                None, None)


def _out(x: torch.Tensor, dtype: torch.dtype) -> dict:
    """The wrappers' ``out_dtype`` keyword where it is not x's own (their
    default)."""
    return {} if dtype == x.dtype else {"out_dtype": dtype}


def _dequant(x: torch.Tensor, w: QuantizedTensor,
             dtype: torch.dtype) -> torch.Tensor:
    if w.qw.ndim == 3:
        return ops.expert_dequant_matmul(x, w, **_out(x, dtype))
    return ops.dequant_matmul(x, w, **_out(x, dtype))


def _packed(x: torch.Tensor, w: QuantizedTensor, dtype: torch.dtype,
            amax_axis: Optional[str] = None) -> torch.Tensor:
    """A packed linear's product in ``dtype``: the W8A8 kernels for
    act_bits 8, else the dequant-matmul kernels, on x as it is (a 2-D x
    and (K, N) weight, or the (E, C, K) buffer and (E, K, N) experts)."""
    if w.act_bits == 8:
        if w.qw.ndim == 3:
            return ops.expert_w8a8_matmul(x, w, **_out(x, dtype))
        return ops.w8a8_matmul(x, w, amax_axis=amax_axis, **_out(x, dtype))
    if w.act_bits:
        raise NotImplementedError(
            f"act_bits={w.act_bits}: only per-token int8 activations (8) "
            "are ported")
    if torch.is_grad_enabled() and x.requires_grad:
        return _DequantMatmul.apply(x, w, dtype)
    return _dequant(x, w, dtype)


def _plain(x: torch.Tensor, w: torch.Tensor,
           dtype: torch.dtype) -> torch.Tensor:
    """A float linear in ``dtype``: both operands cast to it, the
    library's product (its sums in f32), one rounding to ``dtype``."""
    return torch.matmul(x.to(dtype), w.to(dtype))


def dense(p: dict, x: torch.Tensor, *, dtype: Optional[torch.dtype] = None,
          reduce_axis: Optional[str] = None) -> torch.Tensor:
    """y = x @ w (+ b). x: (..., K) -> (..., N) in ``dtype`` (x's by
    default), as the JAX package's ``dense``: the sums in f32, rounded
    once.

    ``reduce_axis`` marks a *row-parallel* call under tensor parallelism:
    the weight's K dim is split over that mesh axis, so the rank's product
    is a partial sum, all-reduced before the bias is added (adding the
    replicated bias on every rank would count it ``tp`` times). Callers
    pass it only when ``cfg.tp > 1``, under the engine's mesh. The A8
    per-token activation grid is then global, its amax all-reduced with
    MAX over that axis."""
    w = p["w"]
    dtype = dtype or x.dtype
    if isinstance(w, QuantizedTensor):
        lead = x.shape[:-1]
        y = _packed(x.reshape(-1, x.shape[-1]), w, dtype,
                    reduce_axis).reshape(*lead, w.n)
    else:
        y = _plain(x, w, dtype)
    if reduce_axis is not None:
        y = all_reduce(y, reduce_axis)
    if p.get("b") is not None:
        y = y + p["b"].to(dtype)
    return y


def dense_experts(p: dict, x: torch.Tensor, *,
                  dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Batched expert matmul: x (E, C, K) @ w (E, K, N) -> (E, C, N) in
    ``dtype`` (x's by default) (+ b (E, N))."""
    w = p["w"]
    dtype = dtype or x.dtype
    if isinstance(w, QuantizedTensor):
        y = _packed(x, w, dtype)
    else:
        y = _plain(x, w, dtype)
    if p.get("b") is not None:
        y = y + p["b"][:, None, :].to(dtype)
    return y


def materialize(w, dtype=torch.float32) -> torch.Tensor:
    """A linear's weight as a plain ``dtype`` tensor: a packed leaf
    dequantized (f32, no bf16 rounding; no kernel), a float one cast. For
    MLA's absorbed decode, which multiplies by W_ukv's halves directly."""
    if isinstance(w, QuantizedTensor):
        return dequantize(w).to(dtype)
    return w.to(dtype)


def init_dense(gen: torch.Generator, k: int, n: int, device, *,
               bias: bool = False,
               dtype: torch.dtype = torch.float32) -> dict:
    """N(0, 1/K) weights drawn in f32, then cast to ``dtype`` (the
    config's ``pdtype``); zero biases."""
    std = 1.0 / (k ** 0.5)
    p = {"w": (torch.randn((k, n), generator=gen, device=device)
               * std).to(dtype)}
    if bias:
        p["b"] = torch.zeros((n,), dtype=dtype, device=device)
    return p


def init_dense_experts(gen: torch.Generator, e: int, k: int, n: int,
                       device, *, dtype: torch.dtype = torch.float32) -> dict:
    std = 1.0 / (k ** 0.5)
    return {"w": (torch.randn((e, k, n), generator=gen, device=device)
                  * std).to(dtype)}
