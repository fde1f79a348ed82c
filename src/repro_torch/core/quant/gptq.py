"""GPTQ (Frantar et al. 2022): OBS-based row-serial weight reconstruction
with Hessian error compensation (port of ``repro.core.quant.gptq``: 2-D
weights and stacked (E, K, N) experts).

Layout: w (K, N) with out = x @ w — rows of K are quantized one by one
(the paper's "columns" of the (N, K) torch layout). H = 2 Σ x xᵀ over the
calibration tokens. Each row's rounding error, divided by the diagonal of
the upper Cholesky factor U of H⁻¹, is pushed onto the rows after it with
weights from U's row. The JAX package applies that push to all later rows
after every row; here it is done in blocks of rows (the paper's lazy batch
update): inside a block row by row, and onto the rows past the block once
per block as one product of U's slab with the block's errors. The two are
the same sum taken in another order, and the block keeps the row loop's
traffic inside a slab that stays in cache.

Precision. The JAX package runs all of it in f32. Here the Hessian, its
inverse and Cholesky factor (through ``torch.linalg``, as the JAX package
leaves them to XLA) and the row loop run in f64; the scales are the JAX
package's f32 ones. The reason is the calibration set: with fewer tokens
than K (the launcher's 256 against llama3.2-1b's 2048 and 8192) the damped
Hessian is ill-conditioned (cond 1e4-1e5 there), an f32 inverse is off by
~1e-4 relative, and GPTQ carries every row's rounding error onto all later
rows (weights |U[i, j] / U[i, i]| up to ~1), so a difference in the last
bits grows through the loop and flips roundings, and each flipped code
moves later values again. In f64 the port agrees with the JAX package
wherever the latter's f32 inverse is accurate (tests/test_torch_gptq.py),
and the card with the CPU on all but ~0.005% of llama3.2-1b's codes, the
first of them two thirds of the way through the rows (PERF.md).

Stacked experts. The JAX package vmaps one GPTQ per expert; here the
experts share the row loop as a leading batch dim, so E experts cost the
row steps of one. An expert's f64 work is its Hessian and Cholesky
factor (2 K^2 doubles; the inverse is taken one expert at a time) beside
its weight-side arrays; at Mixtral's widths that is 0.6 GB (K 6144) to
4.3 GB (K 16384) of Hessian side alone, so ``gptq_quantize_experts``
builds the Hessians from the capacity-buffer inputs and quantizes the
experts in chunks that fit a memory budget: batched where they fit, a
few at a time where they do not.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.types import (QuantizedTensor, compute_scales,
                                          pack, qmax_for_bits)

BLOCK_ROWS = 128
# calibration tokens a Hessian takes in f64 at a time: at the paper's
# 128 x 2048 tokens a whole f64 copy of the MLP-down input (262144 x 8192)
# would be 17 GB
HESSIAN_ROWS = 8192


def hessian_from_inputs(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T, K) calibration inputs for one linear -> H = 2 X^T X
    (K, K), f64 (see the module docstring), summed over chunks of
    HESSIAN_ROWS tokens, always the same chunks for the same shape."""
    x2 = x.reshape(-1, x.shape[-1])
    k = x2.shape[1]
    h = torch.zeros((k, k), dtype=torch.float64, device=x2.device)
    for r0 in range(0, x2.shape[0], HESSIAN_ROWS):
        xc = x2[r0:r0 + HESSIAN_ROWS].to(torch.float64)
        h.addmm_(xc.t(), xc)
    return h.mul_(2.0)


def _expert_bytes(k: int, n: int) -> int:
    """Peak bytes of one expert in ``_gptq``: its f64 Hessian and
    Cholesky factor, and the f64 weight and lazy-update product beside
    the f32 copies (one expert's inverse and factor, 2 K^2 doubles, come
    on top once a chunk)."""
    return 2 * k * k * 8 + 2 * k * n * 8 + 3 * k * n * 4


@torch.no_grad()
def gptq_quantize_array(w: torch.Tensor, h: torch.Tensor, *, bits: int,
                        group_size: int = -1, damp: float = 0.01,
                        actorder: bool = False):
    """One GPTQ per leading index: w (..., K, N), h (..., K, K). Returns
    (q int32 (..., K, N) on the symmetric grid, scale (..., G, N), the
    reconstruction MSE (...))."""
    k = w.shape[-2]
    return _gptq(w, h.reshape(-1, k, k).to(torch.float64, copy=True),
                 bits=bits, group_size=group_size, damp=damp,
                 actorder=actorder)


def _gptq(w: torch.Tensor, hf: torch.Tensor, *, bits: int, group_size: int,
          damp: float, actorder: bool):
    """``gptq_quantize_array`` on (B, K, K) f64 Hessians ``hf``, which it
    overwrites (damping, pinned dead inputs)."""
    lead = w.shape[:-2]
    k, n = w.shape[-2:]
    w = w.reshape(-1, k, n)
    dev = w.device
    f64 = torch.float64

    # dead inputs: H diagonal zero -> pin to identity, zero those weight rows
    diag = torch.diagonal(hf, dim1=-2, dim2=-1)
    dead = diag <= 0.0                                            # (B, K)
    diag.add_(dead.to(f64))
    w32 = torch.where(dead[..., None], 0.0, w.to(torch.float32))

    # static group scales from the original weights, in f32 as in JAX
    scale = torch.stack([compute_scales(wi, bits, group_size)
                         for wi in w32])                         # (B, G, N)
    rows_per_g = k // scale.shape[-2]
    wf = w32.to(f64)

    row_scale_p = None
    if actorder:
        perm = torch.argsort(-torch.diagonal(hf, dim1=-2, dim2=-1), dim=-1,
                             stable=True)
        inv_perm = torch.argsort(perm, dim=-1)
        wf = torch.take_along_dim(wf, perm[..., None], dim=-2)
        row_scale_p = torch.take_along_dim(
            scale.repeat_interleave(rows_per_g, dim=-2), perm[..., None],
            dim=-2).to(f64)
        hf = torch.take_along_dim(hf, perm[..., None], dim=-2)
        hf = torch.take_along_dim(hf, perm[..., None, :], dim=-1)
    scale64 = scale.to(f64)
    diag = torch.diagonal(hf, dim1=-2, dim2=-1)
    diag.add_(damp * diag.mean(dim=-1, keepdim=True))

    # upper Cholesky factor of each inverse, one expert at a time: the
    # batched solvers are meant for small matrices (MAGMA warns at K 6144)
    u = torch.empty_like(hf)
    for b in range(hf.shape[0]):
        u[b] = torch.linalg.cholesky(torch.linalg.inv(hf[b])).t()
    del hf, diag
    qmax = qmax_for_bits(bits)
    q = torch.empty((w.shape[0], k, n), dtype=torch.int8, device=dev)
    for i1 in range(0, k, BLOCK_ROWS):
        i2 = min(i1 + BLOCK_ROWS, k)
        wb = wf[:, i1:i2].clone()
        err = torch.empty_like(wb)
        ub = u[:, i1:i2, i1:i2]
        for i in range(i2 - i1):
            srow = (row_scale_p[:, i1 + i] if actorder
                    else scale64[:, (i1 + i) // rows_per_g])
            qi = torch.round(wb[:, i] / srow).clamp_(-qmax, qmax)
            torch.div(wb[:, i] - qi * srow, ub[:, i, i, None], out=err[:, i])
            # every later row of the block takes its share of the error
            wb[:, i + 1:].baddbmm_(ub[:, i, i + 1:, None], err[:, i, None],
                                   alpha=-1.0)
            q[:, i1 + i] = qi
        if i2 < k:
            wf[:, i2:] -= u[:, i1:i2, i2:].transpose(-1, -2) @ err
    del u, wf, row_scale_p
    if actorder:
        q = torch.take_along_dim(q, inv_perm[..., None], dim=-2)
    q = q.to(torch.int32)

    deq = q.to(torch.float32).reshape(-1, scale.shape[-2], rows_per_g, n)
    deq = (deq * scale[:, :, None, :]).reshape(q.shape)
    err = torch.mean((deq - w32) ** 2, dim=(-2, -1))
    return (q.reshape(*lead, k, n), scale.reshape(*lead, *scale.shape[1:]),
            err.reshape(lead))


def _packed(q: torch.Tensor, scale: torch.Tensor, bits: int,
            group_size: int, shape: tuple, act_bits: int) -> QuantizedTensor:
    return QuantizedTensor(pack(q, bits), scale, bits, group_size,
                           tuple(shape), act_bits)


def gptq_quantize(w: torch.Tensor, h: torch.Tensor, *, bits: int,
                  group_size: int = -1, damp: float = 0.01,
                  actorder: bool = False, act_bits: int = 0):
    """GPTQ for a (K, N) linear; ``h`` (K, K). Returns (QuantizedTensor,
    mse_err). Stacked experts go through ``gptq_quantize_experts``."""
    if w.ndim != 2:
        raise ValueError(f"gptq_quantize takes a (K, N) weight, got "
                         f"{tuple(w.shape)}: use gptq_quantize_experts")
    q, scale, err = gptq_quantize_array(w, h, bits=bits,
                                        group_size=group_size, damp=damp,
                                        actorder=actorder)
    return _packed(q, scale, bits, group_size, w.shape, act_bits), err


def _experts_per_chunk(e: int, k: int, n: int, device) -> int:
    """Experts that go through the row loop together: as many as fit half
    the card's free memory (cudaMemGetInfo's free bytes and what the
    caching allocator holds unused), or 8 GiB on the CPU, at least one."""
    budget = 8 << 30
    if device.type == "cuda":
        free = (torch.cuda.mem_get_info(device)[0]
                + torch.cuda.memory_reserved(device)
                - torch.cuda.memory_allocated(device))
        budget = free // 2
    return max(1, min(e, (budget - 2 * k * k * 8) // _expert_bytes(k, n)))


def gptq_quantize_experts(w: torch.Tensor, x: torch.Tensor, *, bits: int,
                          group_size: int = -1, damp: float = 0.01,
                          actorder: bool = False, act_bits: int = 0):
    """GPTQ for stacked (E, K, N) experts from their (E, C, K)
    capacity-buffer inputs (empty capacity rows are zeros and add nothing
    to a Hessian, as in the JAX package), the experts in chunks that fit
    the memory (``_experts_per_chunk``). Returns (QuantizedTensor, the
    experts' mean mse_err)."""
    e, k, n = w.shape
    chunk = _experts_per_chunk(e, k, n, w.device)
    qs, scales, errs = [], [], []
    for e0 in range(0, e, chunk):
        q, scale, err = _gptq(
            w[e0:e0 + chunk],
            torch.stack([hessian_from_inputs(xi)
                         for xi in x[e0:e0 + chunk]]),
            bits=bits, group_size=group_size, damp=damp, actorder=actorder)
        qs.append(q)
        scales.append(scale)
        errs.append(err)
    qt = _packed(torch.cat(qs), torch.cat(scales), bits, group_size,
                 w.shape, act_bits)
    return qt, torch.cat(errs).mean()
