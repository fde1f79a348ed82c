"""GPTQ (Frantar et al. 2022): OBS-based row-serial weight reconstruction
with Hessian error compensation (port of ``repro.core.quant.gptq``, 2-D
weights).

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
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.types import (QuantizedTensor, compute_scales,
                                          pack, qmax_for_bits)

BLOCK_ROWS = 128


def hessian_from_inputs(x: torch.Tensor) -> torch.Tensor:
    """x: (..., T, K) calibration inputs for one linear -> H (K, K), f64
    (see the module docstring)."""
    x2 = x.reshape(-1, x.shape[-1]).to(torch.float64)
    return 2.0 * x2.t() @ x2


@torch.no_grad()
def gptq_quantize_array(w: torch.Tensor, h: torch.Tensor, *, bits: int,
                        group_size: int = -1, damp: float = 0.01,
                        actorder: bool = False):
    """Returns (q int32 (K, N) on the symmetric grid, scale (G, N), err)."""
    k, n = w.shape
    dev = w.device
    f64 = torch.float64
    hf = h.to(f64)

    # dead inputs: H diagonal zero -> pin to identity, zero those weight rows
    dead = torch.diagonal(hf) <= 0.0
    hf = hf + torch.diag(dead.to(f64))
    w32 = torch.where(dead[:, None], 0.0, w.to(torch.float32))

    # static group scales from the original weights, in f32 as in JAX
    scale = compute_scales(w32, bits, group_size)                  # (G, N)
    row_scale = scale.repeat_interleave(k // scale.shape[0], dim=0)
    wf = w32.to(f64)

    perm = (torch.argsort(-torch.diagonal(hf), stable=True) if actorder
            else torch.arange(k, device=dev))
    inv_perm = torch.argsort(perm)
    wf = wf[perm]
    row_scale_p = row_scale[perm].to(f64)
    hf = hf[perm][:, perm]
    hf = hf + damp * torch.diagonal(hf).mean() * torch.eye(k, dtype=f64,
                                                           device=dev)

    u = torch.linalg.cholesky(torch.linalg.inv(hf)).t()          # upper
    qmax = qmax_for_bits(bits)
    q = torch.empty((k, n), dtype=f64, device=dev)
    for i1 in range(0, k, BLOCK_ROWS):
        i2 = min(i1 + BLOCK_ROWS, k)
        wb = wf[i1:i2].clone()
        err = torch.empty_like(wb)
        ub = u[i1:i2, i1:i2]
        for i in range(i2 - i1):
            srow = row_scale_p[i1 + i]
            qi = torch.round(wb[i] / srow).clamp_(-qmax, qmax)
            torch.div(wb[i] - qi * srow, ub[i, i], out=err[i])
            wb[i + 1:].addr_(ub[i, i + 1:], err[i], alpha=-1.0)
            q[i1 + i] = qi
        if i2 < k:
            wf[i2:] -= u[i1:i2, i2:].t() @ err
    q = q[inv_perm].to(torch.int32)

    deq = q.to(torch.float32) * row_scale
    return q, scale, torch.mean((deq - w32) ** 2)


def gptq_quantize(w: torch.Tensor, h: torch.Tensor, *, bits: int,
                  group_size: int = -1, damp: float = 0.01,
                  actorder: bool = False, act_bits: int = 0):
    """GPTQ for a (K, N) linear; ``h`` (K, K). Returns (QuantizedTensor,
    mse_err). Stacked expert weights wait for the MoE slice."""
    if w.ndim != 2:
        raise NotImplementedError("GPTQ of stacked (E, K, N) experts is not "
                                  "ported yet")
    q, scale, err = gptq_quantize_array(w, h, bits=bits,
                                        group_size=group_size, damp=damp,
                                        actorder=actorder)
    return QuantizedTensor(pack(q, bits), scale, bits, group_size,
                           tuple(w.shape), act_bits), err
