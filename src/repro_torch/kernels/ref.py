"""Plain PyTorch versions of the port's CUDA kernels.

Port of ``repro.kernels.ref``. The wrappers in ``kernels/ops.py`` run these
for tensors on the CPU; on the card they are what each kernel is held
against (``chip_smoke.py``), never a fallback.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quant.types import (QuantizedTensor, dequantize, pack,
                                          qmax_for_bits, quantize_values,
                                          unpack)

NEG = -1e30


def dequant_matmul_ref(x: torch.Tensor, qw: torch.Tensor,
                       scale: torch.Tensor, *, bits: int, group_size: int,
                       k: int,
                       out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(M, K) f32 or bf16 @ packed (K, N) -> (M, N) ``out_dtype``.

    x and the f32-dequantized weight are each rounded to bf16 *before* the
    product (what the TPU kernel feeds its bf16 matrix unit; a bf16 x is
    already so); products of two bf16 values are exact in f32, so the f32
    matmul of the rounded operands is the kernel's function up to
    summation order. The f32 sum is rounded once to ``out_dtype``."""
    qt = QuantizedTensor(qw, scale, bits, group_size, (k, qw.shape[1]))
    w = dequantize(qt).to(torch.bfloat16).to(torch.float32)
    xb = x.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, w).to(out_dtype)


def expert_dequant_matmul_ref(x: torch.Tensor, qw: torch.Tensor,
                              scale: torch.Tensor, *, bits: int,
                              group_size: int, k: int,
                              out_dtype: torch.dtype = torch.float32
                              ) -> torch.Tensor:
    """Expert-batched ``dequant_matmul_ref``: x (E, C, K) f32 or bf16 @
    packed (E, packed_rows(K), N) with scale (E, G, N) -> (E, C, N)
    ``out_dtype``, both operands rounded to bf16 and the products summed
    in f32."""
    e = x.shape[0]
    qt = QuantizedTensor(qw, scale, bits, group_size, (e, k, qw.shape[-1]))
    w = dequantize(qt).to(torch.bfloat16).to(torch.float32)
    xb = x.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, w).to(out_dtype)


def w8a8_matmul_ref(xq: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
                    *, bits: int, group_size: int, k: int) -> torch.Tensor:
    """Exact-integer W8A8 product (before the per-token activation rescale).
    xq: (M, K) int8; qw: (packed_rows(K), N) uint8; scale: (G, N) f32.
    Returns (M, N) f32.

    Each scale group's sum of int8 x int8 products is taken exactly, in a
    float type every device multiplies: f32 when no partial sum can reach
    2^24 (then every partial sum, in any order, is an integer f32 holds;
    W4 per-channel up to K = 18k), else f64. It is converted to f32 as the
    kernel converts its int32 sum, rescaled by the group's scale and summed
    over groups in f32. (f32 products must be full f32, not TF32:
    ``device.resolve_device`` pins that.)"""
    m = xq.shape[0]
    n = qw.shape[1]
    g = scale.shape[0]
    exact = (torch.float32 if 127 * qmax_for_bits(bits) * (k // g) < 2 ** 24
             else torch.float64)
    q = unpack(qw, bits, k).to(exact)                        # (K, N)
    acc = torch.einsum("mgk,gkn->mgn",
                       xq.to(exact).reshape(m, g, k // g),
                       q.reshape(g, k // g, n))
    return (acc.to(torch.float32) * scale.to(torch.float32)[None]).sum(dim=1)


def expert_w8a8_matmul_ref(xq: torch.Tensor, qw: torch.Tensor,
                           scale: torch.Tensor, *, bits: int,
                           group_size: int, k: int) -> torch.Tensor:
    """Expert-stacked W8A8 product (before the per-token rescale): xq
    (E, C, K) int8 @ packed (E, packed_rows(K), N) with scale (E, G, N) ->
    (E, C, N) f32, one ``w8a8_matmul_ref`` per expert."""
    return torch.stack([
        w8a8_matmul_ref(xq[i], qw[i], scale[i], bits=bits,
                        group_size=group_size, k=k)
        for i in range(xq.shape[0])])


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_table: torch.Tensor,
                        kv_len: torch.Tensor,
                        k_scale_pool: Optional[torch.Tensor] = None,
                        v_scale_pool: Optional[torch.Tensor] = None, *,
                        window: Optional[int] = None,
                        m_rows: int = 1,
                        out_dtype: torch.dtype = torch.float32
                        ) -> torch.Tensor:
    """Page walk with per-page online-softmax updates, batched over slots
    and kv heads (the kernel's page order and f32 accumulation).

    q: (S, KVH, m_rows*G, hd) m-major rows (row r belongs to the token at
    fill position kv_len - m_rows + r//G); pools: (P, page, KVH, hd[_v]),
    int8 with (P, page, KVH) f32 scale pools, or f32 or bf16 without (each
    element upcast to f32 as it is read); block_table:
    (S, W) page ids, -1 = unheld; kv_len: (S,). Dead pages (beyond the
    fill, unheld, wholly behind the window) leave the accumulators
    untouched; an empty slot comes out as exact zeros.
    Returns (S, KVH, m_rows*G, hd_v) ``out_dtype``, one rounding of the f32
    result."""
    s, kvh, rows, hd = q.shape
    if rows % m_rows:
        raise ValueError(f"rows {rows} not a multiple of m_rows {m_rows}")
    g = rows // m_rows
    page_size = k_pool.shape[1]
    hd_v = v_pool.shape[-1]
    sm_scale = 1.0 / math.sqrt(hd)
    dev = q.device
    qf = q.to(torch.float32)
    bt = block_table.to(torch.int64)
    kl = kv_len.to(torch.int64)
    r = torch.arange(rows, device=dev)
    lim = kl[:, None] - (m_rows - 1 - r // g)[None, :]           # (S, R)
    t = torch.arange(page_size, device=dev)
    m = torch.full((s, kvh, rows, 1), NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((s, kvh, rows, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((s, kvh, rows, hd_v), dtype=torch.float32, device=dev)
    for wi in range(bt.shape[1]):
        base = wi * page_size
        live = (base < kl) & (bt[:, wi] >= 0)                      # (S,)
        if window is not None:
            live &= (base + page_size) > (kl - (m_rows - 1) - window)
        page = torch.where(live, bt[:, wi].clamp_min(0), 0)
        kf = k_pool[page].to(torch.float32)            # (S, page, KVH, hd)
        vf = v_pool[page].to(torch.float32)
        if k_scale_pool is not None:
            kf = kf * k_scale_pool[page].to(torch.float32)[..., None]
            vf = vf * v_scale_pool[page].to(torch.float32)[..., None]
        sc = torch.einsum("shrd,sthd->shrt", qf, kf) * sm_scale
        pos = base + t                                              # (page,)
        valid = pos[None, None, :] < lim[:, :, None]               # (S,R,T)
        if window is not None:
            valid &= pos[None, None, :] > (lim[:, :, None] - 1 - window)
        valid = valid[:, None]                                    # (S,1,R,T)
        sc = torch.where(valid, sc, NEG)
        m_new = torch.maximum(m, sc.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(sc - m_new), 0.0)
        l_new = l * corr + p.sum(dim=-1, keepdim=True)
        acc_new = acc * corr + torch.einsum("shrt,sthd->shrd", p, vf)
        keep = live[:, None, None, None]
        m = torch.where(keep, m_new, m)
        l = torch.where(keep, l_new, l)
        acc = torch.where(keep, acc_new, acc)
    return (acc / l.clamp_min(1e-30)).to(out_dtype)


def quantize_pack_ref(w: torch.Tensor, scale: torch.Tensor, *,
                      bits: int) -> torch.Tensor:
    """RTN quantize + pack: w (..., K, N) f32 or bf16 with scale (..., G, N)
    f32 -> uint8 (..., packed_rows(K), N): IEEE f32 quotient, rounded half
    to even, clipped, packed offset-binary along K."""
    q = quantize_values(w.to(torch.float32), scale.to(torch.float32), bits)
    return pack(q, bits)


def channel_stats_ref(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, C) -> (mean (C,), population var (C,)) over T in f32 (f64 for
    f64 input), the variance two-pass (as ``jnp.var``)."""
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    mu = xf.mean(dim=0)
    return mu, torch.square(xf - mu).mean(dim=0)
