"""Plain PyTorch versions of the port's CUDA kernels.

Port of ``repro.kernels.ref``. The wrappers in ``kernels/ops.py`` run these
for tensors on the CPU; on the card they are what each kernel is held
against (``chip_smoke.py``), never a fallback.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.quant.types import QuantizedTensor, dequantize

NEG = -1e30


def dequant_matmul_ref(x: torch.Tensor, qw: torch.Tensor,
                       scale: torch.Tensor, *, bits: int, group_size: int,
                       k: int) -> torch.Tensor:
    """(M, K) f32 @ packed (K, N) -> (M, N) f32.

    x and the f32-dequantized weight are each rounded to bf16 *before* the
    product (what the TPU kernel feeds its bf16 matrix unit); products of
    two bf16 values are exact in f32, so the f32 matmul of the rounded
    operands is the kernel's function up to summation order."""
    qt = QuantizedTensor(qw, scale, bits, group_size, (k, qw.shape[1]))
    w = dequantize(qt).to(torch.bfloat16).to(torch.float32)
    xb = x.to(torch.bfloat16).to(torch.float32)
    return torch.matmul(xb, w)


def paged_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_table: torch.Tensor,
                        kv_len: torch.Tensor,
                        k_scale_pool: Optional[torch.Tensor] = None,
                        v_scale_pool: Optional[torch.Tensor] = None, *,
                        window: Optional[int] = None,
                        m_rows: int = 1) -> torch.Tensor:
    """Page walk with per-page online-softmax updates, batched over slots
    and kv heads (the kernel's page order and f32 accumulation).

    q: (S, KVH, m_rows*G, hd) m-major rows (row r belongs to the token at
    fill position kv_len - m_rows + r//G); pools: (P, page, KVH, hd[_v]),
    int8 with (P, page, KVH) f32 scale pools or f32 without; block_table:
    (S, W) page ids, -1 = unheld; kv_len: (S,). Dead pages (beyond the
    fill, unheld, wholly behind the window) leave the accumulators
    untouched; an empty slot comes out as exact zeros.
    Returns (S, KVH, m_rows*G, hd_v) f32."""
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
    return acc / l.clamp_min(1e-30)
