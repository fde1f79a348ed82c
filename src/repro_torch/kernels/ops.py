"""Public wrappers around the port's kernels.

Port of ``repro.kernels.ops``: the dequant matmul, the W8A8 matmul, their
expert-batched forms, paged attention, the RTN quantize-pack and the
per-channel statistics.
Dispatch is by the device of the tensors: a CPU tensor runs the kernel's
plain PyTorch version (``kernels/ref.py``); a CUDA tensor launches the
hand-written CUDA kernel or raises. There is no fallback from one to the
other.

The wrappers own the layout glue the kernels do not: the GQA reshape of
decode queries to (S, KVH, G, hd) and the m-major row order of multi-row
reads, and the per-token activation quantization of the A8 matmuls. M
(or an expert's capacity C) needs no padding: the matmul kernels mask
ragged edges.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant.types import QuantizedTensor, quantize_activation
from repro_torch.kernels import channel_stats as _cs
from repro_torch.kernels import dequant_matmul as _dq
from repro_torch.kernels import expert_dequant_matmul as _edq
from repro_torch.kernels import expert_w8a8_matmul as _ew8
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import quantize_pack as _qp
from repro_torch.kernels import ref
from repro_torch.kernels import w8a8_matmul as _w8


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel in this process."""
    return {"dequant_matmul": _dq.launches, "w8a8_matmul": _w8.launches,
            "paged_attention": _pa.launches,
            "expert_dequant_matmul": _edq.launches,
            "expert_w8a8_matmul": _ew8.launches,
            "quantize_pack": _qp.launches, "channel_stats": _cs.launches}


def reset_launch_counts() -> None:
    for mod in (_dq, _w8, _pa, _edq, _ew8, _qp, _cs):
        mod.launches = 0


def quantize_pack(w: torch.Tensor, scale: torch.Tensor, *,
                  bits: int) -> torch.Tensor:
    """RTN quantize + pack: w (..., K, N) f32 or bf16 with scale
    (..., G, N) -> uint8 (..., packed_rows(K), N); on the card every
    leading index in one launch."""
    if w.device.type == "cpu":
        return ref.quantize_pack_ref(w, scale, bits=bits)
    return _qp.quantize_pack_cuda(w, scale, bits=bits)


def channel_stats(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """x (T, C) f32 or bf16 -> per-channel (mean, population var) in f32.
    No gradient: ``core/normtweak/losses.py::channel_stats`` gives it one."""
    if x.device.type == "cpu":
        return ref.channel_stats_ref(x)
    return _cs.channel_stats_cuda(x)


def dequant_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """x: (M, K) f32 @ packed (K, N) -> (M, N) f32."""
    x = x.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        return ref.dequant_matmul_ref(x, qt.qw, qt.scale, bits=qt.bits,
                                      group_size=qt.group_size, k=qt.k)
    return _dq.dequant_matmul_cuda(x, qt.qw, qt.scale, bits=qt.bits,
                                   group_size=qt.group_size, k=qt.k)


def w8a8_matmul(x: torch.Tensor, qt: QuantizedTensor,
                amax_axis: Optional[str] = None) -> torch.Tensor:
    """True A8 path: per-token int8 activation quantize, the int8 x int8
    matmul (exact int32 per scale group), per-token rescale. x: (M, K) f32
    -> (M, N) f32. The int8 codes carry no gradient, so gradients reach x
    through the per-token scale only, as in the JAX package. ``amax_axis``
    (a row-parallel linear's K split) makes the token's grid global: its
    amax is all-reduced with MAX over that mesh axis."""
    xq, xs = quantize_activation(x, 8, axis_name=amax_axis)
    if xq.device.type == "cpu":
        y = ref.w8a8_matmul_ref(xq, qt.qw, qt.scale, bits=qt.bits,
                                group_size=qt.group_size, k=qt.k)
    else:
        y = _w8.w8a8_matmul_cuda(xq.contiguous(), qt.qw, qt.scale, bits=qt.bits,
                                 group_size=qt.group_size, k=qt.k)
    return y * xs


def expert_dequant_matmul(x: torch.Tensor,
                          qt: QuantizedTensor) -> torch.Tensor:
    """Expert-batched x: (E, C, K) f32 @ packed (E, K, N) -> (E, C, N) f32,
    all experts in one launch; the packed stack is read in place."""
    x = x.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        return ref.expert_dequant_matmul_ref(
            x, qt.qw, qt.scale, bits=qt.bits, group_size=qt.group_size,
            k=qt.k)
    return _edq.expert_dequant_matmul_cuda(x, qt.qw, qt.scale, bits=qt.bits,
                                           group_size=qt.group_size, k=qt.k)


def expert_w8a8_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """Expert-batched true A8 path: per-token int8 quantization over the
    flattened (E*C) rows of the capacity buffer, the int8 x int8 matmul of
    every expert in one launch, per-token rescale. x: (E, C, K) f32 ->
    (E, C, N) f32. An empty capacity row (amax 0) quantizes to zeros (its
    scale is clamped, never 0) and comes out as zeros."""
    e, c, k = x.shape
    xq, xs = quantize_activation(x.reshape(e * c, k), 8)
    xq, xs = xq.reshape(e, c, k), xs.reshape(e, c, 1)
    if xq.device.type == "cpu":
        y = ref.expert_w8a8_matmul_ref(xq, qt.qw, qt.scale, bits=qt.bits,
                                       group_size=qt.group_size, k=qt.k)
    else:
        y = _ew8.expert_w8a8_matmul_cuda(xq.contiguous(), qt.qw, qt.scale,
                                         bits=qt.bits,
                                         group_size=qt.group_size, k=qt.k)
    return y * xs


def _paged_read(qg: torch.Tensor, k_pool, v_pool, block_table, kv_len,
                k_scale_pool, v_scale_pool, window,
                m_rows) -> torch.Tensor:
    qg = qg.to(torch.float32).contiguous()
    if qg.device.type == "cpu":
        return ref.paged_attention_ref(qg, k_pool, v_pool, block_table,
                                       kv_len, k_scale_pool, v_scale_pool,
                                       window=window, m_rows=m_rows)
    return _pa.paged_attention_cuda(qg, k_pool, v_pool, block_table, kv_len,
                                    k_scale_pool, v_scale_pool,
                                    window=window, m_rows=m_rows)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    kv_len: torch.Tensor, *,
                    k_scale_pool: Optional[torch.Tensor] = None,
                    v_scale_pool: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Decode read: q (S, H, hd), one token per slot at fill position
    kv_len - 1, against the slot's block-table pages. Returns (S, H, hd_v)
    f32; a slot with kv_len == 0 gives exact zeros."""
    s, h, hd = q.shape
    kvh = k_pool.shape[2]
    qg = q.reshape(s, kvh, h // kvh, hd)
    o = _paged_read(qg, k_pool, v_pool, block_table, kv_len, k_scale_pool,
                    v_scale_pool, window, 1)
    return o.reshape(s, h, v_pool.shape[-1])


def paged_rows_read(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    kv_len: torch.Tensor, *,
                    k_scale_pool: Optional[torch.Tensor] = None,
                    v_scale_pool: Optional[torch.Tensor] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """Multi-row read (the verify and chunked-prefill reads): q (S, M, H,
    hd), row m at fill position kv_len - M + m, kv_len counting all M
    tokens. One page walk serves all M rows. Returns (S, M, H, hd_v)."""
    s, m, h, hd = q.shape
    kvh = k_pool.shape[2]
    g = h // kvh
    # rows go m-major within each kv head: (S, KVH, M*G, hd)
    qg = q.reshape(s, m, kvh, g, hd).permute(0, 2, 1, 3, 4)
    qg = qg.reshape(s, kvh, m * g, hd)
    o = _paged_read(qg, k_pool, v_pool, block_table, kv_len, k_scale_pool,
                    v_scale_pool, window, m)
    hd_v = v_pool.shape[-1]
    o = o.reshape(s, kvh, m, g, hd_v).permute(0, 2, 1, 3, 4)
    return o.reshape(s, m, h, hd_v)


def paged_attention_verify(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           k_scale_pool: Optional[torch.Tensor] = None,
                           v_scale_pool: Optional[torch.Tensor] = None,
                           window: Optional[int] = None) -> torch.Tensor:
    """The speculative verify read: the M rows are a slot's pending token
    and its M - 1 draft tokens (``paged_rows_read``). M == 1 is the decode
    read."""
    return paged_rows_read(q, k_pool, v_pool, block_table, kv_len,
                           k_scale_pool=k_scale_pool,
                           v_scale_pool=v_scale_pool, window=window)


def paged_attention_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_table: torch.Tensor,
                            kv_len: torch.Tensor, *,
                            k_scale_pool: Optional[torch.Tensor] = None,
                            v_scale_pool: Optional[torch.Tensor] = None,
                            window: Optional[int] = None) -> torch.Tensor:
    """The chunked or suffix prefill read: the M rows are a slot's
    left-padded prefill chunk, row j at fill position kv_len - M + j
    whatever the chunk's real length (``paged_rows_read``). Earlier
    context (the slot's prior chunks, shared prefix pages) streams through
    the page walk. A pad row whose fill limit is <= 0 reads nothing and
    comes out as exact zeros."""
    return paged_rows_read(q, k_pool, v_pool, block_table, kv_len,
                           k_scale_pool=k_scale_pool,
                           v_scale_pool=v_scale_pool, window=window)
