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


def bf16_launch_counts() -> dict[str, int]:
    """Launches of the bf16 variants (a bf16 x, bf16 pools) of kernels 1,
    4 and 2 in this process, each also counted in ``launch_counts``."""
    return {"dequant_matmul": _dq.launches_bf16,
            "expert_dequant_matmul": _edq.launches_bf16,
            "paged_attention": _pa.launches_bf16}


def reset_launch_counts() -> None:
    for mod in (_dq, _w8, _pa, _edq, _ew8, _qp, _cs):
        mod.launches = 0
    for mod in (_dq, _pa, _edq):
        mod.launches_bf16 = 0


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


def dequant_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                   out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (M, K) f32 or bf16 @ packed (K, N) -> (M, N) ``out_dtype`` (x's
    by default). The kernel reads x in its own dtype: no cast before it."""
    out_dtype = out_dtype or x.dtype
    x = x.contiguous()
    if x.device.type == "cpu":
        return ref.dequant_matmul_ref(x, qt.qw, qt.scale, bits=qt.bits,
                                      group_size=qt.group_size, k=qt.k,
                                      out_dtype=out_dtype)
    return _dq.dequant_matmul_cuda(x, qt.qw, qt.scale, bits=qt.bits,
                                   group_size=qt.group_size, k=qt.k,
                                   out_dtype=out_dtype)


def w8a8_matmul(x: torch.Tensor, qt: QuantizedTensor,
                amax_axis: Optional[str] = None, *,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """True A8 path: per-token int8 activation quantize, the int8 x int8
    matmul (exact int32 per scale group), per-token rescale in f32. x: (M,
    K) f32 or bf16 -> (M, N) ``out_dtype`` (x's by default). The int8 codes carry no gradient, so gradients reach x
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
    return (y * xs).to(out_dtype or x.dtype)


def expert_dequant_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                          out_dtype: Optional[torch.dtype] = None
                          ) -> torch.Tensor:
    """Expert-batched x: (E, C, K) f32 or bf16 @ packed (E, K, N) -> (E, C,
    N) ``out_dtype`` (x's by default), all experts in one launch; the
    packed stack is read in place, and x in its own dtype."""
    out_dtype = out_dtype or x.dtype
    x = x.contiguous()
    if x.device.type == "cpu":
        return ref.expert_dequant_matmul_ref(
            x, qt.qw, qt.scale, bits=qt.bits, group_size=qt.group_size,
            k=qt.k, out_dtype=out_dtype)
    return _edq.expert_dequant_matmul_cuda(x, qt.qw, qt.scale, bits=qt.bits,
                                           group_size=qt.group_size, k=qt.k,
                                           out_dtype=out_dtype)


def expert_w8a8_matmul(x: torch.Tensor, qt: QuantizedTensor, *,
                       out_dtype: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """Expert-batched true A8 path: per-token int8 quantization over the
    flattened (E*C) rows of the capacity buffer, the int8 x int8 matmul of
    every expert in one launch, per-token rescale in f32. x: (E, C, K) f32
    or bf16 -> (E, C, N) ``out_dtype`` (x's by default). An empty capacity row (amax 0) quantizes to zeros (its
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
    return (y * xs).to(out_dtype or x.dtype)


def _paged_read(qg: torch.Tensor, k_pool, v_pool, block_table, kv_len,
                k_scale_pool, v_scale_pool, window, m_rows,
                out_dtype) -> torch.Tensor:
    out_dtype = out_dtype or qg.dtype
    qg = qg.contiguous()
    if qg.device.type == "cpu":
        return ref.paged_attention_ref(qg, k_pool, v_pool, block_table,
                                       kv_len, k_scale_pool, v_scale_pool,
                                       window=window, m_rows=m_rows,
                                       out_dtype=out_dtype)
    return _pa.paged_attention_cuda(qg, k_pool, v_pool, block_table, kv_len,
                                    k_scale_pool, v_scale_pool,
                                    window=window, m_rows=m_rows,
                                    out_dtype=out_dtype)


def paged_attention(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    kv_len: torch.Tensor, *,
                    k_scale_pool: Optional[torch.Tensor] = None,
                    v_scale_pool: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Decode read: q (S, H, hd) f32 or bf16, one token per slot at fill
    position kv_len - 1, against the slot's block-table pages (f32, bf16 or
    int8 pools, read as they are). Returns (S, H, hd_v) ``out_dtype`` (q's
    by default); a slot with kv_len == 0 gives exact zeros."""
    s, h, hd = q.shape
    kvh = k_pool.shape[2]
    qg = q.reshape(s, kvh, h // kvh, hd)
    o = _paged_read(qg, k_pool, v_pool, block_table, kv_len, k_scale_pool,
                    v_scale_pool, window, 1, out_dtype)
    return o.reshape(s, h, v_pool.shape[-1])


def paged_rows_read(q: torch.Tensor, k_pool: torch.Tensor,
                    v_pool: torch.Tensor, block_table: torch.Tensor,
                    kv_len: torch.Tensor, *,
                    k_scale_pool: Optional[torch.Tensor] = None,
                    v_scale_pool: Optional[torch.Tensor] = None,
                    window: Optional[int] = None,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
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
                    v_scale_pool, window, m, out_dtype)
    hd_v = v_pool.shape[-1]
    o = o.reshape(s, kvh, m, g, hd_v).permute(0, 2, 1, 3, 4)
    return o.reshape(s, m, h, hd_v)


def paged_attention_verify(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           kv_len: torch.Tensor, *,
                           k_scale_pool: Optional[torch.Tensor] = None,
                           v_scale_pool: Optional[torch.Tensor] = None,
                           window: Optional[int] = None,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """The speculative verify read: the M rows are a slot's pending token
    and its M - 1 draft tokens (``paged_rows_read``). M == 1 is the decode
    read."""
    return paged_rows_read(q, k_pool, v_pool, block_table, kv_len,
                           k_scale_pool=k_scale_pool,
                           v_scale_pool=v_scale_pool, window=window,
                           out_dtype=out_dtype)


def paged_attention_prefill(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor, block_table: torch.Tensor,
                            kv_len: torch.Tensor, *,
                            k_scale_pool: Optional[torch.Tensor] = None,
                            v_scale_pool: Optional[torch.Tensor] = None,
                            window: Optional[int] = None,
                            out_dtype: Optional[torch.dtype] = None
                            ) -> torch.Tensor:
    """The chunked or suffix prefill read: the M rows are a slot's
    left-padded prefill chunk, row j at fill position kv_len - M + j
    whatever the chunk's real length (``paged_rows_read``). Earlier
    context (the slot's prior chunks, shared prefix pages) streams through
    the page walk. A pad row whose fill limit is <= 0 reads nothing and
    comes out as exact zeros."""
    return paged_rows_read(q, k_pool, v_pool, block_table, kv_len,
                           k_scale_pool=k_scale_pool,
                           v_scale_pool=v_scale_pool, window=window,
                           out_dtype=out_dtype)
