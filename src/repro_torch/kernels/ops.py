"""Public wrappers around the port's kernels.

Port of ``repro.kernels.ops`` for the two kernels of the serving path.
Dispatch is by the device of the tensors: a CPU tensor runs the kernel's
plain PyTorch version (``kernels/ref.py``); a CUDA tensor launches the
hand-written CUDA kernel or raises. There is no fallback from one to the
other.

The wrappers own the layout glue the kernels do not: the GQA reshape of
decode queries to (S, KVH, G, hd) and the m-major row order of multi-row
reads. M needs no padding (the matmul kernel masks ragged edges).
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.kernels import dequant_matmul as _dq
from repro_torch.kernels import paged_attention as _pa
from repro_torch.kernels import ref


def launch_counts() -> dict[str, int]:
    """Launches of each CUDA kernel in this process."""
    return {"dequant_matmul": _dq.launches, "paged_attention": _pa.launches}


def reset_launch_counts() -> None:
    _dq.launches = 0
    _pa.launches = 0


def dequant_matmul(x: torch.Tensor, qt: QuantizedTensor) -> torch.Tensor:
    """x: (M, K) f32 @ packed (K, N) -> (M, N) f32."""
    x = x.to(torch.float32).contiguous()
    if x.device.type == "cpu":
        return ref.dequant_matmul_ref(x, qt.qw, qt.scale, bits=qt.bits,
                                      group_size=qt.group_size, k=qt.k)
    return _dq.dequant_matmul_cuda(x, qt.qw, qt.scale, bits=qt.bits,
                                   group_size=qt.group_size, k=qt.k)


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
