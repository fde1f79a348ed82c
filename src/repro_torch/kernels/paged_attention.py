"""CUDA kernel: paged attention with inline int8-KV dequant
(``csrc/paged_attention.cu``).

Replaces the TPU kernel ``paged_attention_pallas``
(src/repro/kernels/paged_attention.py). The source's header says what
bounds it on the H100 and what the design does about it; its plain
version is ``kernels/ref.py::paged_attention_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import build

launches = 0

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.c_int, ctypes.c_void_p])


def _lib():
    lib = build.load("paged_attention")
    fn = lib.paged_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def paged_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                         v_pool: torch.Tensor, block_table: torch.Tensor,
                         kv_len: torch.Tensor,
                         k_scale_pool: Optional[torch.Tensor] = None,
                         v_scale_pool: Optional[torch.Tensor] = None, *,
                         window: Optional[int] = None,
                         m_rows: int = 1) -> torch.Tensor:
    """q (S, KVH, m_rows*G, hd) f32 m-major; pools (P, page, KVH, hd[_v])
    f32, or int8 with (P, page, KVH) f32 scale pools; block_table (S, W)
    int32; kv_len (S,) int32 -> (S, KVH, m_rows*G, hd_v) f32, on the card.
    Raises on anything the kernel does not take."""
    global launches
    quant = k_scale_pool is not None
    if not q.is_cuda:
        raise ValueError("paged_attention: q must be a CUDA tensor")
    if not (q.dtype == torch.float32 and q.ndim == 4):
        raise ValueError(f"paged_attention: q must be (S, KVH, R, hd) f32, "
                         f"got {tuple(q.shape)} {q.dtype}")
    s, kvh, rows, hd = q.shape
    if m_rows < 1 or rows % m_rows:
        raise ValueError(f"paged_attention: rows {rows} not a multiple of "
                         f"m_rows {m_rows}")
    pool_dtype = torch.int8 if quant else torch.float32
    n_pages, page_size = k_pool.shape[0], k_pool.shape[1]
    hd_v = v_pool.shape[-1]
    if not (k_pool.dtype == pool_dtype and v_pool.dtype == pool_dtype
            and tuple(k_pool.shape) == (n_pages, page_size, kvh, hd)
            and v_pool.ndim == 4
            and tuple(v_pool.shape[:3]) == (n_pages, page_size, kvh)):
        raise ValueError(
            f"paged_attention: pools must be (P, page, {kvh}, hd) "
            f"{pool_dtype} for q {tuple(q.shape)}; got "
            f"{tuple(k_pool.shape)} {k_pool.dtype}, {tuple(v_pool.shape)} "
            f"{v_pool.dtype}")
    tensors = [q, k_pool, v_pool, block_table, kv_len]
    if quant:
        if v_scale_pool is None:
            raise ValueError("paged_attention: int8 pools need both scale "
                             "pools")
        for sp in (k_scale_pool, v_scale_pool):
            if not (sp.dtype == torch.float32
                    and tuple(sp.shape) == (n_pages, page_size, kvh)):
                raise ValueError(
                    f"paged_attention: scale pools must be ({n_pages}, "
                    f"{page_size}, {kvh}) f32, got {tuple(sp.shape)} "
                    f"{sp.dtype}")
        tensors += [k_scale_pool, v_scale_pool]
    if not (block_table.dtype == torch.int32 and block_table.ndim == 2
            and block_table.shape[0] == s and kv_len.dtype == torch.int32
            and tuple(kv_len.shape) == (s,)):
        raise ValueError(
            f"paged_attention: want block_table ({s}, W) and kv_len ({s},) "
            f"int32, got {tuple(block_table.shape)} {block_table.dtype}, "
            f"{tuple(kv_len.shape)} {kv_len.dtype}")
    if not all(t.device == q.device for t in tensors):
        raise ValueError("paged_attention: all operands must be on one "
                         "device")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: operands must be contiguous")
    out = torch.empty((s, kvh, rows, hd_v), dtype=torch.float32,
                      device=q.device)
    if s == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  k_scale_pool.data_ptr() if quant else None,
                  v_scale_pool.data_ptr() if quant else None,
                  block_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                  s, kvh, rows, hd, hd_v, page_size, block_table.shape[1],
                  m_rows, -1 if window is None else int(window),
                  1.0 / math.sqrt(hd), int(quant), stream)
    build.check("paged_attention", code)
    launches += 1
    return out
