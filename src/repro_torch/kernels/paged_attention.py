"""CUDA kernel: paged attention over f32, bf16 or int8 pools, the int8
ones dequantized inline (``csrc/paged_attention.cu``).

Replaces the TPU kernel ``paged_attention_pallas``
(src/repro/kernels/paged_attention.py). A launch is one thread-block
cluster per (slot, kv head, chunk of up to 8 query rows): its ``n_split``
blocks split the slot's live pages and merge their partial softmaxes in
rank order through distributed shared memory. ``plan_paged`` picks
``n_split`` from host-known shapes (the tuner, ``kernels/autotune.py``,
hands the wrapper its choice unless a tuned entry is in force);
``geometry`` mirrors the source's shared-memory layout. The source's
header says what bounds it on the H100 and what the design does about
it; its plain version is ``kernels/ref.py::paged_attention_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.packed_operands import MAX_SMEM, SMS

launches = 0
# launches on bf16 pools (also counted in ``launches``)
launches_bf16 = 0

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9 + [ctypes.c_float]
             + [ctypes.c_int] * 4 + [ctypes.c_void_p])

# the pool types: each one's element bytes and its ``kind`` in the source
# (KV_F32, KV_INT8, KV_BF16); a pool type is named by its string
POOLS = {"f32": (4, 0), "int8": (1, 1), "bf16": (2, 2)}
POOL_DTYPES = {"f32": torch.float32, "int8": torch.int8,
               "bf16": torch.bfloat16}
# a head dim is whole 16-byte units of a row: a multiple of this
HD_MULTIPLE = {"f32": 4, "bf16": 8, "int8": 16}


def kv_kind(kv: str) -> str:
    """The pool type ``kv``, checked: "f32", "bf16" or "int8"."""
    if kv not in POOLS:
        raise ValueError(f"paged_attention: no pool type {kv!r}")
    return kv


def pool_kind(k_pool: torch.Tensor, quant: bool) -> str:
    """The pool type of a K pool (int8 when it has scale pools)."""
    if quant:
        return "int8"
    return {torch.float32: "f32", torch.bfloat16: "bf16"}.get(k_pool.dtype,
                                                              "f32")

# the source's geometry (csrc/paged_attention.cu): threads a block (4
# warps, each taking 8 tokens of a tile), tokens a tile, tiles in the
# ring, the cluster's largest size, the widest value row a lane's 4
# columns cover, the merges' scratch (f32 a row)
THREADS = 128
WARPS = 4
TILE_TOKENS = 32
STAGES = 3
MAX_SPLIT = 8
MAX_HDV = 128
RED = 3 * WARPS + 3 + MAX_SPLIT
# the planner: about 3 blocks an SM over the launch, and at least 64
# tokens of table (2 tiles) a split (tools/paged_sweep.py on the H100)
TARGET_BLOCKS = 3 * SMS
MIN_SPLIT_TOKENS = 64


class Geometry(NamedTuple):
    smem: int       # dynamic shared memory, bytes
    rc: int         # rows a block (2, 4, 6 or 8)
    chunks: int     # row chunks (the grid's z)


def _align16(x: int) -> int:
    return -(-x // 16) * 16


def geometry(rows: int, hd: int, hd_v: int, w: int, kv: str) -> Geometry:
    """The source's ``geometry``: shared memory and row chunks of a launch
    (ring of STAGES tiles, q, the warps' probabilities, the merges'
    scratch, the token tables, the block-table row); ``kv`` the pool
    type (``kv_kind``)."""
    kind = kv_kind(kv)
    quant = kind == "int8"
    es = POOLS[kind][0]
    u0 = hd * es // 16
    ksb = 16 * (u0 + (12 - u0 % 8) % 8)
    vsb = hd_v * es
    stage = TILE_TOKENS * (ksb + vsb) + (2 * TILE_TOKENS * 4 if quant
                                         else 0)
    rc = 2 if rows <= 2 else 4 if rows <= 4 else 6 if rows <= 6 else 8
    ring = STAGES * stage
    part = WARPS * rc * hd_v * 4
    smem = (_align16(max(ring, part)) + _align16(rc * hd * 4)
            + TILE_TOKENS * -(-rc // 4) * 4 * 4 + _align16(RED * rc * 4)
            + (STAGES + 1) * TILE_TOKENS * 4 + _align16(4 * w))
    return Geometry(smem, rc, -(-rows // rc))


def plan_paged(s: int, kvh: int, w: int, page_size: int, rows: int,
               hd: int, hd_v: int, kv: str) -> int:
    """Blocks a (slot, kv head, row chunk)'s walk is split over (the
    cluster size): about TARGET_BLOCKS over the launch, at least
    MIN_SPLIT_TOKENS of table a split (a short table stays at 1-2), at
    most MAX_SPLIT. Reads no fill count: only shapes the host knows.
    Raises ValueError on a shape the kernel does not take. ``kv``: the
    pool type (``kv_kind``), whose element size sets the ring's bytes."""
    geo = geometry(rows, hd, hd_v, w, kv)
    if geo.smem > MAX_SMEM or hd_v > MAX_HDV:
        raise ValueError(
            f"paged_attention: hd {hd}/{hd_v} with a {w}-page table needs "
            f"{geo.smem} bytes of shared memory and hd_v <= {MAX_HDV} (at "
            f"most {MAX_SMEM} bytes)")
    n = -(-TARGET_BLOCKS // max(1, s * kvh * geo.chunks))
    return max(1, min(n, MAX_SPLIT, w * page_size // MIN_SPLIT_TOKENS))


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
                         window: Optional[int] = None, m_rows: int = 1,
                         out_dtype: Optional[torch.dtype] = None
                         ) -> torch.Tensor:
    """q (S, KVH, m_rows*G, hd) f32 or bf16, m-major; pools (P, page, KVH,
    hd[_v]) f32 or bf16 (read as they are), or int8 with (P, page, KVH)
    f32 scale pools; block_table (S, W) int32; kv_len (S,) int32 -> (S,
    KVH, m_rows*G, hd_v) in ``out_dtype`` (q's by default), on the card.
    One launch: a cluster of n_split blocks per (slot, kv head, row chunk),
    ``plan_paged``'s unless a tuned entry is in force. Raises on anything
    the kernel does not take."""
    global launches, launches_bf16
    quant = k_scale_pool is not None
    if not q.is_cuda:
        raise ValueError("paged_attention: q must be a CUDA tensor")
    halves = (torch.float32, torch.bfloat16)
    out_dtype = out_dtype or q.dtype
    if not (q.dtype in halves and q.ndim == 4 and out_dtype in halves):
        raise ValueError(f"paged_attention: q must be (S, KVH, R, hd) f32 "
                         f"or bf16 and the output f32 or bf16, got "
                         f"{tuple(q.shape)} {q.dtype} -> {out_dtype}")
    s, kvh, rows, hd = q.shape
    if m_rows < 1 or rows % m_rows:
        raise ValueError(f"paged_attention: rows {rows} not a multiple of "
                         f"m_rows {m_rows}")
    kind = pool_kind(k_pool, quant)
    pool_dtype = POOL_DTYPES[kind]
    n_pages, page_size = k_pool.shape[0], k_pool.shape[1]
    hd_v = v_pool.shape[-1]
    if not (k_pool.dtype == pool_dtype and v_pool.dtype == pool_dtype
            and tuple(k_pool.shape) == (n_pages, page_size, kvh, hd)
            and v_pool.ndim == 4
            and tuple(v_pool.shape[:3]) == (n_pages, page_size, kvh)):
        raise ValueError(
            f"paged_attention: pools must be (P, page, {kvh}, hd) f32, bf16 "
            f"or int8 (with scale pools), both alike, for q "
            f"{tuple(q.shape)}; got {tuple(k_pool.shape)} {k_pool.dtype}, "
            f"{tuple(v_pool.shape)} {v_pool.dtype}")
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
    mult = HD_MULTIPLE[kind]
    if hd % mult or hd_v % mult:
        raise ValueError(f"paged_attention: hd {hd} and hd_v {hd_v} must "
                         f"be multiples of {mult} with {pool_dtype} pools")
    if (k_pool.data_ptr() | v_pool.data_ptr()) % 16:
        raise ValueError("paged_attention: pools must start on 16 bytes")
    out = torch.empty((s, kvh, rows, hd_v), dtype=out_dtype,
                      device=q.device)
    if s == 0:
        return out
    # imported here: the tuner imports this module for its fixed planner
    from repro_torch.kernels import autotune
    n_split = autotune.paged_split(s, kvh, block_table.shape[1], page_size,
                                   rows, hd, hd_v, kind, m_rows=m_rows)
    _launch(q, k_pool, v_pool, block_table, kv_len, k_scale_pool,
            v_scale_pool, out, window, m_rows, n_split)
    launches += 1
    launches_bf16 += kind == "bf16"
    return out


def _launch(q, k_pool, v_pool, block_table, kv_len, k_scale_pool,
            v_scale_pool, out, window, m_rows, n_split) -> None:
    """One launch at a given split, on operands the wrapper checked
    (``tools/paged_sweep.py`` times splits other than the plan's)."""
    s, kvh, rows, hd = q.shape
    quant = k_scale_pool is not None
    kind = POOLS[pool_kind(k_pool, quant)][1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = _lib()(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  k_scale_pool.data_ptr() if quant else None,
                  v_scale_pool.data_ptr() if quant else None,
                  block_table.data_ptr(), kv_len.data_ptr(), out.data_ptr(),
                  s, kvh, rows, hd, v_pool.shape[-1], k_pool.shape[1],
                  block_table.shape[1], m_rows,
                  -1 if window is None else int(window),
                  1.0 / math.sqrt(hd), kind, n_split,
                  int(q.dtype == torch.bfloat16),
                  int(out.dtype == torch.bfloat16), stream)
    build.check("paged_attention", code)
