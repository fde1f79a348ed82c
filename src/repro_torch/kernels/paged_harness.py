"""Cases and oracles of the paged-attention kernel (kernel 2), in one
place (port of ``repro.kernels.paged_harness``).

The builders draw with ``np.random.default_rng(seed)`` in the JAX
package's order, so equal seeds give equal arrays in both packages. The
JAX package's float pools are the draws rounded to bf16, and so are the
port's bf16 pools (``pools="bf16"``); the port's f32 pools are the draws
themselves, so a kernel that rounded f32 K or V on load would miss its
check here. The oracles are written in
PyTorch: gather each slot's pages contiguous, dequantize, and run
``models/attention.py::attention_core`` single-shot with per-row causal
positions. The tuner's paged search (``kernels/autotune.py``),
``chip_smoke.py``'s paged checks and ``tools/paged_sweep.py`` build their
cases here.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.attention import _quant_kv, attention_core


@functools.lru_cache(maxsize=1)
def _pool_draws(seed: int, n_pages: int, ps: int, kvh: int, hd: int):
    """The seed's page order and f32 K and V draws, and the generator's
    state after them. They depend on the pools' geometry only, so cases
    that differ in fills, rows, G or kv_bits share one draw (a window-
    sized pool is seconds of numpy draws)."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, n_pages))
    kf = torch.from_numpy(rng.normal(size=(n_pages, ps, kvh, hd))).float()
    vf = torch.from_numpy(rng.normal(size=(n_pages, ps, kvh, hd))).float()
    return perm, kf, vf, rng.bit_generator.state


def build_paged_case(seed: int, s: int, w: int, ps: int, kvh: int, g: int,
                     hd: int, fills, kv_bits: int, *, pools: str = "f32",
                     device="cuda"):
    """Random pools and block tables with per-slot fills 0..w*ps. Empty
    slots hold no pages (block-table row all -1), like an idle slot.
    ``kv_bits`` 8 gives int8 pools with f32 scale pools, else with
    ``pools`` "f32" f32 pools of the f32 draws, with "bf16" the draws
    rounded to bf16 (the JAX package's pools, bit for bit).
    Returns (q (S, KVH*G, hd) f32, pools dict, block_table (S, W) int32,
    kv_len (S,) int32) on ``device``."""
    dev = resolve_device(device)
    n_pages = 1 + s * w
    perm, kf, vf, state = _pool_draws(seed, n_pages, ps, kvh, hd)
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    bt = np.full((s, w), -1, np.int32)
    nxt = 0
    for si in range(s):
        need = -(-int(fills[si]) // ps)
        bt[si, :need] = perm[nxt:nxt + need]
        nxt += need
    if kv_bits == 8:
        kq, ks = _quant_kv(kf)
        vq, vs = _quant_kv(vf)
        pools = dict(k_pool=kq, v_pool=vq, k_scale_pool=ks, v_scale_pool=vs)
    else:
        if pools not in ("f32", "bf16"):
            raise ValueError(f"no float pool type {pools!r}")
        dt = torch.bfloat16 if pools == "bf16" else torch.float32
        pools = dict(k_pool=kf.to(dt), v_pool=vf.to(dt), k_scale_pool=None,
                     v_scale_pool=None)
    # a copy: callers own their pools, the draws stay cached
    pools = {k: None if v is None else v.to(dev, copy=True)
             for k, v in pools.items()}
    q = torch.from_numpy(rng.normal(size=(s, kvh * g, hd))).float()
    return (q.to(dev), pools, torch.from_numpy(bt).to(dev),
            torch.tensor(np.asarray(fills), dtype=torch.int32, device=dev))


def build_verify_case(seed: int, s: int, m: int, w: int, ps: int, kvh: int,
                      g: int, hd: int, fills, kv_bits: int, *,
                      pools: str = "f32", device="cuda"):
    """The verify-shaped variant: q gets M query rows a slot (row r of slot
    si sits at fill position fills[si] - m + r). Fills must be 0 (an idle
    slot) or >= m. Returns (q (S, M, H, hd), pools, block_table,
    kv_len)."""
    assert all(f == 0 or f >= m for f in fills), fills
    _, pools, bt, kv_len = build_paged_case(seed, s, w, ps, kvh, g, hd,
                                            fills, kv_bits, pools=pools,
                                            device=device)
    rng = np.random.default_rng(seed + 1)
    q = torch.from_numpy(rng.normal(size=(s, m, kvh * g, hd))).float()
    return q.to(bt.device), pools, bt, kv_len


def build_prefill_case(seed: int, s: int, m: int, w: int, ps: int, kvh: int,
                       g: int, hd: int, fills, kv_bits: int, *,
                       pools: str = "f32", device="cuda"):
    """The chunked-prefill variant: q is a left-padded chunk bucket of M
    rows a slot (row j at fill position fills[si] - m + j, as a verify
    row); fills may be smaller than M, and rows at fill limit <= 0 are the
    kernel's exact zeros. Returns (q (S, M, H, hd), pools, block_table,
    kv_len)."""
    _, pools, bt, kv_len = build_paged_case(seed, s, w, ps, kvh, g, hd,
                                            fills, kv_bits, pools=pools,
                                            device=device)
    rng = np.random.default_rng(seed + 2)
    q = torch.from_numpy(rng.normal(size=(s, m, kvh * g, hd))).float()
    return q.to(bt.device), pools, bt, kv_len


def kernel_rows(q: torch.Tensor, kvh: int) -> torch.Tensor:
    """q (S, H, hd) or (S, M, H, hd) -> the kernel's (S, KVH, M*G, hd),
    rows m-major within a kv head (``kernels/ops.py``'s layout)."""
    if q.ndim == 3:
        q = q[:, None]
    s, m, h, hd = q.shape
    g = h // kvh
    q = q.reshape(s, m, kvh, g, hd).permute(0, 2, 1, 3, 4)
    return q.reshape(s, kvh, m * g, hd).contiguous()


def _gathered(pools: dict, bt: torch.Tensor, dtype: torch.dtype):
    """Each slot's pages contiguous and dequantized: (S, W*ps, KVH, hd)."""
    idx = bt.long().clamp_min(0)
    s, w = bt.shape

    def gather(pool, scale_pool):
        x = pool[idx].to(torch.float32)
        if scale_pool is not None:
            x = x * scale_pool[idx].to(torch.float32)[..., None]
        return x.to(dtype).reshape((s, w * pool.shape[1]) + pool.shape[2:])

    return (gather(pools["k_pool"], pools["k_scale_pool"]),
            gather(pools["v_pool"], pools["v_scale_pool"]))


def _contiguous_positions(kv_len: torch.Tensor, width: int) -> torch.Tensor:
    ar = torch.arange(width, dtype=torch.int32, device=kv_len.device)[None]
    return torch.where(ar < kv_len[:, None], ar, -1)


def verify_oracle(q: torch.Tensor, pools: dict, bt: torch.Tensor,
                  kv_len: torch.Tensor,
                  window: Optional[int]) -> torch.Tensor:
    """Gather-based oracle of the multi-row read: dense attention with the
    per-row causal positions kv_len - M + [0..M). Slots with fill < M give
    garbage rows (all-masked softmax); the kernel defines those as exact
    zeros, so compare live slots only."""
    m = q.shape[1]
    kg, vg = _gathered(pools, bt, q.dtype)
    kv_pos = _contiguous_positions(kv_len, kg.shape[1])
    q_pos = (kv_len[:, None] - m
             + torch.arange(m, dtype=torch.int32, device=q.device)[None])
    return attention_core(q, kg, vg, q_pos=q_pos, kv_pos=kv_pos,
                          causal=True, window=window, block_kv=1 << 30)


def prefill_oracle(q: torch.Tensor, pools: dict, bt: torch.Tensor,
                   kv_len: torch.Tensor, window: Optional[int],
                   chunk) -> torch.Tensor:
    """Gather-based oracle of the chunked-prefill read (the verify read's
    math). Rows outside a slot's chunk and empty slots are garbage; compare
    ``prefill_live_rows`` only."""
    del chunk  # masking happens at comparison time
    return verify_oracle(q, pools, bt, kv_len, window)


def prefill_live_rows(kv_len, chunk, m: int) -> np.ndarray:
    """(S, M) bool: the rows the engine consumes, a live slot's rows inside
    its left-padded chunk."""
    kv = np.asarray(torch.as_tensor(kv_len).cpu())
    ch = np.asarray(torch.as_tensor(chunk).cpu())
    j = np.arange(m)[None, :]
    return (kv[:, None] > 0) & (j >= m - ch[:, None])


def gather_oracle(q: torch.Tensor, pools: dict, bt: torch.Tensor,
                  kv_len: torch.Tensor,
                  window: Optional[int]) -> torch.Tensor:
    """The decode read's oracle: gather the pages contiguous, dequantize,
    dense attention of q (S, H, hd) at position kv_len - 1. Empty slots
    give garbage (the kernel's exact zeros)."""
    kg, vg = _gathered(pools, bt, q.dtype)
    kv_pos = _contiguous_positions(kv_len, kg.shape[1])
    o = attention_core(q[:, None], kg, vg, q_pos=(kv_len - 1)[:, None],
                       kv_pos=kv_pos, causal=True, window=window,
                       block_kv=1 << 30)
    return o[:, 0]
