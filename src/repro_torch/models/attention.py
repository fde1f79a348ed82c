"""GQA attention with a paged KV cache (port of ``repro.models.attention``).

Three calls reach ``apply_attention`` in this slice:

  * no cache (``lm_forward``): causal self-attention over the sequence;
  * fresh-prompt prefill (``paged`` holds "bt_rows"): the left-padded
    prompts' K/V are scattered into their slots' pages, and the prompt
    attends to itself (pad rows carry position -1, masked everywhere);
  * fused decode (``paged`` holds "block_table", one token per slot): the
    new token's K/V are scattered first, then the paged-attention kernel
    walks each slot's block table with kv_len = fill + 1.

Page pools are f32 ``(P, page, KVH, hd)`` tensors, or int8 with
``(P, page, KVH)`` f32 scale pools when ``cfg.kv_cache_bits == 8``. The
scatters write the pools IN PLACE (``index_put_``) — the JAX package
returns new arrays instead; the engine hands each layer a view into the
stacked pools, so the writes land in the engine's cache. RoPE is applied
before cache insertion (post-rope keys are cached).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.config import ModelConfig
from repro_torch.models.linear import dense, init_dense
from repro_torch.models.rope import apply_rope
from repro_torch.serve.kvcache import PageSpec, prefill_page_index

NEG = -1e30


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
          window: Optional[int]) -> torch.Tensor:
    """Causal mask. q_pos: (B, Sq); kv_pos: (B, Skv) absolute positions,
    -1 = invalid. Returns (B, Sq, Skv) bool."""
    m = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        m &= kv_pos[:, None, :] > (q_pos[:, :, None] - window)
    return m


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   window: Optional[int] = None) -> torch.Tensor:
    """Single-shot causal GQA attention in f32.
    q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd). Returns (B, Sq, H, hd)."""
    b, sq, h, hd = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    s = torch.einsum("bqkgh,btkh->bkgqt", qg, k) * (1.0 / math.sqrt(hd))
    m = _mask(q_pos, kv_pos, window=window)
    s = torch.where(m[:, None, None], s, NEG)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqt,btkh->bqkgh", p, v)
    return o.reshape(b, sq, h, v.shape[-1])


def init_attention(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return {"wq": init_dense(gen, d, h * hd, device),
            "wk": init_dense(gen, d, kvh * hd, device),
            "wv": init_dense(gen, d, kvh * hd, device),
            "wo": init_dense(gen, h * hd, d, device)}


def init_paged_kv_cache(cfg: ModelConfig, spec: PageSpec, device,
                        n_layers: int) -> dict:
    """Page pools for ``n_layers`` stacked attention blocks (leading layer
    dim; each layer reads and writes its own view)."""
    shape = (n_layers, spec.n_pages, spec.page_size, cfg.n_kv_heads, cfg.hd)
    if cfg.kv_cache_bits == 8:
        return {
            "k_pool": torch.zeros(shape, dtype=torch.int8, device=device),
            "v_pool": torch.zeros(shape, dtype=torch.int8, device=device),
            "k_scale_pool": torch.zeros(shape[:-1], dtype=torch.float32,
                                        device=device),
            "v_scale_pool": torch.zeros(shape[:-1], dtype=torch.float32,
                                        device=device),
        }
    return {"k_pool": torch.zeros(shape, dtype=torch.float32, device=device),
            "v_pool": torch.zeros(shape, dtype=torch.float32, device=device)}


def _quant_kv(x: torch.Tensor):
    """x: (..., hd) -> (int8 values, (...) f32 per-(token, head) scales)."""
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1).clamp_min(1e-6) / 127.0
    q = torch.round(xf / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def _write_pools(cache: dict, idx: tuple, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """In-place scatter of K/V (quantized first for int8 pools) at
    ``idx`` = (pages, offsets)."""
    if "k_scale_pool" in cache:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        cache["k_pool"].index_put_(idx, kq)
        cache["v_pool"].index_put_(idx, vq)
        cache["k_scale_pool"].index_put_(idx, ks)
        cache["v_scale_pool"].index_put_(idx, vs)
    else:
        cache["k_pool"].index_put_(idx, k.to(torch.float32))
        cache["v_pool"].index_put_(idx, v.to(torch.float32))


def _paged_write_prefill(cache: dict, k, v, positions, bt) -> None:
    """Scatter a (B, S) batch of tokens at their block-table page slots;
    negative positions route to the scratch page."""
    pages, offs = prefill_page_index(bt, positions, cache["k_pool"].shape[1])
    _write_pools(cache, (pages, offs), k, v)


def _paged_write_decode(cache: dict, k, v, paged: dict) -> None:
    """Scatter one decode token per slot at (write_page, write_off)."""
    idx = (paged["write_page"].to(torch.int64),
           paged["write_off"].to(torch.int64))
    _write_pools(cache, idx, k[:, 0], v[:, 0])


def apply_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                    positions: torch.Tensor, cache: Optional[dict] = None,
                    paged: Optional[dict] = None) -> torch.Tensor:
    """Returns the block's attention output (B, S, d_model); ``cache`` (a
    layer's pools) is updated in place."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    window = cfg.attn_window
    q = dense(p["wq"], x).reshape(b, s, h, hd)
    q = apply_rope(q, positions, theta=cfg.rope_theta)
    k = dense(p["wk"], x).reshape(b, s, kvh, hd)
    v = dense(p["wv"], x).reshape(b, s, kvh, hd)
    k = apply_rope(k, positions, theta=cfg.rope_theta)
    if cache is None:
        o = attention_core(q, k, v, q_pos=positions, kv_pos=positions,
                           window=window)
    elif "block_table" in paged:
        if s != 1:
            raise ValueError("paged decode takes one token per slot")
        _paged_write_decode(cache, k, v, paged)
        o = ops.paged_attention(
            q[:, 0], cache["k_pool"], cache["v_pool"], paged["block_table"],
            paged["kv_len"], k_scale_pool=cache.get("k_scale_pool"),
            v_scale_pool=cache.get("v_scale_pool"), window=window)[:, None]
    elif "bt_rows" in paged:
        # fresh full prompt: write the pages, self-attend to the prompt
        _paged_write_prefill(cache, k, v, positions, paged["bt_rows"])
        o = attention_core(q, k, v, q_pos=positions, kv_pos=positions,
                           window=window)
    else:
        raise ValueError("a paged cache needs 'block_table' (decode) or "
                         "'bt_rows' (prefill) indices")
    return dense(p["wo"], o.reshape(b, s, h * hd))
