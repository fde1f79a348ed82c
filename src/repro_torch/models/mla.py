"""Multi-head Latent Attention (DeepSeek-V2) with a compressed KV cache
(port of ``repro.models.mla``).

Prefill and the unpaged forward use the non-absorbed form: per-head K/V
are materialized from the latent through ``wukv`` (a packed ``wukv`` runs
the dequant-matmul kernel) into the chunked attention core, with a qk
width of nope + rope and a v width of ``v_head_dim``. Decode uses the
absorbed form: the queries are projected into the latent space and attend
directly to the cached (c_kv, k_pe), the O(r + rope) cache a token. Its
products are plain f32 einsums against ``wukv`` materialized in f32, as in
the JAX package (no kernel there either).

The cache holds c_kv under "k" / "k_pool" (width ``kv_lora_rank``) and
the roped k_pe under "v" / "v_pool" (width ``qk_rope_head_dim``), each
with one "head". Both stay f32 whatever ``cfg.kv_cache_bits`` says: the
JAX package's MLA caches have no int8 form. The latent RMSNorm "kvnorm"
is a tweakable norm of the paper's pipeline. Writes land in place, as in
``models/attention.py``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.sharding import TP_AXIS
from repro_torch.models.attention import (NEG, _cache_write, _core,
                                          _paged_write_decode,
                                          _paged_write_prefill)
from repro_torch.models.config import ModelConfig
from repro_torch.models.linear import dense, init_dense, materialize
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.models.rope import apply_rope
from repro_torch.serve.kvcache import PageSpec


def init_mla(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    pd = dict(dtype=cfg.pdtype)
    return {
        "wq": init_dense(gen, d, h * qk, device, **pd),
        "wdkv": init_dense(gen, d, m.kv_lora_rank + m.qk_rope_head_dim,
                           device, **pd),
        "kvnorm": init_norm(cfg, m.kv_lora_rank, device),
        "wukv": init_dense(gen, m.kv_lora_rank,
                           h * (m.qk_nope_head_dim + m.v_head_dim), device,
                           **pd),
        "wo": init_dense(gen, h * m.v_head_dim, d, device, **pd),
    }


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device, *,
                   n_layers: int) -> dict:
    """Contiguous latent caches for ``n_layers`` stacked MLA blocks: "k"
    (L, B, T, 1, r) c_kv, "v" (L, B, T, 1, rope) k_pe, "pos" and "len" as
    ``init_kv_cache``'s."""
    m = cfg.mla
    lead = (n_layers, batch, max_len)
    dt = dict(dtype=cfg.adtype, device=device)
    return {"k": torch.zeros(lead + (1, m.kv_lora_rank), **dt),
            "v": torch.zeros(lead + (1, m.qk_rope_head_dim), **dt),
            "pos": torch.full(lead, -1, dtype=torch.int32, device=device),
            "len": torch.zeros(lead[:2], dtype=torch.int32, device=device)}


def init_paged_mla_cache(cfg: ModelConfig, spec: PageSpec, device,
                         n_layers: int) -> dict:
    """Page pools for ``n_layers`` stacked MLA blocks: c_kv under "k_pool"
    (L, P, page, 1, r), k_pe under "v_pool" (L, P, page, 1, rope)."""
    m = cfg.mla
    lead = (n_layers, spec.n_pages, spec.page_size, 1)
    dt = dict(dtype=cfg.adtype, device=device)
    return {"k_pool": torch.zeros(lead + (m.kv_lora_rank,), **dt),
            "v_pool": torch.zeros(lead + (m.qk_rope_head_dim,), **dt)}


def _project_latent(cfg: ModelConfig, p: dict, x: torch.Tensor,
                    positions: torch.Tensor):
    """Returns (c_kv normed (B, S, r), k_pe roped (B, S, rope))."""
    m = cfg.mla
    ckv_kpe = dense(p["wdkv"], x)
    c_kv, k_pe = ckv_kpe[..., :m.kv_lora_rank], ckv_kpe[..., m.kv_lora_rank:]
    c_kv = apply_norm(cfg, p["kvnorm"], c_kv)
    k_pe = apply_rope(k_pe[:, :, None, :], positions, theta=cfg.rope_theta,
                      variant="full")[:, :, 0, :]
    return c_kv, k_pe


def _queries(cfg: ModelConfig, p: dict, x: torch.Tensor,
             positions: torch.Tensor):
    """Returns (q_nope (B, S, H, nope), q_pe roped (B, S, H, rope))."""
    m = cfg.mla
    b, s, _ = x.shape
    q = dense(p["wq"], x).reshape(b, s, cfg.n_heads,
                                  m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = apply_rope(q_pe, positions, theta=cfg.rope_theta, variant="full")
    return q_nope, q_pe


def _gather_pages(pool: torch.Tensor, block_table: torch.Tensor):
    """pool (P, page, ...) and block tables (S, maxp) -> each slot's pages
    end to end, (S, maxp * page, ...)."""
    s, mp = block_table.shape
    out = pool[block_table.clamp_min(0).to(torch.int64)]
    return out.reshape((s, mp * pool.shape[1]) + pool.shape[2:])


def _absorbed(cfg: ModelConfig, p: dict, q_nope, q_pe, ckv, kpe, kv_pos,
              positions) -> torch.Tensor:
    """Decode against the latent cache in f32: ckv (B, T, r), kpe (B, T,
    rope), kv_pos (B, T) (-1 = empty). Returns (B, S, H * v) in q's
    dtype."""
    m = cfg.mla
    b, s, h, _ = q_nope.shape
    wukv = materialize(p["wukv"]["w"]).reshape(
        m.kv_lora_rank, h, m.qk_nope_head_dim + m.v_head_dim)
    wuk, wuv = wukv[..., :m.qk_nope_head_dim], wukv[..., m.qk_nope_head_dim:]
    ckv, kpe = ckv.to(torch.float32), kpe.to(torch.float32)
    ql = torch.einsum("bshn,rhn->bshr", q_nope.to(torch.float32), wuk)
    scale = 1.0 / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
    sc = (torch.einsum("bshr,btr->bhst", ql, ckv)
          + torch.einsum("bshp,btp->bhst", q_pe.to(torch.float32),
                         kpe)) * scale
    msk = (kv_pos[:, None, :] >= 0) & (kv_pos[:, None, :]
                                      <= positions[:, :, None])
    sc = torch.where(msk[:, None], sc, NEG)
    probs = torch.softmax(sc, dim=-1)
    ctx = torch.einsum("bhst,btr->bshr", probs, ckv)
    o = torch.einsum("bshr,rhv->bshv", ctx, wuv)
    return o.to(q_nope.dtype).reshape(b, s, h * m.v_head_dim)


def apply_mla(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
              positions: torch.Tensor, cache: Optional[dict] = None,
              paged: Optional[dict] = None, decode: bool = False,
              taps: Optional[dict] = None,
              tap_prefix: str = "") -> torch.Tensor:
    """Returns the block's attention output (B, S, d_model); ``cache`` (a
    layer's pools or contiguous cache) is updated in place. ``decode``
    (``lm_decode``'s calls) takes the absorbed form over the cache, with
    page pools through ``paged``'s block tables; every other call the
    non-absorbed form over the sequence itself. A chunk or suffix that
    reads earlier context from the pages ("kv_len" beside "bt_rows") is
    refused: the non-absorbed form attends to the chunk alone."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    if taps is not None:
        taps[tap_prefix + "wq"] = x
        taps[tap_prefix + "wdkv"] = x
    q_nope, q_pe = _queries(cfg, p, x, positions)
    c_kv, k_pe = _project_latent(cfg, p, x, positions)
    if taps is not None:
        taps[tap_prefix + "wukv"] = c_kv

    ckv4, kpe4 = c_kv[:, :, None, :], k_pe[:, :, None, :]
    if cache is not None and "k_pool" in cache:
        if decode:
            if s != 1 or "block_table" not in paged:
                raise ValueError("paged MLA decode takes one token a slot "
                                 "and the block tables")
            _paged_write_decode(cache, ckv4, kpe4, paged)
        elif "kv_len" in paged:
            raise NotImplementedError(
                "chunked/prefix-shared prefill is not supported for MLA")
        else:
            _paged_write_prefill(cache, ckv4, kpe4, positions,
                                 paged["bt_rows"])
    elif cache is not None:
        _cache_write(cache, ckv4, kpe4, positions)

    if decode:
        if cache is None:
            raise ValueError("MLA decode needs a cache")
        if "k_pool" in cache:
            bt = paged["block_table"]
            ckv_all = _gather_pages(cache["k_pool"], bt)[:, :, 0, :]
            kpe_all = _gather_pages(cache["v_pool"], bt)[:, :, 0, :]
            ar = torch.arange(ckv_all.shape[1], dtype=torch.int32,
                              device=bt.device)[None, :]
            kv_pos = torch.where(ar < paged["kv_len"][:, None], ar, -1)
        else:
            ckv_all = cache["k"][:, :, 0, :]
            kpe_all = cache["v"][:, :, 0, :]
            kv_pos = cache["pos"]
        o = _absorbed(cfg, p, q_nope, q_pe, ckv_all, kpe_all, kv_pos,
                      positions)
    else:
        kv = dense(p["wukv"], c_kv).reshape(
            b, s, h, m.qk_nope_head_dim + m.v_head_dim)
        k_nope, v = kv[..., :m.qk_nope_head_dim], kv[..., m.qk_nope_head_dim:]
        k = torch.cat([k_nope, k_pe[:, :, None, :].expand(
            b, s, h, m.qk_rope_head_dim)], dim=-1)
        q = torch.cat([q_nope, q_pe], dim=-1)
        o = _core(cfg, q, k, v, positions, positions).reshape(
            b, s, h * m.v_head_dim)
    if taps is not None:
        taps[tap_prefix + "wo"] = o
    # serving TP: a rank's heads, so the output projection is row-parallel
    return dense(p["wo"], o, reduce_axis=TP_AXIS if cfg.tp > 1 else None)
