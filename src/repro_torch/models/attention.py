"""GQA attention with a paged KV cache, and an enc-dec decoder's
cross-attention (port of ``repro.models.attention``).

Five calls reach ``apply_attention``:

  * no cache (``lm_forward``, the quantization pipeline, whisper's
    ``encode`` with ``causal=False``): self-attention over the sequence;
    ``taps`` then captures each linear's input for calibration;
  * contiguous cache (``init_kv_cache``: the calibration generator's
    decode): the new K/V are written at ring slots ``position % size``,
    then a one-token query attends over the whole cache, masked by the
    cached positions;
  * fresh-prompt prefill (``paged`` holds "bt_rows"): the left-padded
    prompts' K/V are scattered into their slots' pages, and the prompt
    attends to itself (pad rows carry position -1, masked everywhere);
  * fused decode (``paged`` holds "block_table", one token per slot): the
    new token's K/V are scattered first, then the paged-attention kernel
    walks each slot's block table with kv_len = fill + 1;
  * fused multi-row read (``paged`` holds "bt_rows" and "kv_len"): a later
    prefill chunk, a suffix after shared prefix pages, or with "verify"
    the speculative verify rows. The S rows are scattered first, then the
    paged-attention kernel reads all of them in one page walk, row j at
    fill position kv_len - S + j.

``apply_cross_attention`` is the decoder's read of the encoder output:
no RoPE, non-causal, its own cross cache ("k", "v", "pos") filled at
prefill and read as it is at decode.

Page pools are ``(P, page, KVH, hd)`` tensors in ``cfg.adtype`` (f32 or
bf16; the paged-attention kernel reads either as it is), or int8 with
``(P, page, KVH)`` f32 scale pools when ``cfg.kv_cache_bits == 8``. The
scatters write the pools (and the contiguous and cross caches) IN PLACE
(``index_put_``, ``copy_``) — the JAX package returns new arrays instead;
the engine hands each layer a view into the stacked pools, so the writes
land in the engine's cache. RoPE (full, half or none, ``cfg.rope``) is
applied before cache insertion (post-rope keys are cached).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import TP_AXIS
from repro_torch.kernels import ops
from repro_torch.models.config import DTYPES, ModelConfig
from repro_torch.models.linear import (dense, init_dense, matmul_f32,
                                       reads_as_is)
from repro_torch.models.rope import apply_rope
from repro_torch.serve.kvcache import PageSpec, prefill_page_index

NEG = -1e30


def _mask(q_pos: torch.Tensor, kv_pos: torch.Tensor, *, causal: bool,
          window: Optional[int]) -> torch.Tensor:
    """q_pos: (B, Sq); kv_pos: (B, Skv) absolute positions, -1 = invalid.
    Returns (B, Sq, Skv) bool: every valid key, or with ``causal`` those at
    or before the query's position."""
    m = kv_pos[:, None, :] >= 0
    if causal:
        m = m & (kv_pos[:, None, :] <= q_pos[:, :, None])
    if window is not None:
        m = m & (kv_pos[:, None, :] > (q_pos[:, :, None] - window))
    return m.expand(q_pos.shape[0], q_pos.shape[1], kv_pos.shape[1])


def _head_groups(qg: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """The two products' operands, a group of h kv heads at a time: (h, q
    (B*h, G*Sq, hd), K^T (B*h, hd, T), V (B*h, T, hd_v)); qg (B, Sq, KVH,
    G, hd). A one-row query whose bf16 operands ``matmul_f32`` reads as
    they are (a decode on the card) takes one head a group, K and V
    strided views of the cache: no copy of it, whose bytes would be most
    of the products' traffic (a batched product reads either layout).
    Otherwise all heads go in one group, one product each, and the
    reshape copies K and V into the group layout (in their own dtype):
    beside a multi-row query's products, or the f32 copies the CPU and
    autograd read anyway, one copy is small, where a product a head would
    multiply the launches."""
    b, sq, kvh, g, hd = qg.shape
    qh = qg.permute(0, 2, 3, 1, 4)                       # (B, KVH, G, Sq, hd)
    kt = k.permute(0, 2, 3, 1)                           # (B, KVH, hd, T)
    vh = v.permute(0, 2, 1, 3)                           # (B, KVH, T, hd_v)
    h = 1 if sq == 1 and reads_as_is(qg, k, v) else kvh
    for j in range(0, kvh, h):
        yield (h, qh[:, j:j + h].reshape(b * h, g * sq, hd),
               kt[:, j:j + h].reshape(b * h, hd, -1),
               vh[:, j:j + h].reshape(b * h, -1, v.shape[-1]))


def _single_shot(qg, k, v, *, q_pos, kv_pos, causal, window, scale):
    """Masked softmax over all of K at once, a group of kv heads at a time
    (``_head_groups``). qg: (B, Sq, KVH, G, hd). The scores are f32 sums
    of the operands' products (``matmul_f32``), the probabilities are
    rounded to V's dtype before the f32 sum over V. Returns (B, Sq, KVH,
    G, hd_v) f32."""
    b, sq, kvh, g, _ = qg.shape
    m = _mask(q_pos, kv_pos, causal=causal, window=window)[:, None, None]
    outs = []
    for h, qj, ktj, vj in _head_groups(qg, k, v):
        s = matmul_f32(qj, ktj).view(b, h, g, sq, -1) * scale
        p = torch.softmax(torch.where(m, s, NEG), dim=-1).to(v.dtype)
        outs.append(matmul_f32(p.view(b * h, g * sq, -1), vj).view(
            b, h, g, sq, -1))
    return torch.cat(outs, dim=1).permute(0, 3, 1, 2, 4)


def _kv_block(qj, ktb, vb, pb, m_run, l_run, acc, *, q_pos, causal, window,
              scale, scores_dtype):
    """One KV block of a head group's online softmax: the carries (m, l,
    acc), (B, h, G, Sq[, hd_v]), after block (ktb, vb, pb), all f32. The scores are f32 sums
    (``matmul_f32``) rounded once to ``scores_dtype``, the JAX package's
    ``preferred_element_type=scores_dtype``, and the probabilities meet V
    in it; the max, the sum and the accumulator stay f32. A masked score
    is the finite NEG, so a row with no live key yet takes exp(0) = 1 from
    each of them; the first live block's correction exp(NEG - m) wipes
    those out."""
    b, h, g, sq = m_run.shape
    msk = _mask(q_pos, pb, causal=causal, window=window)[:, None, None]
    s = matmul_f32(qj, ktb, scores_dtype).view(b, h, g, sq, -1)
    s = torch.where(msk, s.to(torch.float32) * scale, NEG)
    m_new = torch.maximum(m_run, s.amax(dim=-1))
    corr = torch.exp(m_run - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l_run * corr + p.sum(dim=-1)
    pv = matmul_f32(p.to(scores_dtype).view(b * h, g * sq, -1), vb)
    return m_new, l_new, acc * corr[..., None] + pv.view(b, h, g, sq, -1)


def _chunked(qg, k, v, *, q_pos, kv_pos, causal, window, scale, block_kv,
             scores_dtype):
    """Online softmax over KV blocks of ``block_kv`` (K padded with dead
    slots, position -1, to whole blocks), a group of kv heads at a time
    (``_head_groups``). Under autograd each block runs checkpointed: the
    backward pass recomputes its scores from the saved carries, so only
    O(Sq * hd) carries per block are kept, never the (B, h, G, Sq,
    block_kv) scores (the JAX package's ``jax.checkpoint(body,
    nothing_saveable)``). Returns (B, Sq, KVH, G, hd_v) f32."""
    b, sq, kvh, g, _ = qg.shape
    skv = k.shape[1]
    pad = (-skv) % block_kv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
        kv_pos = torch.nn.functional.pad(kv_pos, (0, pad), value=-1)
    dev = qg.device
    kw = dict(q_pos=q_pos, causal=causal, window=window, scale=scale,
              scores_dtype=scores_dtype)
    outs = []
    for h, qj, ktj, vj in _head_groups(qg, k, v):
        m = torch.full((b, h, g, sq), NEG, dtype=torch.float32, device=dev)
        l = torch.zeros((b, h, g, sq), dtype=torch.float32, device=dev)
        acc = torch.zeros((b, h, g, sq, v.shape[-1]), dtype=torch.float32,
                          device=dev)
        for t0 in range(0, skv + pad, block_kv):
            blk = (qj, ktj[:, :, t0:t0 + block_kv], vj[:, t0:t0 + block_kv],
                   kv_pos[:, t0:t0 + block_kv], m, l, acc)
            if torch.is_grad_enabled():
                m, l, acc = checkpoint(_kv_block, *blk, use_reentrant=False,
                                       **kw)
            else:
                m, l, acc = _kv_block(*blk, **kw)
        outs.append(acc / l.clamp_min(1e-30)[..., None])
    return torch.cat(outs, dim=1).permute(0, 3, 1, 2, 4)


def banded_attention(q, k, v, *, q_pos, kv_pos, window: int,
                     block_q: int = 1024) -> torch.Tensor:
    """Sliding-window self-attention over the live band only: q in blocks
    of ``block_q``, each attending a (window + block_q)-wide key slice, so
    O(S * window) work instead of O(S^2). Needs Sq == Skv (aligned self
    positions). Keys get ``window`` dead slots (position -1) in front so
    every slice is in bounds; q is padded to whole blocks."""
    b, s, h, hd = q.shape
    bq = min(block_q, s)
    pad_q = (-s) % bq
    w = window
    if pad_q:
        q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, pad_q))
        q_pos = torch.nn.functional.pad(q_pos, (0, pad_q), value=-1)
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, w, 0))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, w, 0))
    pp = torch.nn.functional.pad(kv_pos, (w, 0), value=-1)
    outs = []
    for i in range(0, s + pad_q, bq):
        outs.append(attention_core(
            q[:, i:i + bq], kp[:, i:i + w + bq], vp[:, i:i + w + bq],
            q_pos=q_pos[:, i:i + bq], kv_pos=pp[:, i:i + w + bq],
            causal=True, window=w, block_kv=w + bq))
    return torch.cat(outs, dim=1)[:, :s]


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   q_pos: torch.Tensor, kv_pos: torch.Tensor,
                   causal: bool = True, window: Optional[int] = None,
                   block_kv: int = 512, banded: bool = False,
                   chunked_decode: bool = False,
                   scores_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """GQA attention, causal unless ``causal`` is False (whisper's encoder
    and cross-attention), as the JAX package's ``attention_core``:
    ``banded`` (a causal windowed self-attention longer than twice the
    window) takes ``banded_attention``; else single-shot where K fits one
    block (Skv <= block_kv) or for a decode query (Sq 1, unless
    ``chunked_decode``), else the chunked online softmax with scores in
    ``scores_dtype``. Sums and the softmax are f32; the output is q's
    dtype. q: (B, Sq, H, hd); k, v: (B, Skv, KVH, hd). Returns (B, Sq, H,
    hd_v)."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    if (banded and causal and window is not None and sq == skv
            and sq > 2 * window):
        return banded_attention(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                                window=window,
                                block_q=max(256, min(1024, window)))
    qg = q.reshape(b, sq, kvh, h // kvh, hd)
    kw = dict(q_pos=q_pos, kv_pos=kv_pos, causal=causal, window=window,
              scale=1.0 / math.sqrt(hd))
    if skv <= block_kv or (sq == 1 and not chunked_decode):
        o = _single_shot(qg, k, v, **kw)
    else:
        o = _chunked(qg, k, v, block_kv=block_kv, scores_dtype=scores_dtype,
                     **kw)
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def _core(cfg: ModelConfig, q, k, v, q_pos, kv_pos, *, causal=True,
          cross: bool = False) -> torch.Tensor:
    """``attention_core`` with the config's window (none for
    cross-attention), its KV block and its three core options
    (``banded_window_attn``, ``chunked_decode``, ``attn_scores_dtype``),
    as the JAX package's ``apply_attention`` passes them."""
    return attention_core(q, k, v, q_pos=q_pos, kv_pos=kv_pos,
                          causal=causal,
                          window=None if cross else cfg.attn_window,
                          block_kv=cfg.attn_block_kv,
                          banded=cfg.banded_window_attn,
                          chunked_decode=cfg.chunked_decode,
                          scores_dtype=DTYPES[cfg.attn_scores_dtype])


def init_attention(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    d, h, kvh, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    qkv = dict(bias=cfg.qkv_bias, dtype=cfg.pdtype)
    return {"wq": init_dense(gen, d, h * hd, device, **qkv),
            "wk": init_dense(gen, d, kvh * hd, device, **qkv),
            "wv": init_dense(gen, d, kvh * hd, device, **qkv),
            "wo": init_dense(gen, h * hd, d, device, bias=cfg.o_bias,
                             dtype=cfg.pdtype)}


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
    return {"k_pool": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v_pool": torch.zeros(shape, dtype=cfg.adtype, device=device)}


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device, *,
                  n_layers: int, window: Optional[int] = None) -> dict:
    """Contiguous caches for ``n_layers`` stacked attention blocks:
    "k"/"v" (L, B, size, KVH, hd) (int8 with "k_scale"/"v_scale" when
    ``cfg.kv_cache_bits == 8``), "pos" (L, B, size) absolute positions (-1
    = empty) and "len" (L, B) fill counts. A sliding window caps the size
    (a ring buffer)."""
    size = min(max_len, window) if window else max_len
    shape = (n_layers, batch, size, cfg.n_kv_heads, cfg.hd)
    cache = {"pos": torch.full(shape[:3], -1, dtype=torch.int32,
                               device=device),
             "len": torch.zeros(shape[:2], dtype=torch.int32,
                                device=device)}
    if cfg.kv_cache_bits == 8:
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=torch.int8, device=device)
            cache[name + "_scale"] = torch.zeros(
                shape[:-1], dtype=torch.float32, device=device)
    else:
        for name in ("k", "v"):
            cache[name] = torch.zeros(shape, dtype=cfg.adtype, device=device)
    return cache


def init_cross_cache(cfg: ModelConfig, batch: int, enc_len: int, device, *,
                     n_layers: int) -> dict:
    """Cross-attention caches for ``n_layers`` stacked decoder blocks of an
    enc-dec model: "k"/"v" (L, B, enc_len, KVH, hd) in ``cfg.adtype`` and "pos" (L, B,
    enc_len) (-1 = empty), filled once from the encoder output at prefill
    (``apply_cross_attention``)."""
    shape = (n_layers, batch, enc_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.adtype, device=device),
            "pos": torch.full(shape[:3], -1, dtype=torch.int32,
                              device=device)}


def _cross_fill(cache: dict, k, v, positions) -> None:
    """In-place write of the encoder output's K/V and positions into a
    cross cache of the same (B, enc_len) (the JAX package replaces the
    cache's arrays with them)."""
    if tuple(k.shape) != tuple(cache["k"].shape):
        raise ValueError(f"cross cache of {tuple(cache['k'].shape)} cannot "
                         f"hold K/V of {tuple(k.shape)}: init the cache "
                         f"with the encoder's length")
    cache["k"].copy_(k)
    cache["v"].copy_(v)
    cache["pos"].copy_(positions)


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
        cache["k_pool"].index_put_(idx, k.to(cache["k_pool"].dtype))
        cache["v_pool"].index_put_(idx, v.to(cache["v_pool"].dtype))


def _cache_write(cache: dict, k, v, positions) -> None:
    """In-place write of S new entries at ring slots ``positions % size``
    (only the last ``size`` when S exceeds the ring: older ones could never
    be attended to)."""
    b, s = positions.shape
    size = cache["k"].shape[1]
    if s > size:
        k, v, positions = k[:, -size:], v[:, -size:], positions[:, -size:]
        s = size
    slots = (positions % size).to(torch.int64)
    bidx = torch.arange(b, device=slots.device)[:, None].expand(b, s)
    if "k_scale" in cache:
        kq, ks = _quant_kv(k)
        vq, vs = _quant_kv(v)
        cache["k"].index_put_((bidx, slots), kq)
        cache["v"].index_put_((bidx, slots), vq)
        cache["k_scale"].index_put_((bidx, slots), ks)
        cache["v_scale"].index_put_((bidx, slots), vs)
    else:
        cache["k"].index_put_((bidx, slots), k.to(cache["k"].dtype))
        cache["v"].index_put_((bidx, slots), v.to(cache["v"].dtype))
    cache["pos"].index_put_((bidx, slots), positions.to(torch.int32))
    cache["len"] += s


def _cached_kv(cache: dict, dtype: torch.dtype):
    """The whole contiguous cache as (K, V), an int8 one dequantized in f32
    and rounded to ``dtype``."""
    if "k_scale" in cache:
        return tuple((cache[n].to(torch.float32)
                      * cache[n + "_scale"][..., None]).to(dtype)
                     for n in ("k", "v"))
    return cache["k"], cache["v"]


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
                    positions: torch.Tensor, causal: bool = True,
                    cache: Optional[dict] = None,
                    paged: Optional[dict] = None,
                    taps: Optional[dict] = None,
                    tap_prefix: str = "") -> torch.Tensor:
    """Returns the block's attention output (B, S, d_model); ``cache`` (a
    layer's pools or contiguous cache) is updated in place. ``causal``
    False is whisper's encoder. ``taps`` receives each linear's input
    under its param path."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    window = cfg.attn_window
    if taps is not None:
        for name in ("wq", "wk", "wv"):
            taps[tap_prefix + name] = x
    q = dense(p["wq"], x).reshape(b, s, h, hd)
    q = apply_rope(q, positions, theta=cfg.rope_theta, variant=cfg.rope)
    k = dense(p["wk"], x).reshape(b, s, kvh, hd)
    v = dense(p["wv"], x).reshape(b, s, kvh, hd)
    k = apply_rope(k, positions, theta=cfg.rope_theta, variant=cfg.rope)
    if cache is None:
        o = _core(cfg, q, k, v, positions, positions, causal=causal)
    elif "pos" in cache:
        _cache_write(cache, k, v, positions)
        if s == 1:
            # decode: attend over the whole (ring) cache
            kc, vc = _cached_kv(cache, x.dtype)
            o = _core(cfg, q, kc, vc, positions, cache["pos"])
        else:
            # prefill: attend over the sequence itself (a ring may already
            # have evicted positions that early queries need)
            o = _core(cfg, q, k, v, positions, positions)
    elif "block_table" in paged:
        if s != 1:
            raise ValueError("paged decode takes one token per slot")
        _paged_write_decode(cache, k, v, paged)
        o = ops.paged_attention(
            q[:, 0], cache["k_pool"], cache["v_pool"], paged["block_table"],
            paged["kv_len"], k_scale_pool=cache.get("k_scale_pool"),
            v_scale_pool=cache.get("v_scale_pool"), window=window)[:, None]
    elif "bt_rows" in paged and "kv_len" in paged:
        # a later chunk, a suffix after shared prefix pages, or the
        # speculative verify ("verify" in paged): scatter the S rows (pad
        # rows and idle slots carry positions < 0 and land on the scratch
        # page), then read all S rows in one page walk, row j at fill
        # position kv_len - S + j
        _paged_write_prefill(cache, k, v, positions, paged["bt_rows"])
        read = (ops.paged_attention_verify if "verify" in paged
                else ops.paged_attention_prefill)
        o = read(q, cache["k_pool"], cache["v_pool"], paged["bt_rows"],
                 paged["kv_len"], k_scale_pool=cache.get("k_scale_pool"),
                 v_scale_pool=cache.get("v_scale_pool"), window=window)
    elif "bt_rows" in paged:
        # fresh full prompt: write the pages, self-attend to the prompt
        _paged_write_prefill(cache, k, v, positions, paged["bt_rows"])
        o = _core(cfg, q, k, v, positions, positions)
    else:
        raise ValueError("a paged cache needs 'block_table' (decode) or "
                         "'bt_rows' (prefill, with 'kv_len' when the rows "
                         "read earlier context) indices")
    return _out(cfg, p, o.reshape(b, s, h * hd), taps, tap_prefix)


def apply_cross_attention(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                          positions: torch.Tensor,
                          enc_out: Optional[torch.Tensor] = None,
                          cache: Optional[dict] = None,
                          taps: Optional[dict] = None,
                          tap_prefix: str = "") -> torch.Tensor:
    """An enc-dec decoder's cross-attention (B, S, d_model): no RoPE, no
    causal mask, no window. K/V come from ``enc_out`` (B, enc_len, d) at
    positions 0..enc_len-1, written into ``cache`` (``init_cross_cache``'s
    layer view) where there is one (``encdec_prefill``); without
    ``enc_out`` they are the cache's, as prefill wrote them
    (``encdec_decode``), or with no cache either (the tweak's loss, as in
    the JAX package) ``x``'s own at ``positions``. ``taps`` receives
    each linear's input: wk's and wv's is ``enc_out`` where given."""
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    src = x if enc_out is None else enc_out
    if taps is not None:
        taps[tap_prefix + "wq"] = x
        taps[tap_prefix + "wk"] = src
        taps[tap_prefix + "wv"] = src
    q = dense(p["wq"], x).reshape(b, s, h, hd)
    if enc_out is None and cache is not None:
        k, v, kv_pos = cache["k"], cache["v"], cache["pos"]
    else:
        sb, s_kv = src.shape[:2]
        k = dense(p["wk"], src).reshape(sb, s_kv, kvh, hd)
        v = dense(p["wv"], src).reshape(sb, s_kv, kvh, hd)
        kv_pos = positions
        if enc_out is not None:
            kv_pos = torch.arange(s_kv, dtype=torch.int32,
                                  device=src.device)[None].expand(sb, s_kv)
        if cache is not None:
            _cross_fill(cache, k, v, kv_pos)
    o = _core(cfg, q, k, v, positions, kv_pos, causal=False, cross=True)
    return _out(cfg, p, o.reshape(b, s, h * hd), taps, tap_prefix)


def _out(cfg: ModelConfig, p: dict, o: torch.Tensor, taps: Optional[dict],
         tap_prefix: str) -> torch.Tensor:
    """The output projection of the heads' concatenated outputs; under
    serving TP (``cfg.tp > 1``: a rank's heads) it is row-parallel and
    all-reduces over the "model" axis."""
    if taps is not None:
        taps[tap_prefix + "wo"] = o
    return dense(p["wo"], o, reduce_axis=TP_AXIS if cfg.tp > 1 else None)
