"""Decoder-only LM (port of ``repro.models.transformer``).

Params keep the JAX package's key paths: "embed", "final_norm",
"lm_head" (untied models only) and the scan-stacked "stack/p0" blocks,
whose leaves carry a leading layer dim. The JAX package scans over that
dim; here ``_run_stack`` is a Python loop that hands each layer a view of
its params and cache. Per-layer access for the quantization pipeline goes
through ``num_blocks`` / ``block_spec`` / ``get_block``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.device import resolve_device
from repro_torch.models.attention import init_kv_cache, init_paged_kv_cache
from repro_torch.models.blocks import apply_block, init_block
from repro_torch.models.config import ModelConfig
from repro_torch.models.linear import dense
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.serve.kvcache import PageSpec
from repro_torch.utils.tree import tree_index, tree_stack


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded float params, drawn from a ``torch.Generator`` on ``device``:
    N(0, 0.02^2) embeddings (and learned position table), N(0, 1/K) linear
    weights, zero biases, unit norm scales and zero norm biases."""
    cfg.validate()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: dict = {
        "embed": {"w": torch.randn((cfg.vocab_size, cfg.d_model),
                                   generator=gen, device=dev) * 0.02},
        "final_norm": init_norm(cfg, cfg.d_model, dev),
    }
    if cfg.pos_emb == "learned":
        params["pos"] = {"w": torch.randn(
            (cfg.max_position, cfg.d_model), generator=gen, device=dev) * 0.02}
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen, device=dev) * 0.02}
    params["stack"] = {
        f"p{j}": tree_stack([init_block(cfg, spec, gen, dev)
                             for _ in range(cfg.n_repeats)])
        for j, spec in enumerate(cfg.pattern)}
    return params


def init_cache(cfg: ModelConfig, spec: PageSpec, device) -> dict:
    """Stacked page pools for the continuous-batching engine."""
    return {"stack": {f"p{j}": init_paged_kv_cache(cfg, spec, device,
                                                   cfg.n_repeats)
                      for j in range(len(cfg.pattern))}}


def init_contiguous_cache(cfg: ModelConfig, batch: int, max_len: int,
                          device) -> dict:
    """Stacked contiguous caches for ``lm_decode`` without pages (the
    calibration generator; the JAX package's ``init_cache(cfg, batch,
    max_len)``)."""
    return {"stack": {f"p{j}": init_kv_cache(cfg, batch, max_len, device,
                                             n_layers=cfg.n_repeats,
                                             window=cfg.attn_window)
                      for j in range(len(cfg.pattern))}}


def num_blocks(cfg: ModelConfig) -> int:
    return len(cfg.pattern) * cfg.n_repeats


def block_spec(cfg: ModelConfig, i: int):
    return cfg.pattern[i % len(cfg.pattern)]


def get_block(cfg: ModelConfig, params: dict, i: int) -> dict:
    """Block i's params (views into the stacked leaves)."""
    j = i % len(cfg.pattern)
    return tree_index(params["stack"][f"p{j}"], i // len(cfg.pattern))


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
           positions: torch.Tensor) -> torch.Tensor:
    """Token embeddings, plus the learned position table's rows at
    ``positions`` clipped to the table (a left pad's -1 reads row 0, as in
    the JAX package)."""
    x = params["embed"]["w"][tokens.to(torch.int64)].to(torch.float32)
    if cfg.pos_emb == "learned":
        idx = positions.to(torch.int64).clamp(0, cfg.max_position - 1)
        x = x + params["pos"]["w"][idx].to(torch.float32)
    return x


def _run_stack(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
               positions: torch.Tensor, cache: Optional[dict] = None,
               paged: Optional[dict] = None):
    """Pattern repeats in order, layer by layer. ``cache`` is updated in
    place through each layer's view of the stacked pools. Returns (x, the
    sum of the blocks' aux losses: a tensor, or 0.0 when no block is an
    MoE)."""
    pat = cfg.pattern
    aux_total = 0.0
    for r in range(cfg.n_repeats):
        for j in range(len(pat)):
            p = tree_index(params["stack"][f"p{j}"], r)
            c = (tree_index(cache["stack"][f"p{j}"], r)
                 if cache is not None else None)
            x, aux = apply_block(cfg, p, x, positions=positions, cache=c,
                                 paged=paged)
            aux_total = aux_total + aux
    return x, aux_total


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        # a plain product outside any kernel, as in the JAX package
        return torch.matmul(x, params["embed"]["w"].to(torch.float32).t())
    return dense(params["lm_head"], x)


def lm_forward(cfg: ModelConfig, params: dict, tokens: torch.Tensor):
    """Full-sequence causal forward. tokens (B, S) -> (logits (B, S, V)
    f32, the MoE aux loss)."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = _embed(cfg, params, tokens, positions)
    x, aux = _run_stack(cfg, params, x, positions=positions)
    return _head(cfg, params, x), torch.as_tensor(aux, dtype=torch.float32,
                                                  device=x.device)


def lm_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               cache: dict, positions: torch.Tensor,
               paged: Optional[dict] = None) -> torch.Tensor:
    """Prompt ingestion into the cache. tokens, positions (B, S), pads left
    with position -1 so the real last token sits at index -1. With page
    pools, paged holds the slots' block-table rows ("bt_rows") and, for a
    later chunk or a suffix after shared prefix pages, the fill counts
    after this call ("kv_len"); without ``paged`` the cache is contiguous
    (``init_contiguous_cache``, the static engine's). Returns the logits of
    the last row, the chunk's last real token (B, V)."""
    x = _embed(cfg, params, tokens, positions)
    x, _ = _run_stack(cfg, params, x, positions=positions, cache=cache,
                      paged=paged)
    return _head(cfg, params, x[:, -1:, :])[:, 0, :]


def lm_verify(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
              cache: dict, positions: torch.Tensor,
              paged: dict) -> torch.Tensor:
    """The speculative verify forward: score M tokens a slot in one pass.
    tokens (B, M) = [the pending token, d_1..d_{M-1}]; positions (B, M),
    -1 for idle slots; paged holds "bt_rows", "kv_len" (the fill counting
    all M tokens) and the "verify" marker. Returns the logits of all M
    rows (B, M, V): row m is the next-token distribution after the prefix
    and tokens[:, :m + 1]."""
    x = _embed(cfg, params, tokens, positions)
    x, _ = _run_stack(cfg, params, x, positions=positions, cache=cache,
                      paged=paged)
    return _head(cfg, params, x)


def lm_decode(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
              cache: dict, positions: torch.Tensor,
              paged: Optional[dict] = None) -> torch.Tensor:
    """One decode step. tokens, positions (B, 1). With page pools, B is the
    slot count and ``paged`` holds the block tables, per-slot write
    targets and fill counts; without ``paged`` the cache is contiguous
    (``init_contiguous_cache``). Returns logits (B, V)."""
    x = _embed(cfg, params, tokens, positions)
    x, _ = _run_stack(cfg, params, x, positions=positions, cache=cache,
                      paged=paged)
    return _head(cfg, params, x)[:, 0, :]


def lm_loss(cfg: ModelConfig, params: dict, batch: dict):
    """Next-token cross-entropy plus the MoE aux loss. batch: tokens,
    labels, optional mask. Returns (loss, {"nll", "aux"})."""
    logits, aux = lm_forward(cfg, params, batch["tokens"])
    labels = batch["labels"].to(torch.int64)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = lse - ll
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones_like(nll)
    mask = mask.to(nll.dtype)
    loss = (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return loss + aux, {"nll": loss, "aux": aux}


def is_quantized(params: dict) -> bool:
    def walk(t):
        if isinstance(t, QuantizedTensor):
            return True
        return isinstance(t, dict) and any(walk(v) for v in t.values())
    return walk(params)
