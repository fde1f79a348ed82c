"""Decoder-only LM (port of ``repro.models.transformer``).

Params keep the JAX package's key paths: "embed", "final_norm",
"lm_head" (untied models only) and the scan-stacked "stack/p0" blocks,
whose leaves carry a leading layer dim. The JAX package scans over that
dim; here ``_run_stack`` is a Python loop that hands each layer a view of
its params and cache.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.device import resolve_device
from repro_torch.models.attention import init_paged_kv_cache
from repro_torch.models.blocks import apply_block, init_block
from repro_torch.models.config import ModelConfig
from repro_torch.models.linear import dense
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.serve.kvcache import PageSpec


def _stack(trees: list):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def tree_index(tree, i: int):
    """Layer i of a scan-stacked tree (views, no copies)."""
    if isinstance(tree, dict):
        return {k: tree_index(v, i) for k, v in tree.items()}
    return tree[i]           # tensors and QuantizedTensor alike


def init_lm(cfg: ModelConfig, seed: int = 0, device="cuda") -> dict:
    """Seeded float params, drawn from a ``torch.Generator`` on ``device``:
    N(0, 0.02^2) embeddings, N(0, 1/K) linear weights, unit norm scales."""
    cfg.validate()
    dev = resolve_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params: dict = {
        "embed": {"w": torch.randn((cfg.vocab_size, cfg.d_model),
                                   generator=gen, device=dev) * 0.02},
        "final_norm": init_norm(cfg, cfg.d_model, dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = {"w": torch.randn(
            (cfg.d_model, cfg.vocab_size), generator=gen, device=dev) * 0.02}
    params["stack"] = {
        f"p{j}": _stack([init_block(cfg, gen, dev)
                         for _ in range(cfg.n_repeats)])
        for j in range(len(cfg.pattern))}
    return params


def init_cache(cfg: ModelConfig, spec: PageSpec, device) -> dict:
    """Stacked page pools for the continuous-batching engine."""
    return {"stack": {f"p{j}": init_paged_kv_cache(cfg, spec, device,
                                                   cfg.n_repeats)
                      for j in range(len(cfg.pattern))}}


def _embed(params: dict, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"]["w"][tokens.to(torch.int64)].to(torch.float32)


def _run_stack(cfg: ModelConfig, params: dict, x: torch.Tensor, *,
               positions: torch.Tensor, cache: Optional[dict] = None,
               paged: Optional[dict] = None) -> torch.Tensor:
    """Pattern repeats in order, layer by layer. ``cache`` is updated in
    place through each layer's view of the stacked pools."""
    pat = cfg.pattern
    for r in range(cfg.n_repeats):
        for j in range(len(pat)):
            p = tree_index(params["stack"][f"p{j}"], r)
            c = (tree_index(cache["stack"][f"p{j}"], r)
                 if cache is not None else None)
            x = apply_block(cfg, p, x, positions=positions, cache=c,
                            paged=paged)
    return x


def _head(cfg: ModelConfig, params: dict, x: torch.Tensor) -> torch.Tensor:
    x = apply_norm(cfg, params["final_norm"], x)
    if cfg.tie_embeddings:
        # a plain product outside any kernel, as in the JAX package
        return torch.matmul(x, params["embed"]["w"].to(torch.float32).t())
    return dense(params["lm_head"], x)


def lm_forward(cfg: ModelConfig, params: dict,
               tokens: torch.Tensor) -> torch.Tensor:
    """Full-sequence causal forward. tokens (B, S) -> logits (B, S, V) f32."""
    b, s = tokens.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device)[None].expand(b, s)
    x = _embed(params, tokens)
    x = _run_stack(cfg, params, x, positions=positions)
    return _head(cfg, params, x)


def lm_prefill(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               cache: dict, positions: torch.Tensor,
               paged: dict) -> torch.Tensor:
    """Prompt ingestion into the paged cache. tokens, positions (B, S), pads
    left with position -1 so the real last token sits at index -1; paged
    holds the slots' block-table rows ("bt_rows"). Returns last-token
    logits (B, V)."""
    x = _embed(params, tokens)
    x = _run_stack(cfg, params, x, positions=positions, cache=cache,
                   paged=paged)
    return _head(cfg, params, x[:, -1:, :])[:, 0, :]


def lm_decode(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
              cache: dict, positions: torch.Tensor,
              paged: dict) -> torch.Tensor:
    """One decode step over all slots. tokens, positions (S, 1); paged holds
    the block tables, per-slot write targets and fill counts. Returns
    logits (S, V)."""
    x = _embed(params, tokens)
    x = _run_stack(cfg, params, x, positions=positions, cache=cache,
                   paged=paged)
    return _head(cfg, params, x)[:, 0, :]


def is_quantized(params: dict) -> bool:
    def walk(t):
        if isinstance(t, QuantizedTensor):
            return True
        return isinstance(t, dict) and any(walk(v) for v in t.values())
    return walk(params)
