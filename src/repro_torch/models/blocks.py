"""Transformer block: attention (GQA or MLA) plus a dense MLP or an MoE
(port of ``repro.models.blocks``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import (apply_attention, init_attention,
                                          init_kv_cache, init_paged_kv_cache)
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.mla import (apply_mla, init_mla, init_mla_cache,
                                    init_paged_mla_cache)
from repro_torch.models.mlp_moe import apply_mlp, apply_moe, init_mlp, init_moe
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.serve.kvcache import PageSpec


def init_block(cfg: ModelConfig, spec: LayerSpec, gen: torch.Generator,
               device) -> dict:
    attn = init_mla if cfg.attention == "mla" else init_attention
    p = {"ln1": init_norm(cfg, cfg.d_model, device),
         "attn": attn(cfg, gen, device),
         "ln2": init_norm(cfg, cfg.d_model, device)}
    if spec.mlp == "moe":
        p["moe"] = init_moe(cfg, gen, device)
    else:
        p["mlp"] = init_mlp(cfg, gen, cfg.d_ff, device)
    return p


def init_block_cache(cfg: ModelConfig, device, n_layers: int, *,
                     paged: Optional[PageSpec] = None, batch: int = 0,
                     max_len: int = 0) -> dict:
    """One attention kind's caches for ``n_layers`` stacked blocks: page
    pools with ``paged``, else contiguous caches of (batch, max_len)."""
    if paged is not None:
        if cfg.attention == "mla":
            return init_paged_mla_cache(cfg, paged, device, n_layers)
        return init_paged_kv_cache(cfg, paged, device, n_layers)
    if cfg.attention == "mla":
        return init_mla_cache(cfg, batch, max_len, device, n_layers=n_layers)
    return init_kv_cache(cfg, batch, max_len, device, n_layers=n_layers,
                         window=cfg.attn_window)


def _moe_valid(paged: Optional[dict],
               positions: torch.Tensor) -> Optional[torch.Tensor]:
    """Which tokens may compete for expert capacity: paged serving carries
    junk tokens that must not — left-padding in prefill (position -1) and
    idle slots in decode (kv_len 0). Unpaged calls carry none (None)."""
    if paged is None:
        return None
    if "bt_rows" in paged:                                    # prefill
        return positions >= 0
    return (paged["kv_len"] > 0)[:, None]                      # decode


def apply_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                positions: torch.Tensor, cache: Optional[dict] = None,
                paged: Optional[dict] = None, decode: bool = False,
                taps: Optional[dict] = None, tap_prefix: str = ""):
    """Pre-norm residual block; ``cache`` (this layer's pools or contiguous
    cache) is updated in place. ``taps`` (calibration) receives every
    linear's input under the JAX package's keys ("attn/wq", ...,
    "mlp/wo", "moe/router", "moe/experts", ...). Returns (x, aux): the
    MoE's load-balancing loss, a plain 0.0 for a dense block (no device
    op on the serving path). ``decode`` marks ``lm_decode``'s calls: MLA
    then takes its absorbed form (GQA reads its cache alike either
    way)."""
    h = apply_norm(cfg, p["ln1"], x)
    kw = dict(positions=positions, cache=cache, paged=paged, taps=taps,
              tap_prefix=tap_prefix + "attn/")
    if cfg.attention == "mla":
        x = x + apply_mla(cfg, p["attn"], h, decode=decode, **kw)
    else:
        x = x + apply_attention(cfg, p["attn"], h, **kw)
    h2 = apply_norm(cfg, p["ln2"], x)
    if "moe" in p:
        y, aux = apply_moe(cfg, p["moe"], h2, taps, tap_prefix + "moe/",
                           valid=_moe_valid(paged, positions))
        return x + y, aux
    return x + apply_mlp(cfg, p["mlp"], h2, taps, tap_prefix + "mlp/"), 0.0
