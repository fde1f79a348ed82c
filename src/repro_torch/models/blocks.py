"""Transformer block: attention plus dense MLP (port of
``repro.models.blocks``)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import apply_attention, init_attention
from repro_torch.models.config import ModelConfig
from repro_torch.models.mlp_moe import apply_mlp, init_mlp
from repro_torch.models.norms import apply_norm, init_norm


def init_block(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    return {"ln1": init_norm(cfg, cfg.d_model, device),
            "attn": init_attention(cfg, gen, device),
            "ln2": init_norm(cfg, cfg.d_model, device),
            "mlp": init_mlp(cfg, gen, cfg.d_ff, device)}


def apply_block(cfg: ModelConfig, p: dict, x: torch.Tensor, *,
                positions: torch.Tensor, cache: Optional[dict] = None,
                paged: Optional[dict] = None, taps: Optional[dict] = None,
                tap_prefix: str = "") -> torch.Tensor:
    """Pre-norm residual block; ``cache`` (this layer's pools or contiguous
    cache) is updated in place. ``taps`` (calibration) receives every
    linear's input under the JAX package's keys ("attn/wq", ...,
    "mlp/wo")."""
    h = apply_norm(cfg, p["ln1"], x)
    x = x + apply_attention(cfg, p["attn"], h, positions=positions,
                            cache=cache, paged=paged, taps=taps,
                            tap_prefix=tap_prefix + "attn/")
    h2 = apply_norm(cfg, p["ln2"], x)
    return x + apply_mlp(cfg, p["mlp"], h2, taps, tap_prefix + "mlp/")
