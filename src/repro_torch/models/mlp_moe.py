"""Dense SiLU-GLU MLP (port of ``repro.models.mlp_moe``; MoE comes in a
later slice)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.linear import dense, init_dense


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int,
             device) -> dict:
    d = cfg.d_model
    return {"wi": init_dense(gen, d, d_ff, device),
            "wo": init_dense(gen, d_ff, d, device),
            "wg": init_dense(gen, d, d_ff, device)}


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(dense(p["wg"], x)) * dense(p["wi"], x)
    return dense(p["wo"], h)
