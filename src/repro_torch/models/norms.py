"""RMSNorm — the paper's tweakable parameters (port of ``repro.models.norms``).

Norm params live under keys starting with "ln" (and "final_norm") so the
norm-tweaking pipeline can address exactly these leaves.
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def init_norm(cfg: ModelConfig, d: int, device) -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device)}


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def is_norm_path(path: str) -> bool:
    """True if this param path belongs to a tweakable normalization layer."""
    parts = path.split("/")
    return any(
        seg.startswith("ln") or seg in ("gnorm", "qnorm", "kvnorm", "final_norm")
        for seg in parts
    )
