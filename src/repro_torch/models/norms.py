"""RMSNorm / LayerNorm — the paper's tweakable parameters (port of
``repro.models.norms``).

Norm params live under keys starting with "ln" (and "final_norm", "gnorm"
for Mamba2's gated RMSNorm, "kvnorm" for MLA's latent norm) so the
norm-tweaking pipeline can address exactly these leaves: RMSNorm's
"scale", LayerNorm's "scale" and "bias".
"""
from __future__ import annotations

import torch

from repro_torch.models.config import ModelConfig


def init_norm(cfg: ModelConfig, d: int, device) -> dict:
    p = {"scale": torch.ones((d,), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=torch.float32, device=device)
    return p


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm == "layernorm":
        # the mean and the biased variance, as ``jnp.var``
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = (y * p["scale"].to(torch.float32)
             + p["bias"].to(torch.float32))
    else:
        ms = torch.mean(xf * xf, dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"].to(torch.float32)
    return y.to(x.dtype)


def apply_gated_rmsnorm(cfg: ModelConfig, p: dict, x: torch.Tensor,
                        z: torch.Tensor) -> torch.Tensor:
    """Mamba2 gated norm: RMSNorm(x * silu(z)) * scale, in f32."""
    xf = x.to(torch.float32) * torch.nn.functional.silu(z.to(torch.float32))
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
