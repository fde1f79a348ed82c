"""Rotary position embeddings, llama's "full" variant (port of
``repro.models.rope``)."""
from __future__ import annotations

import torch


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0) -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Rotate-half convention over
    all head dims."""
    half = x.shape[-1] // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs      # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]                       # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    rotated = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return rotated.to(x.dtype)
