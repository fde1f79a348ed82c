"""Rotary position embeddings: llama's "full" and ChatGLM's "half"
variants, and whisper's fixed sinusoidal table (port of
``repro.models.rope``)."""
from __future__ import annotations

import math

import torch


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0, variant: str = "full") -> torch.Tensor:
    """x: (B, S, H, hd); positions: (B, S) int. Rotate-half convention.

    variant "full": rotate all head dims; "half": rotate only the first
    hd // 2 (ChatGLM's 2D RoPE), with frequencies over that rotated width;
    "none": identity (learned positions)."""
    if variant == "none":
        return x
    hd = x.shape[-1]
    rot = hd if variant == "full" else hd // 2
    half = rot // 2
    freqs = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                          device=x.device) / half))
    ang = positions.to(torch.float32)[..., None] * freqs      # (B, S, half)
    cos = torch.cos(ang)[:, :, None, :]                       # (B, S, 1, half)
    sin = torch.sin(ang)[:, :, None, :]
    # the f32 rotation of the bf16 or f32 halves (promoted inside each
    # product), rounded once to x's dtype; the unrotated channels after it
    x1, x2 = x[..., :half], x[..., half:rot]
    if torch.is_grad_enabled() and x.requires_grad:
        parts = [x1 * cos - x2 * sin, x2 * cos + x1 * sin]
        if rot < hd:
            parts.append(x[..., rot:])
        return torch.cat(parts, dim=-1).to(x.dtype)
    # outside autograd each half's last op writes x's dtype into its slice
    # of the output itself: no concatenation and no cast pass
    out = torch.empty_like(x)
    torch.sub(x1 * cos, x2 * sin, out=out[..., :half])
    torch.add(x2 * cos, x1 * sin, out=out[..., half:rot])
    if rot < hd:
        out[..., rot:] = x[..., rot:]
    return out


def sinusoidal_positions(seq_len: int, d_model: int,
                         device=None) -> torch.Tensor:
    """Whisper's fixed sinusoidal table (seq_len, d_model) f32: the sines
    of half the channels, then their cosines, at frequencies
    10000^(-i / (half - 1))."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=device) / (half - 1))
    ang = torch.arange(seq_len, dtype=torch.float32,
                       device=device)[:, None] * freqs[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
