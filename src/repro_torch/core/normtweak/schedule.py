"""Layer-level learning-rate scheduler (paper Eq. 3; port of
``repro.core.normtweak.schedule``): deeper layers get a larger LR because
quantization error accumulates with depth."""
from __future__ import annotations


def layer_lr(lr0: float, scale: float, layer_idx: int, n_layers: int) -> float:
    return lr0 * (1.0 + scale * (layer_idx / max(n_layers, 1)))
