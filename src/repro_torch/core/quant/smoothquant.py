"""SmoothQuant (Xiao et al. 2023): migrate activation outliers into weights
(port of ``repro.core.quant.smoothquant``).

For a group of linears fed by the same normalization layer, per-input-
channel smoothing factors s_j = amax_x_j^alpha / amax_w_j^(1-alpha) scale
the weight rows by s and fold 1/s into the norm's scale — an exactly
equivalent transform in float that makes W·A8 quantization viable.
"""
from __future__ import annotations

import torch


def smooth_scales(act_amax: torch.Tensor, ws: list,
                  alpha: float = 0.5) -> torch.Tensor:
    """act_amax: (K,) per-channel |x| max; ws: (K, N) weights sharing the
    input."""
    w_amax = torch.stack([w.abs().amax(dim=1) for w in ws]).amax(dim=0)
    act_amax = act_amax.to(torch.float32).clamp_min(1e-5)
    w_amax = w_amax.to(torch.float32).clamp_min(1e-5)
    s = act_amax ** alpha / w_amax ** (1.0 - alpha)
    return s.clamp(1e-5, 1e5)


def fold_into_norm(norm_params: dict, s: torch.Tensor) -> dict:
    """Divide the producing norm's affine params by s (x' = x / s)."""
    out = dict(norm_params)
    for name in ("scale", "bias"):
        if name in norm_params:
            p = norm_params[name]
            out[name] = (p.to(torch.float32) / s).to(p.dtype)
    return out


def scale_weight_rows(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """w' = diag(s) @ w (compensates the activation division)."""
    return (w.to(torch.float32) * s[:, None]).to(w.dtype)
