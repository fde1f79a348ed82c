"""Distribution losses for norm tweaking (paper Eq. 2 + Table 9 ablations;
port of ``repro.core.normtweak.losses``).

L_dist: per-channel |Δmean| + |Δvar| averaged over channels — the paper's
relaxed alignment (channel structure preserved, no point-wise overfit).
L_mse and L_kl are the Table 9 baselines.
"""
from __future__ import annotations

import torch


def channel_stats(x: torch.Tensor):
    """x: (..., C) -> (mean (C,), var (C,)) over all token dims, in f32
    (population variance, as ``jnp.var``)."""
    xf = x.to(torch.float32).reshape(-1, x.shape[-1])
    mu = xf.mean(dim=0)
    var = torch.square(xf - mu).mean(dim=0)
    return mu, var


def l_dist(f: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Channel-wise distribution loss (Eq. 2)."""
    mu_f, var_f = channel_stats(f)
    mu_q, var_q = channel_stats(q)
    return torch.mean(torch.abs(mu_f - mu_q) + torch.abs(var_f - var_q))


def l_mse(f: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.square(f.to(torch.float32) - q.to(torch.float32)))


def l_kl(f: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Per-channel Gaussian KL(f || q) from matched moments."""
    mu_f, var_f = channel_stats(f)
    mu_q, var_q = channel_stats(q)
    var_f = var_f.clamp_min(1e-8)
    var_q = var_q.clamp_min(1e-8)
    kl = 0.5 * (torch.log(var_q / var_f)
                + (var_f + torch.square(mu_f - mu_q)) / var_q - 1.0)
    return torch.mean(kl)


LOSSES = {"dist": l_dist, "mse": l_mse, "kl": l_kl}


def activation_divergence(f: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Figure-1 metric: mean absolute per-channel mean difference Δ_u."""
    mu_f, _ = channel_stats(f)
    mu_q, _ = channel_stats(q)
    return torch.mean(torch.abs(mu_f - mu_q))
