"""Distribution losses for norm tweaking (paper Eq. 2 + Table 9 ablations;
port of ``repro.core.normtweak.losses``).

L_dist: per-channel |Δmean| + |Δvar| averaged over channels — the paper's
relaxed alignment (channel structure preserved, no point-wise overfit).
L_mse and L_kl are the Table 9 baselines.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


class _ChannelStats(torch.autograd.Function):
    """(T, C) -> (mean (C,), var (C,)) f32 (f64 for f64 input) through
    ``ops.channel_stats`` (the CUDA kernel on the card, its plain version
    on the CPU), with the two moments' gradient in plain PyTorch on both:
    dx = (g_mean + 2 g_var (x - mean)) / T, in x's dtype (the reference has
    no backward kernel)."""

    @staticmethod
    def forward(ctx, x):
        mu, var = ops.channel_stats(x)
        ctx.save_for_backward(x, mu)
        return mu, var

    @staticmethod
    def backward(ctx, g_mu, g_var):
        x, mu = ctx.saved_tensors
        xf = x.to(mu.dtype)
        dx = (torch.zeros_like(xf) if g_var is None
              else 2.0 * g_var * (xf - mu))
        if g_mu is not None:
            dx = dx + g_mu
        return (dx / x.shape[0]).to(x.dtype)


def channel_stats(x: torch.Tensor):
    """x: (..., C) -> (mean (C,), var (C,)) over all token dims, in f32
    (population variance, as ``jnp.var``)."""
    return _ChannelStats.apply(x.reshape(-1, x.shape[-1]))


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
