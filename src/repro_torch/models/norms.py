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
    p = {"scale": torch.ones((d,), dtype=cfg.pdtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=cfg.pdtype, device=device)
    return p


def _rounded(y: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype,
             bias: torch.Tensor = None) -> torch.Tensor:
    """y * scale (+ bias), f32 products (a bf16 param promoted inside the
    kernel), rounded once to ``dtype``. Outside autograd a bf16 result is
    the last kernel's own output, no cast pass after it."""
    if dtype == torch.float32 or (torch.is_grad_enabled()
                                  and (y.requires_grad
                                       or scale.requires_grad)):
        out = y * scale
        return (out if bias is None else out + bias).to(dtype)
    out = torch.empty(y.shape, dtype=dtype, device=y.device)
    if bias is None:
        return torch.mul(y, scale, out=out)
    return torch.addcmul(bias, y, scale, out=out)


def apply_norm(cfg: ModelConfig, p: dict, x: torch.Tensor) -> torch.Tensor:
    """The config's norm of x over its last dim, computed in f32 (params
    upcast too) and rounded once back to x's dtype. A bf16 x is read as
    it is: the reductions take its f32 values (``dtype=`` of the
    reduction) and the products promote it, so no cast pass runs on it
    (an f32 x takes the JAX package's own sequence of ops)."""
    if cfg.norm == "layernorm":
        # the mean and the biased variance, as ``jnp.var``
        mu = torch.mean(x, dim=-1, keepdim=True, dtype=torch.float32)
        xc = x - mu
        var = torch.mean(torch.square(xc), dim=-1, keepdim=True)
        y = xc * torch.rsqrt(var + cfg.norm_eps)
        return _rounded(y, p["scale"], x.dtype, p["bias"])
    if x.dtype == torch.float32:
        r = torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True)
                        + cfg.norm_eps)
    else:
        # mean(x^2) as the squared f32 2-norm over d: one reduction of
        # the f32 values, then eps + ss^2 / d in one kernel
        ss = torch.linalg.vector_norm(x, 2, dim=-1, keepdim=True,
                                      dtype=torch.float32)
        eps = torch.full((), cfg.norm_eps, dtype=torch.float32,
                         device=x.device)
        r = torch.rsqrt(torch.addcmul(eps, ss, ss, value=1.0 / x.shape[-1]))
    return _rounded(x * r, p["scale"], x.dtype)


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
