"""Dense MLP (SiLU-GLU, or a plain GELU MLP) and capacity-based top-k MoE
(port of ``repro.models.mlp_moe``).

MoE dispatch is the JAX package's scatter/gather formulation: tokens are
scattered into a per-expert (E, C, d) buffer (C = capacity), the experts
run as one batched matmul per linear (``dense_experts``: packed stacks on
the expert-batched kernels, every expert in one launch), and the results
are gathered back with the router gates. Tokens past an expert's capacity
are dropped, as in Switch/GShard. With ``moe_impl="shard_map"`` under a
mesh, ``apply_moe`` dispatches expert-parallel instead where the JAX
package's rule allows (models/moe_shardmap.py). The index ops
(``index_put`` with accumulation, advanced-index gathers) are ones
autograd differentiates, so the norm tweak reaches ln2 through the router
and the experts.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.distributed.sharding import TP_AXIS, active_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.linear import (dense, dense_experts, init_dense,
                                       init_dense_experts)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``. A bf16 x takes the JAX package's rounding points:
    x * logistic(x), which XLA expands to 1 / (1 + exp(-x)), each op's
    result rounded to bf16 (four roundings where a fused SiLU takes one;
    that moves a layer's output by about a bf16 step). An f32 x takes the
    fused SiLU: there the two differ by an f32 step, as the two packages'
    exp do."""
    if x.dtype == torch.float32:
        return F.silu(x)
    return x * torch.reciprocal(1.0 + torch.exp(-x))


def _in_dtype(c: float, x: torch.Tensor) -> float:
    """The constant ``c`` rounded to x's dtype (a weak-typed constant meets
    a bf16 array as bf16 in JAX)."""
    return float(torch.tensor(c, dtype=torch.float64).to(x.dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(approximate=True)``. A bf16 x takes the JAX package's
    ops one by one, each rounded to bf16, its constants rounded to bf16
    first: x * 0.5 * (1 + tanh(sqrt(2/pi) * (x + 0.044715 * x^3))). An f32
    x takes the fused tanh GELU (as ``silu``)."""
    if x.dtype == torch.float32:
        return F.gelu(x, approximate="tanh")
    inner = _in_dtype(math.sqrt(2 / math.pi), x) * (
        x + _in_dtype(0.044715, x) * (x * x * x))
    return x * (0.5 * (1.0 + torch.tanh(inner)))


def init_mlp(cfg: ModelConfig, gen: torch.Generator, d_ff: int,
             device) -> dict:
    d, kw = cfg.d_model, dict(bias=cfg.mlp_bias, dtype=cfg.pdtype)
    p = {"wi": init_dense(gen, d, d_ff, device, **kw),
         "wo": init_dense(gen, d_ff, d, device, **kw)}
    if cfg.act == "silu":
        p["wg"] = init_dense(gen, d, d_ff, device, **kw)
    return p


def apply_mlp(cfg: ModelConfig, p: dict, x: torch.Tensor,
              taps: Optional[dict] = None,
              tap_prefix: str = "") -> torch.Tensor:
    """SiLU-GLU MLP, or with ``act="gelu"`` a plain MLP (wi, tanh GELU,
    wo; no wg). ``taps`` (calibration) receives each linear's input under
    its param path."""
    if taps is not None:
        taps[tap_prefix + "wi"] = x
        if "wg" in p:
            taps[tap_prefix + "wg"] = x
    if cfg.act == "silu":
        h = silu(dense(p["wg"], x)) * dense(p["wi"], x)
    else:
        h = gelu_tanh(dense(p["wi"], x))
    if taps is not None:
        taps[tap_prefix + "wo"] = h
    # serving TP: wi/wg are column-parallel (a rank's d_ff slice), the down
    # projection row-parallel, all-reduced over the "model" axis
    return dense(p["wo"], h, reduce_axis=TP_AXIS if cfg.tp > 1 else None)


# ------------------------------------------------------------------- MoE

def init_moe(cfg: ModelConfig, gen: torch.Generator, device) -> dict:
    m = cfg.moe
    d, ff = cfg.d_model, m.d_ff_expert
    pd = dict(dtype=cfg.pdtype)
    # the router stays f32 in any pdtype, as in the JAX package
    p = {"router": init_dense(gen, d, m.n_experts, device),
         "experts": {
             "wi": init_dense_experts(gen, m.n_experts, d, ff, device, **pd),
             "wg": init_dense_experts(gen, m.n_experts, d, ff, device, **pd),
             "wo": init_dense_experts(gen, m.n_experts, ff, d, device, **pd)}}
    if m.n_shared:
        p["shared"] = init_mlp(cfg, gen, m.n_shared * ff, device)
    return p


def moe_capacity(cfg: ModelConfig, n_tokens: int) -> int:
    """Tokens each expert takes: capacity_factor x its fair share, rounded
    up to a multiple of 8, at least 8 (the JAX package's rule)."""
    m = cfg.moe
    c = int(m.capacity_factor * n_tokens * m.top_k / m.n_experts)
    return max(8, -(-c // 8) * 8)


def apply_moe(cfg: ModelConfig, p: dict, x: torch.Tensor,
              taps: Optional[dict] = None, tap_prefix: str = "",
              valid: Optional[torch.Tensor] = None):
    """x: (B, S, d). Returns (y, aux loss scalar).

    ``valid`` (B, S) marks real tokens; False (left-padding in a paged
    prefill, an idle slot in decode) routes the token to the overflow bin,
    so it neither takes expert capacity nor shifts real tokens' positions.
    Capacity counts all B*S tokens, pads included, as in the JAX package."""
    m = cfg.moe
    b, s, d = x.shape
    if cfg.moe_impl == "shard_map" and taps is None and valid is None:
        # expert parallelism (models/moe_shardmap.py) under the JAX
        # package's rule: a mesh with a "model" axis, float experts, E
        # divisible by the axis and the tokens too. x is the rank's data
        # shard here, so the reference's batch-over-data condition holds
        # by construction
        mesh = active_mesh()
        float_experts = not isinstance(p["experts"]["wi"]["w"],
                                       QuantizedTensor)
        if (mesh is not None and "model" in mesh.shape and float_experts
                and m.n_experts % mesh.shape["model"] == 0
                and (b * s) % mesh.shape["model"] == 0):
            from repro_torch.models.moe_shardmap import moe_ep_shardmap
            return moe_ep_shardmap(cfg, p, x)
    t = b * s
    e, k = m.n_experts, m.top_k
    cap = moe_capacity(cfg, t)
    xf = x.reshape(t, d)
    if taps is not None:
        taps[tap_prefix + "router"] = xf

    logits = dense(p["router"], xf.to(torch.float32))           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)                      # (T, k)
    gate = gate / gate.sum(dim=-1, keepdim=True).clamp_min(1e-9)

    # slot positions within each expert: a stable sort by expert, each
    # entry's rank among its expert's entries
    flat_idx = idx.reshape(t * k)
    if valid is not None:
        flat_idx = torch.where(valid.reshape(t).repeat_interleave(k),
                               flat_idx, e)
    order = torch.argsort(flat_idx, stable=True)
    sorted_e = flat_idx[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=x.device))
    # the overflow bin E reads expert E-1's start, as the JAX package's
    # clamped gather does; its entries are dropped below either way
    pos_sorted = (torch.arange(t * k, device=x.device)
                  - starts[sorted_e.clamp_max(e - 1)])
    pos = torch.empty_like(pos_sorted)
    pos[order] = pos_sorted

    # load-balancing aux loss (Switch): E * sum_e f_e * p_e; the overflow
    # bin is not counted
    me = probs.mean(dim=0)
    # the counts by index_add (a fixed-size output, as under fake tensors)
    ce = torch.zeros(e + 1, dtype=torch.float32, device=x.device).index_add_(
        0, flat_idx, torch.ones_like(flat_idx, dtype=torch.float32))[:e] / t
    aux = m.router_aux_weight * e * torch.sum(me * ce)

    keep = pos < cap
    safe_e = torch.where(keep, flat_idx, e)                  # overflow -> E
    safe_pos = torch.where(keep, pos, 0)

    # dispatch: one (expert, slot) per kept entry, so accumulating into
    # zeros is a copy; the overflow row E is dropped
    xk = xf.repeat_interleave(k, dim=0)                        # (T*k, d)
    buf = torch.zeros((e + 1, cap, d), dtype=x.dtype, device=x.device)
    buf = buf.index_put((safe_e, safe_pos), xk, accumulate=True)[:e]
    if taps is not None:
        taps[tap_prefix + "experts"] = buf

    h = (silu(dense_experts(p["experts"]["wg"], buf))
         * dense_experts(p["experts"]["wi"], buf))
    if taps is not None:
        taps[tap_prefix + "experts_out"] = h
    out = dense_experts(p["experts"]["wo"], h)                  # (E, C, d)

    # combine
    gathered = out[safe_e.clamp_max(e - 1), safe_pos]          # (T*k, d)
    live = (keep & (safe_e < e)).to(x.dtype)
    gathered = gathered * live[:, None] * gate.reshape(t * k, 1).to(x.dtype)
    y = gathered.reshape(t, k, d).sum(dim=1).reshape(b, s, d)

    if "shared" in p:
        sh_taps = {} if taps is not None else None
        y = y + apply_mlp(cfg, p["shared"], x, sh_taps, "")
        if taps is not None:
            for kk, vv in sh_taps.items():
                taps[tap_prefix + "shared/" + kk] = vv
    return y, aux
