"""Adam/AdamW on trees of tensors (port of ``repro.optim.adam``).

The JAX package's formula, step by step, rather than ``torch.optim.Adam``
(which rounds differently: it folds the bias corrections into the step
size and the denominator), so one update matches the reference to f32
rounding.
"""
from __future__ import annotations

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def adam_init(params) -> dict:
    def zeros():
        return tree_map(lambda x: torch.zeros_like(x, dtype=torch.float32),
                        params)
    return {"m": zeros(), "v": zeros(), "step": 0}


@torch.no_grad()
def adam_update(grads, state: dict, params, *, lr: float, b1: float = 0.9,
                b2: float = 0.999, eps: float = 1e-8,
                weight_decay: float = 0.0):
    """Returns (new_params, new_state); the inputs are left as they are."""
    step = state["step"] + 1
    # the bias corrections in f32, as the JAX package computes them
    sf = torch.tensor(float(step), dtype=torch.float32)
    bc1 = float(1.0 - torch.tensor(b1, dtype=torch.float32) ** sf)
    bc2 = float(1.0 - torch.tensor(b2, dtype=torch.float32) ** sf)

    new_m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.to(torch.float32),
                     state["m"], grads)
    new_v = tree_map(lambda v, g: b2 * v + (1 - b2) * torch.square(
        g.to(torch.float32)), state["v"], grads)

    def upd(p, m, v):
        mhat = m / bc1
        vhat = v / bc2
        delta = mhat / (torch.sqrt(vhat) + eps)
        if weight_decay:
            delta = delta + weight_decay * p.to(torch.float32)
        return (p.to(torch.float32) - lr * delta).to(p.dtype)

    new_params = tree_map(upd, params, new_m, new_v)
    return new_params, {"m": new_m, "v": new_v, "step": step}


def global_norm(tree) -> torch.Tensor:
    """The f32 2-norm over every leaf, the leaves summed in the JAX
    package's order (its tree leaves come in sorted key order)."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(grads, max_norm: float):
    """Returns (grads scaled to a global norm of at most ``max_norm``, the
    norm before scaling). The f32 scale promotes a bf16 grad to f32, as
    the JAX package's ``g * scale`` does."""
    gn = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)
    return tree_map(lambda g: g.to(torch.float32) * scale, grads), gn
