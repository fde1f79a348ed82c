"""Gradient compression (port of ``repro.optim.compression``).

int8/int4 symmetric per-leaf quantization with stochastic rounding and
error feedback (residual accumulation): the compressed representation is
what a bandwidth-limited data-parallel all-reduce would carry; error
feedback keeps SGD/Adam converging (Seide et al. 2014, Karimireddy et al.
2019).

The rounding noise is uniform on [-0.5, 0.5), drawn from an explicit
``torch.Generator`` leaf by leaf in sorted key order (the JAX package's
leaf order; its ``jax.random`` streams cannot be reproduced here), or
passed in as a tree (``noise``), as the tests pass the JAX package's.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.utils.tree import tree_leaves, tree_map


def _compress_leaf(g: torch.Tensor, ef: torch.Tensor, noise: torch.Tensor,
                   bits: int):
    gf = g.to(torch.float32) + ef
    qmax = 2 ** (bits - 1) - 1
    scale = torch.clamp(gf.abs().max(), min=1e-12) / qmax
    q = torch.clamp(torch.round(gf / scale + noise), -qmax, qmax)
    deq = q * scale
    return deq, gf - deq


@torch.no_grad()
def compress_decompress(grads, ef_state, *, bits: int,
                        rng: Optional[torch.Generator] = None,
                        noise=None):
    """Returns (decompressed grads, new error-feedback state). The noise is
    ``noise`` (a tree like ``grads``) or drawn from ``rng``."""
    if noise is None:
        if rng is None:
            raise ValueError("compress_decompress needs rng or noise")
        draws = {id(g): torch.rand(g.shape, generator=rng,
                                   device=g.device) - 0.5
                 for g in tree_leaves(grads)}
        noise = tree_map(lambda g: draws[id(g)], grads)
    pairs = tree_map(lambda g, e, n: _compress_leaf(g, e, n, bits),
                     grads, ef_state, noise)
    return _pick(pairs, 0), _pick(pairs, 1)


def _pick(tree, i: int):
    """Element ``i`` of every (deq, residual) leaf pair."""
    if isinstance(tree, dict):
        return {k: _pick(v, i) for k, v in tree.items()}
    return tree[i]
