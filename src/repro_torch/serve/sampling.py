"""Token sampling for the serving engine (port of ``repro.serve.sampling``).

Greedy decoding is bit-exact against the JAX package. Temperature and
top-k draw from an explicit ``torch.Generator``: the same distribution as
``jax.random.categorical``, never the same random bits.
"""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, *, temperature: float = 1.0,
           top_k: int = 0,
           generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """logits: (B, V) -> (B,) int32. temperature <= 0 is greedy argmax
    (first index on ties, as jnp.argmax)."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[:, -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)
