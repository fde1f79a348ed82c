"""Calibration data generation (paper §Calibration Data Generation; port
of ``repro.core.calibration.generator``).

Two-stage self-generation (LLM-QAT): the first ``stochastic_prefix``
tokens are drawn from the softmax distribution (temperature 1), the rest
greedily, so the generated text both activates the model's "neurons" and
stays coherent. ``allowed_first`` restricts the first token (the paper's
language-scope restriction). Random draws come from an explicit
``torch.Generator``: the same distributions as the JAX package's
``jax.random`` draws, never the same bits. Generation decodes token by
token on a contiguous cache, which carries a mamba layer's recurrent
state as it carries attention's KV.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_contiguous_cache, lm_decode


@torch.no_grad()
def _generate_batch(cfg: ModelConfig, params: dict,
                    first_tokens: torch.Tensor, generator: torch.Generator,
                    length: int, stochastic_prefix: int = 4,
                    temperature: float = 1.0) -> torch.Tensor:
    """(B,) first tokens -> (B, length) tokens, the first column being
    ``first_tokens``: step t feeds token t at position t and draws token
    t + 1, sampled while t < stochastic_prefix, else the argmax (first
    index on ties, as ``jnp.argmax``)."""
    b = first_tokens.shape[0]
    dev = first_tokens.device
    cache = init_contiguous_cache(cfg, b, length, dev)
    tok = first_tokens.to(torch.int32)[:, None]
    out = []
    for t in range(length):
        out.append(tok[:, 0])
        pos = torch.full((b, 1), t, dtype=torch.int32, device=dev)
        logits = lm_decode(cfg, params, tok, cache, pos)
        if t < stochastic_prefix:
            probs = torch.softmax(logits / temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            nxt = torch.argmax(logits, dim=-1)
        tok = nxt.to(torch.int32)[:, None]
    return torch.stack(out, dim=1)


def generate_calibration(cfg: ModelConfig, params: dict,
                         generator: torch.Generator, *, n_samples: int,
                         token_length: int,
                         allowed_first: Optional[np.ndarray] = None,
                         stochastic_prefix: int = 4,
                         batch_size: int = 16) -> torch.Tensor:
    """Self-generated calibration set (n_samples, token_length) int32, on
    the generator's device (the params' device)."""
    dev = generator.device
    out = []
    done = 0
    while done < n_samples:
        b = min(batch_size, n_samples - done)
        if allowed_first is not None:
            allowed = torch.as_tensor(np.asarray(allowed_first),
                                      dtype=torch.int32, device=dev)
            idx = torch.randint(0, len(allowed), (b,), generator=generator,
                                device=dev)
            first = allowed[idx]
        else:
            first = torch.randint(0, cfg.vocab_size, (b,),
                                  generator=generator, device=dev,
                                  dtype=torch.int32)
        out.append(_generate_batch(cfg, params, first, generator,
                                   token_length, stochastic_prefix))
        done += b
    return torch.cat(out, dim=0)


def random_calibration(cfg: ModelConfig, generator: torch.Generator, *,
                       n_samples: int, token_length: int) -> torch.Tensor:
    return torch.randint(0, cfg.vocab_size, (n_samples, token_length),
                         generator=generator, device=generator.device,
                         dtype=torch.int32)


def real_calibration(corpus: np.ndarray, generator: torch.Generator, *,
                     n_samples: int, token_length: int) -> torch.Tensor:
    """``n_samples`` corpus windows of ``token_length`` tokens, at
    window-aligned starts drawn uniformly from the generator, as int32 on
    its device."""
    n_windows = (len(corpus) - 1) // token_length
    idx = torch.randint(0, n_windows, (n_samples,), generator=generator,
                        device=generator.device)
    starts = idx.cpu().numpy() * token_length
    return torch.as_tensor(
        np.stack([corpus[s:s + token_length] for s in starts]),
        dtype=torch.int32, device=generator.device)
