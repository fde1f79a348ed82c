"""Token sampling and speculative acceptance for the serving engine (port
of ``repro.serve.sampling``).

Greedy decoding and greedy acceptance are bit-exact against the JAX
package. Temperature and top-k draw from an explicit ``torch.Generator``:
the same distribution as ``jax.random.categorical``, never the same random
bits. The sampled acceptance rule is split in two so that a test can feed
it the JAX package's own draws: ``spec_draws`` makes the draws (the
uniforms, the residual tokens, the bonus token) and
``spec_accept_with_draws`` applies the rule to them.
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
    probs = torch.softmax(_filtered(logits, temperature, top_k), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def _filtered(logits: torch.Tensor, temperature: float,
              top_k: int) -> torch.Tensor:
    """The temperature and top-k filter ``sample`` applies, over any
    leading dims: acceptance compares the filtered draft and target
    distributions."""
    logits = logits.to(torch.float32) / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, -1e30, logits)
    return logits


def spec_accept_greedy(target_logits: torch.Tensor,
                       draft_tokens: torch.Tensor):
    """Greedy speculative acceptance. target_logits (S, M, V): row m is the
    target's next-token distribution after the emitted prefix and m
    verified tokens; draft_tokens (S, M - 1), the draft's proposals fed as
    verify rows 1..M-1. Returns (out (S, M) int32, n_emit (S,) int32):
    emit out[:, :n_emit], the target's argmaxes, so the stream is the
    target-only greedy stream whatever the draft proposed. n_emit is the
    leading run of matching drafts plus one (the target's own token at the
    first mismatch)."""
    t = torch.argmax(target_logits, dim=-1).to(torch.int32)       # (S, M)
    s, m = t.shape
    if m == 1:
        return t, torch.ones(s, dtype=torch.int32, device=t.device)
    match = (draft_tokens.to(torch.int32) == t[:, :-1]).to(torch.int32)
    n_acc = torch.cumprod(match, dim=-1).sum(dim=-1)
    return t, (n_acc + 1).to(torch.int32)


def _probs(target_logits, draft_logits, temperature, top_k):
    pt = torch.softmax(_filtered(target_logits, temperature, top_k), -1)
    pd = torch.softmax(_filtered(draft_logits, temperature, top_k), -1)
    return pt, pd


def spec_draws(target_logits: torch.Tensor, draft_logits: torch.Tensor, *,
               temperature: float, top_k: int = 0,
               generator: Optional[torch.Generator] = None):
    """The draws of the sampled rule: uniforms u (S, M - 1), a token from
    each row's residual normalize(max(p_t - p_d, 0)) (S, M - 1) (p_t where
    the residual has no mass), and the bonus token (S,) sampled from the
    last target row. At M == 1 only the bonus is drawn."""
    s, m, _ = target_logits.shape
    dev = target_logits.device
    bonus = sample(target_logits[:, -1], temperature=temperature,
                   top_k=top_k, generator=generator)
    if m == 1:
        empty = torch.zeros((s, 0), device=dev)
        return empty, empty.to(torch.int32), bonus
    pt, pd = _probs(target_logits, draft_logits, temperature, top_k)
    u = torch.rand((s, m - 1), generator=generator, device=dev)
    res = torch.clamp_min(pt[:, :-1] - pd, 0.0)
    mass = res.sum(dim=-1, keepdim=True)
    res = torch.where(mass > 0, res / mass.clamp_min(1e-30), pt[:, :-1])
    res_tok = torch.multinomial(res.reshape(s * (m - 1), -1), 1,
                                generator=generator).reshape(s, m - 1)
    return u, res_tok.to(torch.int32), bonus


def spec_accept_with_draws(target_logits: torch.Tensor,
                           draft_logits: torch.Tensor,
                           draft_tokens: torch.Tensor, u: torch.Tensor,
                           res_tok: torch.Tensor, bonus: torch.Tensor, *,
                           temperature: float, top_k: int = 0):
    """The sampled rule (Leviathan et al., Chen et al.) on given draws:
    accept draft d_i while u_i * p_d(d_i) < p_t(d_i); at the first
    rejection emit that row's residual token, and when every draft
    survives the bonus token. The stream is distributed as target-only
    sampling. Shapes as ``spec_draws``; draft_logits (S, M - 1, V) is
    what d_1..d_{M-1} were sampled from. Returns (out (S, M) int32, n_emit
    (S,) int32); out is 0 past n_emit."""
    s, m, _ = target_logits.shape
    dev = target_logits.device
    out = torch.zeros((s, m), dtype=torch.int32, device=dev)
    if m == 1:
        out[:, 0] = bonus.to(torch.int32)
        return out, torch.ones(s, dtype=torch.int32, device=dev)
    pt, pd = _probs(target_logits, draft_logits, temperature, top_k)
    d = draft_tokens.to(torch.int64)[..., None]
    p_t_d = torch.gather(pt[:, :-1], -1, d)[..., 0]               # (S, M-1)
    p_d_d = torch.gather(pd, -1, d)[..., 0]
    accept = (u * p_d_d < p_t_d).to(torch.int32)
    n_acc = torch.cumprod(accept, dim=-1).sum(dim=-1)             # (S,)
    idx = torch.arange(m, device=dev)[None, :]
    res_at = torch.gather(res_tok.to(torch.int32), -1,
                          n_acc.clamp_max(m - 2)[:, None].to(torch.int64))
    final = torch.where(n_acc[:, None] == m - 1,
                        bonus.to(torch.int32)[:, None], res_at)
    drafts = torch.cat([draft_tokens.to(torch.int32),
                        torch.zeros((s, 1), dtype=torch.int32, device=dev)],
                       dim=1)
    out = torch.where(idx < n_acc[:, None], drafts,
                      torch.where(idx == n_acc[:, None], final, out))
    return out, (n_acc + 1).to(torch.int32)


def spec_accept_sample(target_logits: torch.Tensor,
                       draft_logits: torch.Tensor,
                       draft_tokens: torch.Tensor, *, temperature: float,
                       top_k: int = 0,
                       generator: Optional[torch.Generator] = None):
    """Temperature > 0 speculative acceptance: ``spec_draws`` then
    ``spec_accept_with_draws``."""
    draws = spec_draws(target_logits, draft_logits, temperature=temperature,
                       top_k=top_k, generator=generator)
    return spec_accept_with_draws(target_logits, draft_logits, draft_tokens,
                                  *draws, temperature=temperature,
                                  top_k=top_k)
