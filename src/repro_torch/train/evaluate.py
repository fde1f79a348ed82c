"""Evaluation: perplexity over a token stream + last-token accuracy (port
of ``repro.train.evaluate``; the offline LAMBADA analogue: predict the
final token of each held-out window).

Runs under ``torch.no_grad()`` on the device of the params, float or
packed: on a packed tree every linear runs the dequant-matmul kernel (its
plain version on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import lm_forward


def _nll_batch(cfg: ModelConfig, params: dict, tokens: torch.Tensor,
               labels: torch.Tensor):
    logits, _ = lm_forward(cfg, params, tokens)
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels.to(torch.int64)[..., None])[..., 0]
    nll = lse - ll
    correct_last = torch.argmax(logits[:, -1, :], dim=-1) == labels[:, -1]
    return torch.sum(nll), nll.numel(), torch.sum(correct_last), \
        correct_last.numel()


@torch.no_grad()
def perplexity(cfg: ModelConfig, params: dict, tokens: np.ndarray, *,
               seq_len: int = 128, batch_size: int = 8,
               max_windows: int = 64) -> dict:
    """Sliding non-overlapping windows; returns {'ppl', 'nll', 'last_acc'}."""
    dev = params["embed"]["w"].device
    n_win = min((len(tokens) - 1) // seq_len, max_windows)
    tot_nll, tot_cnt, tot_corr, tot_last = 0.0, 0, 0.0, 0
    for b0 in range(0, n_win, batch_size):
        bn = min(batch_size, n_win - b0)
        idx = np.arange(b0, b0 + bn) * seq_len
        toks = np.stack([tokens[s:s + seq_len] for s in idx])
        labs = np.stack([tokens[s + 1:s + seq_len + 1] for s in idx])
        s_nll, cnt, s_corr, n_last = _nll_batch(
            cfg, params, torch.as_tensor(toks, dtype=torch.int32, device=dev),
            torch.as_tensor(labs, dtype=torch.int32, device=dev))
        tot_nll += float(s_nll)
        tot_cnt += int(cnt)
        tot_corr += float(s_corr)
        tot_last += int(n_last)
    nll = tot_nll / max(tot_cnt, 1)
    return {"ppl": float(np.exp(min(nll, 30.0))), "nll": nll,
            "last_acc": tot_corr / max(tot_last, 1)}
