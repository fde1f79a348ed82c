"""Training step: loss -> grads -> clip -> Adam (port of
``repro.train.train_step``), with microbatched gradient accumulation.

The JAX package jits the step and scans over microbatches; here the step
is a Python function. Gradients come from ``torch.autograd.grad`` over
the param leaves (each a detached copy that requires grad, as the norm
tweak tracks its norm leaves); accumulated microbatch gradients are summed
in f32 and divided by ``accum_steps``, as the reference does. The JAX
step's gradient compression (``grad_compress_bits``, an int8/4 all-reduce
with error feedback) is not ported yet: ROADMAP.md queue 1 item 7.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import lm_loss
from repro_torch.optim.adam import adam_init, adam_update, clip_by_global_norm
from repro_torch.utils.tree import tree_map


def _refuse_compression(grad_compress_bits: int) -> None:
    if grad_compress_bits:
        raise NotImplementedError(
            f"grad_compress_bits={grad_compress_bits}: gradient compression "
            "(optim/compression.py) is not ported yet (ROADMAP.md queue 1 "
            "item 7)")


def _grads_of(cfg, loss_fn, params: dict, batch: dict):
    """(loss, metrics, grads) of ``loss_fn`` at ``params``; the grads tree
    has the params' structure."""
    leaves = []

    def track(t):
        t = t.detach().requires_grad_(True)
        leaves.append(t)
        return t

    tracked = tree_map(track, params)
    loss, metrics = loss_fn(cfg, tracked, batch)
    grads = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(grads), tracked))


def make_train_step(cfg: ModelConfig, *,
                    lr_schedule: Callable[[int], float],
                    clip_norm: float = 1.0,
                    weight_decay: float = 0.0,
                    accum_steps: int = 1,
                    grad_compress_bits: int = 0,
                    loss_fn=None):
    """Returns step(params, opt_state, batch, step_idx, rng=None) ->
    (new_params, new_opt_state, metrics). ``batch`` holds int tensors on
    the params' device; the metrics are 0-d tensors there (``lr`` a
    float). ``rng`` is accepted for the JAX step's signature and unused."""
    _refuse_compression(grad_compress_bits)
    loss_fn = loss_fn or lm_loss

    def step(params, opt_state, batch, step_idx: int, rng=None):
        if accum_steps > 1:
            gacc = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                                  device=p.device), params)
            lacc = torch.zeros((), device=batch["tokens"].device)
            for i in range(accum_steps):
                mb = {k: v.reshape(accum_steps, v.shape[0] // accum_steps,
                                   *v.shape[1:])[i] for k, v in batch.items()}
                loss, _, grads = _grads_of(cfg, loss_fn, params, mb)
                gacc = tree_map(torch.add, gacc, grads)
                lacc = lacc + loss
            grads = tree_map(lambda g: g / accum_steps, gacc)
            loss = lacc / accum_steps
            metrics = {"nll": loss, "aux": torch.zeros_like(loss)}
        else:
            loss, metrics, grads = _grads_of(cfg, loss_fn, params, batch)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_schedule(step_idx)
        new_params, new_adam = adam_update(grads, opt_state["adam"], params,
                                           lr=lr, weight_decay=weight_decay)
        new_state = dict(opt_state)
        new_state["adam"] = new_adam
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return new_params, new_state, metrics

    return step


def init_opt_state(cfg: ModelConfig, params,
                   grad_compress_bits: int = 0) -> dict:
    _refuse_compression(grad_compress_bits)
    return {"adam": adam_init(params)}
