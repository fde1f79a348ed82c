"""Training step: loss -> grads -> (optional compression) -> clip ->
Adam (port of ``repro.train.train_step``), with microbatched gradient
accumulation.

The JAX package jits the step and scans over microbatches; here the step
is a Python function. Gradients come from ``torch.autograd.grad`` over
the param leaves (each a detached copy that requires grad, as the norm
tweak tracks its norm leaves); accumulated microbatch gradients are summed
in f32 and divided by ``accum_steps``, as the reference does.

Data parallelism. Under a mesh with data axes ("pod", "data"; the
launcher's ``sharding_ctx``) the step takes the global batch, computes
gradients on this rank's rows of it, and all-reduces them to their mean
over the data ranks before anything else: the JAX package's step sees
the global batch under GSPMD and gets the same mean. So every rank then
compresses the same tensor with the same generator, and the params stay
identical across ranks. The loss is the ranks' mean too.

Dtypes follow the JAX package's: params and activations in the config's
``pdtype`` / ``adtype`` (bf16 too), grads in the params' dtype, clipping
promoting them to f32, Adam's moments and update in f32, each param
rounded back to its dtype. ``cfg.remat`` recomputes each repeat in the
backward pass (``models/transformer.py::_run_stack``).

``grad_compress_bits`` (8 or 4; any width, as in the JAX package)
compresses the gradients with stochastic
rounding and error feedback (optim/compression.py), whose residual rides
in ``opt_state["ef"]``, then clips, as in the JAX package.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.distributed import collectives as coll
from repro_torch.distributed.sharding import active_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import lm_loss
from repro_torch.optim.adam import adam_init, adam_update, clip_by_global_norm
from repro_torch.optim.compression import compress_decompress
from repro_torch.utils.tree import tree_map

DATA_AXES = ("pod", "data")


def _data_axes() -> tuple:
    """The active mesh's data axes of more than one rank."""
    mesh = active_mesh()
    if mesh is None:
        return ()
    return tuple(a for a in DATA_AXES if mesh.shape.get(a, 1) > 1)


def _local_rows(batch: dict, axes: tuple) -> dict:
    """This rank's rows of the global batch: the batch split over the data
    axes in rank order (row-major over them)."""
    mesh = active_mesh()
    n, idx = 1, 0
    for a in axes:
        n *= mesh.shape[a]
        idx = idx * mesh.shape[a] + mesh.axis_index(a)
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"a global batch of {b} rows does not split over "
                         f"{n} data ranks")
    return {k: v[idx * (b // n):(idx + 1) * (b // n)]
            for k, v in batch.items()}


def _mean_over(tree, axes: tuple):
    """Every leaf's mean over the data ranks."""
    for a in axes:
        tree = tree_map(lambda t: coll.all_reduce(t, a, op="mean"), tree)
    return tree


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
    """Returns step(params, opt_state, batch, step_idx, rng=None,
    noise=None) -> (new_params, new_opt_state, metrics). ``batch`` holds
    int tensors on the params' device; the metrics are 0-d tensors there
    (``lr`` a float). ``rng`` (a ``torch.Generator`` on the params'
    device) draws the compression's rounding noise; ``noise`` (a tree like
    the params) gives it instead. Both are unused without compression."""
    loss_fn = loss_fn or lm_loss

    def step(params, opt_state, batch, step_idx: int, rng=None, noise=None):
        axes = _data_axes()
        if axes and cfg.fsdp:
            raise NotImplementedError(
                "fsdp: a data-parallel step over params split on the data "
                "axis needs their all-gathers around every layer, which "
                "the JAX package gets from XLA's SPMD partitioner; the "
                "port replicates params over the data ranks (fsdp=False)")
        if axes:
            batch = _local_rows(batch, axes)
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
        if axes:
            grads = _mean_over(grads, axes)
            loss = _mean_over(loss, axes)
            metrics = _mean_over(metrics, axes)
        if grad_compress_bits:
            # int8/4 compression with error feedback: the residual rides
            # in opt_state["ef"] (what a compressed all-reduce would carry)
            grads, ef = compress_decompress(grads, opt_state["ef"],
                                            bits=grad_compress_bits,
                                            rng=rng, noise=noise)
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        lr = lr_schedule(step_idx)
        new_params, new_adam = adam_update(grads, opt_state["adam"], params,
                                           lr=lr, weight_decay=weight_decay)
        new_state = dict(opt_state)
        new_state["adam"] = new_adam
        if grad_compress_bits:
            new_state["ef"] = ef
        metrics = dict(metrics)
        metrics.update({"loss": loss, "grad_norm": gnorm, "lr": lr})
        return new_params, new_state, metrics

    return step


def init_opt_state(cfg: ModelConfig, params,
                   grad_compress_bits: int = 0) -> dict:
    state = {"adam": adam_init(params)}
    if grad_compress_bits:
        state["ef"] = tree_map(lambda p: torch.zeros(
            p.shape, dtype=torch.float32, device=p.device), params)
    return state
