"""Learning-rate schedules (port of ``repro.optim.schedules``).

Each schedule is a function of an int step that returns a float. The
arithmetic is f32, as the JAX package's ``jnp`` version computes it (its
Python constants are cast to f32 at each operation), so a cosine at f32
matches the reference where Python's float64 would not.
"""
from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: float(_f32(lr))


def warmup_cosine(peak: float, warmup: int, total: int, floor: float = 0.0):
    def fn(step: int) -> float:
        s = _f32(float(step))
        if s < warmup:
            return float(_f32(peak) * s / _f32(max(warmup, 1)))
        prog = torch.clamp((s - _f32(warmup)) / _f32(max(total - warmup, 1)),
                           0.0, 1.0)
        cos = _f32(floor) + _f32((peak - floor) * 0.5) * (
            _f32(1.0) + torch.cos(_f32(math.pi) * prog))
        return float(cos)
    return fn


def linear_decay(peak: float, total: int, floor: float = 0.0):
    def fn(step: int) -> float:
        prog = torch.clamp(_f32(float(step)) / _f32(max(total, 1)), 0.0,
                           1.0)
        return float(_f32(peak) + _f32(floor - peak) * prog)
    return fn
