"""AWQ (Lin et al. 2023): activation-aware weight quantization (port of
``repro.core.quant.awq``).

Per-input-channel scales s = amax_x^alpha protect salient weight channels;
alpha is grid-searched to minimize the *output* reconstruction error on
calibration activations. Like SmoothQuant the scale is an exact float
transform (folded into the producing norm); unlike SmoothQuant it serves
weight-only quantization. The paper's Table 10 puts norm tweaking on top
of AWQ: here it is one more base quantizer of the pipeline.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.types import fake_quant


def awq_search_scales(x: torch.Tensor, ws: list, *, bits: int,
                      group_size: int = -1, n_grid: int = 9):
    """x: (..., K) calibration input shared by ``ws`` ((K, N) weights);
    returns (s (K,), alpha): the first grid point with the least summed
    output MSE (a strict ``<``, as in the JAX package)."""
    xf = x.reshape(-1, x.shape[-1]).to(torch.float32)
    amax = xf.abs().amax(dim=0).clamp_min(1e-5)
    wfs = [w.to(torch.float32) for w in ws]
    # the float outputs do not depend on alpha
    ys = [xf @ wf for wf in wfs]
    best = (None, float("inf"), 0.0)
    for i in range(n_grid):
        alpha = i / (n_grid - 1)
        s = amax ** alpha
        s = s / torch.sqrt((s.max() * s.min()).clamp_min(1e-10))
        s = s.clamp(1e-4, 1e4)
        err = 0.0
        for wf, y in zip(wfs, ys):
            wq = fake_quant(wf * s[:, None], bits, group_size) / s[:, None]
            err += torch.mean((y - xf @ wq) ** 2)
        err = float(err)
        if err < best[1]:
            best = (s, err, alpha)
    return best[0], best[2]
