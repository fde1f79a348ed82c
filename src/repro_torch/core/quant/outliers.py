"""Outlier injection: a float-EQUIVALENT transform that reproduces the
large-LLM activation-outlier pathology in a small model (port of
``repro.core.quant.outliers``).

Large transformers develop per-channel activation outliers (LLM.int8,
SmoothQuant): a few residual-stream channels carry values 10-100x larger
than the rest, and the norm layers amplify them. Symmetric per-output-channel
weight quantization then systematically destroys the small-magnitude weight
rows that read those channels, producing the accumulating distribution
drift the paper's Figure 1 shows.

For selected channels C and factor f:
    norm.scale[C] *= f   (and bias[C] *= f)
    w[C, :]       /= f   for every linear reading the norm's output.
The float model is unchanged up to rounding; the quantized model is not.

The JAX package draws C with ``jax.random.choice``, which cannot be
reproduced bit for bit; here C comes from an explicit ``torch.Generator``
(the same distribution: ``n_channels`` distinct channels, uniformly), and
``apply_outliers`` takes C as given, so a test can hand it the JAX
package's channels.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.normtweak.pipeline import _restack
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import get_block, num_blocks
from repro_torch.utils.tree import tree_get, tree_set

# linears fed by each norm, per block layout (dense GQA decoder)
_NORM_CONSUMERS = {
    "ln1": ["attn/wq", "attn/wk", "attn/wv", "mamba/in_proj"],
    "ln2": ["mlp/wi", "mlp/wg", "moe/shared/wi", "moe/shared/wg"],
}


def _exists(tree, path):
    node = tree
    for k in path.split("/"):
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    return True


def outlier_channels(cfg: ModelConfig, n_channels: int,
                     seed: int) -> torch.Tensor:
    """``n_channels`` distinct channels of d_model, drawn uniformly from a
    CPU ``torch.Generator`` seeded with ``seed``."""
    gen = torch.Generator()
    gen.manual_seed(seed)
    return torch.randperm(cfg.d_model, generator=gen)[:n_channels]


def apply_outliers(cfg: ModelConfig, params: dict, channels,
                   factor: float) -> dict:
    """The transform for the given channels; returns new params (the input
    tree is left as it is)."""
    dev = params["embed"]["w"].device
    scale_vec = torch.ones(cfg.d_model, device=dev)
    idx = torch.as_tensor(np.array(channels, dtype=np.int64), device=dev)
    scale_vec[idx] = factor
    blocks = []
    for i in range(num_blocks(cfg)):
        bp = get_block(cfg, params, i)
        for norm_key, consumers in _NORM_CONSUMERS.items():
            if not _exists(bp, norm_key):
                continue
            npar = dict(tree_get(bp, norm_key))
            npar["scale"] = npar["scale"] * scale_vec
            if "bias" in npar:
                npar["bias"] = npar["bias"] * scale_vec
            bp = tree_set(bp, norm_key, npar)
            for c in consumers:
                if not _exists(bp, c):
                    continue
                lin = dict(tree_get(bp, c))
                lin["w"] = lin["w"] / scale_vec[:, None]
                bp = tree_set(bp, c, lin)
        blocks.append(bp)
    return _restack(cfg, params, blocks)


def inject_outliers(cfg: ModelConfig, params: dict, *, n_channels: int = 8,
                    factor: float = 40.0, seed: int = 0) -> dict:
    return apply_outliers(cfg, params,
                          outlier_channels(cfg, n_channels, seed), factor)
