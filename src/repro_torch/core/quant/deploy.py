"""Deployment transform: pack a float param tree to low-bit weights (RTN).

Port of ``repro.core.quant.deploy``. Every quantizable linear — the
scan-stacked (L, K, N) weights included — becomes a ``QuantizedTensor``
whose bytes equal the JAX package's for the same float weights.
"""
from __future__ import annotations

from repro_torch.core.quant.blockquant import iter_linears
from repro_torch.core.quant.types import quantize_stacked
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig

_SKIP = ("embed", "lm_head", "pos", "router", "conv")


def _tree_set(tree: dict, path: str, value) -> dict:
    keys = path.split("/")

    def rec(node, i):
        if i == len(keys):
            return value
        new = dict(node)
        new[keys[i]] = rec(node[keys[i]], i + 1)
        return new

    return rec(tree, 0)


def quantize_params_for_serving(cfg: ModelConfig, params: dict,
                                bits: int = 0, group_size: int = 0,
                                device="cuda") -> dict:
    """Pack every quantizable linear for serving on ``device``.

    ``bits`` 0 takes ``cfg.serve_quant_bits`` (0 there too: nothing is
    packed); ``group_size`` 0 takes ``cfg.serve_quant_group`` and -1 means
    per-channel. A linear whose K is not a multiple of the group falls
    back to per-channel scales, as in the JAX package. The input tree is
    not modified."""
    dev = resolve_device(device)
    bits = bits or cfg.serve_quant_bits
    group_size = group_size or cfg.serve_quant_group
    params = to_device(params, dev)
    if not bits:
        return params
    for path, lin in list(iter_linears(params, max_ndim=4)):
        if any(s in path for s in _SKIP):
            continue
        w = lin["w"]
        if w.shape[-2] % (group_size if group_size > 0 else 1):
            gs = -1  # per-channel when K isn't a multiple of the group
        else:
            gs = group_size
        new_lin = dict(lin)
        new_lin["w"] = quantize_stacked(w, bits, gs)
        params = _tree_set(params, path, new_lin)
    return params


def to_device(tree, dev):
    """The tree with every tensor (and packed weight) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)
