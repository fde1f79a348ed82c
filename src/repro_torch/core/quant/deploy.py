"""Deployment transform: pack a float param tree to low-bit weights (RTN).

Port of ``repro.core.quant.deploy``. Every quantizable linear — the
scan-stacked (L, K, N) weights and (L, E, K, N) MoE experts included —
becomes a ``QuantizedTensor`` whose bytes equal the JAX package's for the
same float weights; experts pack to (L, E, packed_rows(K), N). Routers,
embeddings and the LM head stay float.
"""
from __future__ import annotations

from repro_torch.core.quant.blockquant import iter_linears
from repro_torch.core.quant.types import quantize
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig
from repro_torch.utils.tree import tree_set

_SKIP = ("embed", "lm_head", "pos", "router", "conv")


def quantize_params_for_serving(cfg: ModelConfig, params: dict,
                                bits: int = 0, group_size: int = 0,
                                act_bits: int = 0, device="cuda") -> dict:
    """Pack every quantizable linear for serving on ``device``.

    ``bits`` 0 takes ``cfg.serve_quant_bits`` (0 there too: nothing is
    packed); ``group_size`` 0 takes ``cfg.serve_quant_group`` and -1 means
    per-channel. A linear whose K is not a multiple of the group falls
    back to per-channel scales, as in the JAX package. ``act_bits`` 8 tags
    every packed tensor for the per-token int8 activation path (the W8A8
    kernels: RTN W4A8 / W8A8). The input tree is not modified."""
    dev = resolve_device(device)
    bits = bits or cfg.serve_quant_bits
    group_size = group_size or cfg.serve_quant_group
    if act_bits not in (0, 8):
        raise NotImplementedError(f"act_bits={act_bits}: only per-token "
                                  "int8 activations (8) are ported")
    params = to_device(params, dev)
    if not bits:
        if act_bits:
            raise ValueError("act_bits needs bits (the A8 tag lives on "
                             "packed weights)")
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
        new_lin["w"] = quantize(w, bits, gs, act_bits)
        params = tree_set(params, path, new_lin)
    return params


def to_device(tree, dev):
    """The tree with every tensor (and packed weight) on ``dev``."""
    if isinstance(tree, dict):
        return {k: to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)
