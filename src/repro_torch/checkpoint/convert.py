"""Carry a JAX param tree across to the port.

``params_from_numpy`` takes the tree ``jax.tree_util.tree_map(np.asarray,
params)`` gives: nested dicts of numpy arrays, with each packed weight an
object carrying ``qw``, ``scale``, ``bits``, ``group_size`` and ``shape``
(the JAX ``QuantizedTensor`` with numpy children, or a plain dict of those
keys). It returns the port's params under the same key paths, scan-stacked
"stack/p0" and the unstacked "prefix/0", ... blocks (DeepSeek's dense
first layer) included, and the per-block (unstacked) trees of the
quantization pipeline alike; MLA's wq, wdkv, wukv and wo come across as
any linear, packed or float, and its latent norm "kvnorm" as any norm; an MoE's router and float (E, K, N) expert
stacks come across as tensors, its packed experts as (E, K, N) or
layer-stacked (L, E, K, N) ``QuantizedTensor`` leaves. Every other leaf
comes across as it is: the learned position table ("pos"), the linears'
biases ("b"), the norms' "scale" and LayerNorm "bias", and a mamba
block's f32 "conv_w", "conv_b", "A_log", "D", "dt_bias" and its gated
norm "gnorm/scale". Packed bytes are
taken as they are, and ``act_bits`` (8: the W8A8 path) is carried across,
so a tree packed by either package runs in the other.
``params_to_numpy`` is the way back: the same key paths as numpy arrays,
each packed weight a dict of the ``QuantizedTensor`` fields.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.device import resolve_device

_QT_FIELDS = ("qw", "scale", "bits", "group_size", "shape")


def _field(leaf, name):
    return leaf[name] if isinstance(leaf, dict) else getattr(leaf, name)


def _is_packed(leaf) -> bool:
    if isinstance(leaf, dict):
        return all(f in leaf for f in _QT_FIELDS)
    return all(hasattr(leaf, f) for f in _QT_FIELDS)


def params_from_numpy(tree, device="cuda"):
    dev = resolve_device(device)

    def conv(node):
        if _is_packed(node):
            act_bits = (node.get("act_bits", 0) if isinstance(node, dict)
                        else getattr(node, "act_bits", 0))
            if act_bits not in (0, 8):
                raise NotImplementedError(
                    f"act_bits={act_bits}: only the per-token int8 path "
                    "(8) is ported")
            qw = np.array(_field(node, "qw"), np.uint8)
            # leading (layer) dims from the codes: a JAX tree stacked by
            # the pipeline keeps each layer's (K, N) as its static shape
            shape = qw.shape[:-2] + tuple(
                int(d) for d in _field(node, "shape")[-2:])
            return QuantizedTensor(
                torch.from_numpy(qw).to(dev),
                torch.from_numpy(np.array(_field(node, "scale"),
                                          np.float32)).to(dev),
                int(_field(node, "bits")), int(_field(node, "group_size")),
                tuple(shape), int(act_bits))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(dev)

    return conv(tree)


def params_to_numpy(tree):
    """The port's params (or any subtree) as nested dicts of numpy arrays on
    the host; a packed weight becomes {"qw", "scale", "bits",
    "group_size", "shape", "act_bits"}, which ``params_from_numpy`` takes
    back."""
    if isinstance(tree, QuantizedTensor):
        return {"qw": tree.qw.cpu().numpy(), "scale": tree.scale.cpu().numpy(),
                "bits": tree.bits, "group_size": tree.group_size,
                "shape": tuple(tree.shape), "act_bits": tree.act_bits}
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    return tree.detach().cpu().numpy()
