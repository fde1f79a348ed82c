"""Carry a JAX param tree across to the port.

``params_from_numpy`` takes the tree ``jax.tree_util.tree_map(np.asarray,
params)`` gives: nested dicts of numpy arrays, with each packed weight an
object carrying ``qw``, ``scale``, ``bits``, ``group_size`` and ``shape``
(the JAX ``QuantizedTensor`` with numpy children, or a plain dict of those
keys). It returns the port's params under the same key paths, scan-stacked
"stack/p0" included. Packed bytes are taken as they are, so a tree packed
by either package runs in the other.
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
            if getattr(node, "act_bits", 0) or (
                    isinstance(node, dict) and node.get("act_bits", 0)):
                raise NotImplementedError(
                    "W8A8 (act_bits) weights are not ported yet")
            return QuantizedTensor(
                torch.from_numpy(np.array(_field(node, "qw"), np.uint8)).to(dev),
                torch.from_numpy(np.array(_field(node, "scale"),
                                          np.float32)).to(dev),
                int(_field(node, "bits")), int(_field(node, "group_size")),
                tuple(int(d) for d in _field(node, "shape")))
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(dev)

    return conv(tree)
