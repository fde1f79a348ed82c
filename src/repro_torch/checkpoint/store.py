"""Checkpoint store: nested-dict trees (``QuantizedTensor`` leaves
included) to an npz + JSON-manifest directory, written atomically (tmp
dir + rename) so a failure mid-save never corrupts the latest checkpoint
(port of ``repro.checkpoint.store``: ``save_tree`` / ``load_tree``).

The format is the JAX package's: ``arrays.npz`` holds every array under
its '/'-joined key path, ``meta.json`` the non-array leaves ("scalars")
and the caller's ``extra``; a packed weight is the tagged dict
``{"__quantized_tensor__": {qw, scale, bits, group_size, shape,
act_bits}}``. So a tree saved by either package loads in the other.

Stacked packed weights. The port's tree holds a layer-stacked weight's
shape as (L, K, N), or (L, E, K, N) for an expert stack; the reference's
pipeline keeps the per-layer (K, N) (or (E, K, N)) under (L, ...) codes,
and its serving deploy the full (L, K, N). ``save_tree`` writes the
shape below the layer dim for a weight under "stack/", what the
reference's pipeline writes; ``load_tree`` reads either, taking the
leading dims from the codes and the trailing (K, N) from the shape.

Engine snapshots (``save_snapshot`` / ``load_snapshot``) have a codec of
their own, the JAX package's: ``ContinuousEngine.snapshot()`` is a nested
structure (dicts with int keys, tuples, bytes, arrays at any depth) that
'/'-joined paths cannot hold, so the arrays go into one npz and the rest
into a tagged JSON manifest that decodes to the same structure, key types
and tuples included (format tag ``engine-snapshot-v1``). A bf16 array is
stored as its uint16 bits, tagged "bfloat16", as the JAX package stores
it; numpy has no bf16, so the port reads such an array back as a bf16
tensor. A snapshot written by either package decodes in the other.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.device import resolve_device

_QT_KEY = "__quantized_tensor__"


def _host(x) -> np.ndarray:
    """A host copy of a tensor (or an array as it is)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True).numpy()
    return np.asarray(x)


def to_plain(tree: Any, stacked: bool = False) -> Any:
    """QuantizedTensor -> tagged dict of host arrays; tensors -> host
    arrays; other leaves as they are."""
    if isinstance(tree, QuantizedTensor):
        shape = list(tree.shape[1:] if stacked else tree.shape)
        return {_QT_KEY: {"qw": _host(tree.qw), "scale": _host(tree.scale),
                          "bits": tree.bits, "group_size": tree.group_size,
                          "shape": shape, "act_bits": tree.act_bits}}
    if isinstance(tree, dict):
        return {k: to_plain(v, stacked or k == "stack")
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return _host(tree)
    return tree


def _flatten(tree: Any, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k):
                raise ValueError(f"key {k} contains '/'")
            out.update(_flatten(v, f"{prefix}{k}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def save_tree(path: str, tree: Any, extra_meta: dict | None = None) -> None:
    """Write ``tree`` (tensors on any device, numpy arrays, packed weights,
    JSON scalars) to the directory ``path``, replacing it atomically."""
    flat = _flatten(to_plain(tree))
    arrays, scalars = {}, {}
    for k, v in flat.items():
        if isinstance(v, np.ndarray):
            arrays[k] = v
        else:
            scalars[k] = v
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".ckpt_tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
        meta = {"scalars": scalars, "extra": extra_meta or {}}
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def _from_plain(tree: Any, dev: torch.device) -> Any:
    if isinstance(tree, dict):
        if _QT_KEY in tree:
            d = tree[_QT_KEY]
            qw = torch.from_numpy(np.asarray(d["qw"], np.uint8)).to(dev)
            # leading (layer) dims from the codes, (K, N) from the shape
            shape = tuple(qw.shape[:-2]) + tuple(int(x)
                                                 for x in d["shape"][-2:])
            return QuantizedTensor(
                qw, torch.from_numpy(np.asarray(d["scale"],
                                                np.float32)).to(dev),
                int(d["bits"]), int(d["group_size"]), shape,
                int(d.get("act_bits", 0)))
        return {k: _from_plain(v, dev) for k, v in tree.items()}
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree).to(dev)
    return tree


# ------------------------------------------------------- engine snapshots

_ND, _TUP, _BYTES, _ITEMS, _BF16 = ("__nd__", "__tuple__", "__bytes__",
                                    "__items__", "bfloat16")
_SNAP_FORMAT = "engine-snapshot-v1"


def _snap_encode(obj: Any, arrays: list) -> Any:
    if isinstance(obj, (torch.Tensor, np.ndarray)):
        arrays.append(obj)
        return {_ND: len(arrays) - 1}
    if isinstance(obj, np.generic):
        return _snap_encode(obj.item(), arrays)
    if isinstance(obj, bytes):
        return {_BYTES: obj.hex()}
    if isinstance(obj, tuple):
        return {_TUP: [_snap_encode(v, arrays) for v in obj]}
    if isinstance(obj, list):
        return [_snap_encode(v, arrays) for v in obj]
    if isinstance(obj, dict):
        # (key, value) pairs: int slot and rid keys stay ints
        return {_ITEMS: [[_snap_encode(k, arrays), _snap_encode(v, arrays)]
                         for k, v in obj.items()]}
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    raise TypeError(f"snapshot codec cannot serialize {type(obj)!r}")


def _snap_decode(obj: Any, arrays: dict) -> Any:
    if isinstance(obj, dict):
        if _ND in obj:
            return arrays[f"a{obj[_ND]}"]
        if _BYTES in obj:
            return bytes.fromhex(obj[_BYTES])
        if _TUP in obj:
            return tuple(_snap_decode(v, arrays) for v in obj[_TUP])
        if set(obj) != {_ITEMS}:
            raise ValueError(f"unknown snapshot node {set(obj)}")
        return {_snap_decode(k, arrays): _snap_decode(v, arrays)
                for k, v in obj[_ITEMS]}
    if isinstance(obj, list):
        return [_snap_decode(v, arrays) for v in obj]
    return obj


def save_snapshot(path: str, snap: Any) -> None:
    """Write an engine snapshot (host numpy arrays or tensors on any
    device at any depth) to the directory ``path``, atomically."""
    arrays: list = []
    manifest = _snap_encode(snap, arrays)
    named, dtypes = {}, {}
    for i, a in enumerate(arrays):
        if isinstance(a, torch.Tensor):
            a = a.detach().to("cpu")
            if a.dtype == torch.bfloat16:
                dtypes[f"a{i}"] = _BF16
                a = a.view(torch.int16).numpy().view(np.uint16)
            else:
                a = a.numpy()
        named[f"a{i}"] = a
    parent = os.path.dirname(path) or "."
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=parent, prefix=".snap_tmp_")
    try:
        np.savez(os.path.join(tmp, "arrays.npz"), **named)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump({"manifest": manifest, "dtypes": dtypes,
                       "format": _SNAP_FORMAT}, f)
        if os.path.exists(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)


def load_snapshot(path: str) -> Any:
    """Inverse of ``save_snapshot``: the structure ``snapshot()`` returned,
    arrays as numpy (a bf16 one as a CPU bf16 tensor)."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("format") != _SNAP_FORMAT:
        raise ValueError(f"{path}: not an engine snapshot")
    arrays = {}
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        for k in npz.files:
            a = npz[k]
            if meta["dtypes"].get(k) == _BF16:
                a = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            arrays[k] = a
    return _snap_decode(meta["manifest"], arrays)


def load_tree(path: str, device="cuda") -> tuple[Any, dict]:
    """Returns (tree with tensors on ``device``, the saved ``extra``)."""
    dev = resolve_device(device)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, "arrays.npz")) as npz:
        flat: dict[str, Any] = {k: npz[k] for k in npz.files}
    flat.update(meta["scalars"])
    tree: dict = {}
    for key, val in flat.items():
        node = tree
        parts = key.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _from_plain(tree, dev), meta["extra"]
