"""Per-block quantization driver (port of ``repro.core.quant.blockquant``):
walks a block's linear leaves, resolves the calibration activations
captured for each (taps), and applies RTN / GPTQ / SmoothQuant / AWQ, to
dense and MoE blocks alike. Routers stay float.
"""
from __future__ import annotations

from typing import Iterator, Optional

import torch

from repro_torch.core.quant.awq import awq_search_scales
from repro_torch.core.quant.gptq import (gptq_quantize,
                                         gptq_quantize_experts,
                                         hessian_from_inputs)
from repro_torch.core.quant.rtn import rtn_quantize
from repro_torch.core.quant.smoothquant import (fold_into_norm,
                                                scale_weight_rows,
                                                smooth_scales)
from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.utils.tree import tree_get, tree_set


def iter_linears(block: dict, prefix: str = "",
                 max_ndim: int = 3) -> Iterator[tuple[str, dict]]:
    """Yield (path, linear_param_dict) for every quantizable linear: a dict
    whose "w" is a tensor of 2..max_ndim dims."""
    for k, v in block.items():
        if not isinstance(v, dict):
            continue
        w = v.get("w")
        if w is not None and not isinstance(w, dict) and \
                2 <= getattr(w, "ndim", 0) <= max_ndim:
            yield prefix + k, v
        else:
            yield from iter_linears(v, prefix + k + "/", max_ndim)


def tap_key_for(path: str) -> str:
    """Map a linear param path to its calibration-tap key."""
    if path.endswith("experts/wi") or path.endswith("experts/wg"):
        return path.rsplit("/", 1)[0]                 # .../experts
    if path.endswith("experts/wo"):
        return path.rsplit("/", 1)[0] + "_out"        # .../experts_out
    return path


# norm feeding each linear group (SmoothQuant and AWQ folding): the JAX
# package's table as it is. Every row whose norm and any of whose linears
# exist is applied in turn, so the MLA row ("attn/wq", "attn/wdkv") also
# matches a GQA block through its wq: ln1 is smoothed twice there, and wk,
# wv keep only the first factor — not an exact transform for them. The
# port reproduces the reference (ROADMAP.md, queue 3 caveats).
_SMOOTH_GROUPS = [
    ("ln1", ["attn/wq", "attn/wk", "attn/wv"]),
    ("ln1", ["attn/wq", "attn/wdkv"]),                # MLA
    ("ln1", ["mamba/in_proj"]),
    ("lnx", ["xattn/wq"]),
    ("ln2", ["mlp/wi", "mlp/wg"]),
    ("ln2", ["moe/shared/wi", "moe/shared/wg"]),
]


def _exists(block: dict, path: str) -> bool:
    node = block
    for k in path.split("/"):
        if not isinstance(node, dict) or k not in node:
            return False
        node = node[k]
    return True


def _fold(block: dict, norm_path: str, lins: list,
          s: torch.Tensor) -> dict:
    """Fold per-channel scales ``s`` of one ``_SMOOTH_GROUPS`` row into the
    block: the norm divided by s, the row's linears' rows scaled by s."""
    block = tree_set(block, norm_path, fold_into_norm(
        tree_get(block, norm_path), s))
    for p in lins:
        lin = dict(tree_get(block, p))
        lin["w"] = scale_weight_rows(lin["w"], s)
        block = tree_set(block, p, lin)
    # keep routing decisions identical: compensate the router to see the
    # unscaled activations (router stays float). Only a row of the table
    # above reaches here, so an MoE without shared experts (Mixtral) folds
    # no ln2 and scales neither router nor experts
    if norm_path == "ln2" and _exists(block, "moe/router"):
        router = dict(tree_get(block, "moe/router"))
        router["w"] = scale_weight_rows(router["w"], s)
        block = tree_set(block, "moe/router", router)
    # routed experts share the ln2 input: scale their rows too
    if norm_path == "ln2" and _exists(block, "moe/experts"):
        for nm in ("wi", "wg"):
            lin = dict(tree_get(block, f"moe/experts/{nm}"))
            lin["w"] = (lin["w"].to(torch.float32)
                        * s[None, :, None]).to(lin["w"].dtype)
            block = tree_set(block, f"moe/experts/{nm}", lin)
    return block


def _groups(block: dict, taps: dict):
    """(norm path, its existing linears, their shared calibration input)
    for every row of ``_SMOOTH_GROUPS`` that applies to the block."""
    for norm_path, lin_paths in _SMOOTH_GROUPS:
        lins = [p for p in lin_paths if _exists(block, p)]
        if not lins or not _exists(block, norm_path):
            continue
        x = taps.get(tap_key_for(lins[0]))
        if x is not None:
            yield norm_path, lins, x


def smooth_block(block: dict, taps: dict, alpha: float = 0.5) -> dict:
    """Fold SmoothQuant scales into norms + weights (exact float
    transform)."""
    for norm_path, lins, x in _groups(block, taps):
        amax = x.reshape(-1, x.shape[-1]).abs().amax(dim=0)
        s = smooth_scales(amax, [tree_get(block, p)["w"] for p in lins],
                          alpha)
        block = _fold(block, norm_path, lins, s)
    return block


def awq_block(block: dict, taps: dict, *, bits: int,
              group_size: int = -1) -> dict:
    """AWQ: grid-searched activation-aware scales, folded like
    SmoothQuant's (the rows are searched and folded in table order, each
    on the weights the rows before it left)."""
    for norm_path, lins, x in _groups(block, taps):
        s, _ = awq_search_scales(x, [tree_get(block, p)["w"] for p in lins],
                                 bits=bits, group_size=group_size)
        block = _fold(block, norm_path, lins, s)
    return block


def quantize_block(block: dict, taps: Optional[dict], *,
                   method: str = "gptq", bits: int = 4,
                   group_size: int = -1, act_bits: int = 0,
                   alpha: float = 0.5, damp: float = 0.01,
                   actorder: bool = False,
                   skip_substrings: tuple = ("router",)) -> dict:
    """Quantize every linear in the block. Returns a new block tree."""
    if method not in ("gptq", "rtn", "smoothquant", "awq"):
        raise NotImplementedError(f"method {method!r} is not ported yet")
    if method in ("smoothquant", "awq") and taps is None:
        raise ValueError(f"{method} needs calibration taps")
    if method == "smoothquant":
        block = smooth_block(block, taps, alpha)
    elif method == "awq":
        block = awq_block(block, taps, bits=bits, group_size=group_size)

    for path, lin in list(iter_linears(block)):
        if any(s in path for s in skip_substrings):
            continue
        w = lin["w"]
        if isinstance(w, QuantizedTensor):
            continue
        # a K that is no multiple of the group (DeepSeek's dense d_ff
        # 10944 at g128) takes per-channel scales, the deploy's rule; the
        # JAX package raises there instead
        gs = group_size if group_size <= 0 or w.shape[-2] % group_size == 0 \
            else -1
        if method == "gptq":
            if taps is None:
                raise ValueError("GPTQ needs calibration taps")
            x = taps[tap_key_for(path)]
            kw = dict(bits=bits, group_size=gs, damp=damp,
                      actorder=actorder, act_bits=act_bits)
            if w.ndim == 3:   # experts: per-expert Hessians from (E, C, K)
                qt, _ = gptq_quantize_experts(w, x, **kw)
            else:
                qt, _ = gptq_quantize(w, hessian_from_inputs(x), **kw)
        else:  # rtn | smoothquant | awq (weights via RTN after folding)
            qt = rtn_quantize(w, bits=bits, group_size=gs,
                              act_bits=act_bits)
        new_lin = dict(lin)
        new_lin["w"] = qt
        block = tree_set(block, path, new_lin)
    return block
