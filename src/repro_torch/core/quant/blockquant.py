"""Walk a param tree's linears (the part of ``repro.core.quant.blockquant``
the deploy transform needs; the calibrated per-block drivers come with GPTQ
in a later slice)."""
from __future__ import annotations

from typing import Iterator


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
