"""Round-to-nearest baseline quantizer (Table 4 of the paper; port of
``repro.core.quant.rtn``)."""
from __future__ import annotations

import torch

from repro_torch.core.quant.types import QuantizedTensor, quantize


def rtn_quantize(w: torch.Tensor, *, bits: int, group_size: int = -1,
                 act_bits: int = 0) -> QuantizedTensor:
    """RTN for (K, N) or stacked (..., K, N) weights."""
    return quantize(w, bits, group_size, act_bits)
