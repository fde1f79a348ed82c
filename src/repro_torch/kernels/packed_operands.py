"""What the four packed-matmul kernels share: the operand check of their
wrappers, the card's limits their planners cut work to and the W8A8
kernels' int32 guard.

The dense kernels (1 and 3, ``kernels/dequant_matmul.py``) and the expert
kernels (4 and 5, ``kernels/expert_dequant_matmul.py``) import both from
here.
"""
from __future__ import annotations

import torch

from repro_torch.core.quant.types import packed_rows, qmax_for_bits

# the H100's SMs, the shared memory a block may take (bytes) and the
# grid's z limit (csrc/expert_stream.cuh, csrc/prefill_tile.cuh)
SMS = 132
MAX_SMEM = 232448
MAX_GRID_Z = 65535


def int32_sum_fits(bits: int, rows: int) -> bool:
    """True when an exact int32 sum of ``rows`` int8 x ``bits``-bit
    products cannot overflow (the W8A8 kernels' guard)."""
    return 127 * qmax_for_bits(bits) * rows < 2 ** 31


def check_operands(name: str, x: torch.Tensor, x_dtype,
                   qw: torch.Tensor, scale: torch.Tensor, *, bits: int,
                   group_size: int, k: int, experts: bool) -> None:
    """Raise ValueError on operands the packed-matmul kernels do not take:
    x (M, K) of ``x_dtype``, qw (packed_rows(K), N) uint8 and scale (G, N)
    f32 on x's card, contiguous; with ``experts`` each with a leading
    expert dim E (x the (E, C, K) capacity buffer). ``x_dtype``: a dtype,
    or a tuple of the dtypes the kernel takes."""
    x_dtypes = x_dtype if isinstance(x_dtype, tuple) else (x_dtype,)
    lead = 1 if experts else 0
    e = (x.shape[0],) if experts and x.ndim == 3 else ()
    n = qw.shape[-1]
    want_g = 1 if group_size == -1 else k // group_size
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor")
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"{name}: bits={bits} not in (2, 3, 4, 8)")
    if not (x.dtype in x_dtypes and x.ndim == 2 + lead and x.shape[-1] == k
            and qw.dtype == torch.uint8
            and tuple(qw.shape) == e + (packed_rows(k, bits), n)
            and scale.dtype == torch.float32
            and tuple(scale.shape) == e + (want_g, n)
            and (group_size == -1 or k % group_size == 0)):
        lead_s = "E, " if experts else ""
        raise ValueError(
            f"{name}: want x ({lead_s}{'C' if experts else 'M'}, {k}) "
            f"{' or '.join(map(str, x_dtypes))}, qw "
            f"({lead_s}{packed_rows(k, bits)}, N) uint8, "
            f"scale ({lead_s}{want_g}, N) f32 for group_size={group_size}; "
            f"got {tuple(x.shape)} {x.dtype}, {tuple(qw.shape)} {qw.dtype}, "
            f"{tuple(scale.shape)} {scale.dtype}")
    if not (qw.device == x.device and scale.device == x.device):
        raise ValueError(f"{name}: x, qw and scale must be on one device")
    if not (x.is_contiguous() and qw.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")


# x and output dtypes the dequant-matmul kernels (1 and 4) take
FLOATS = (torch.float32, torch.bfloat16)


def check_bf16_groups(name: str, x: torch.Tensor, k: int,
                      groups: int) -> None:
    """A bf16 x runs the streaming body only with scale groups of whole
    16-row K steps (its per-value-scale form is not built): raise
    ValueError on any other group."""
    if (x.dtype == torch.bfloat16 and groups > 1 and (k // groups) % 16):
        raise ValueError(f"{name}: a bf16 x takes scale groups of whole "
                         f"16-row K steps, not {k // groups} rows")
