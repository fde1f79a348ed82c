"""CUDA kernel: fused low-bit dequantize + matmul (``csrc/dequant_matmul.cu``).

Replaces the TPU kernel ``dequant_matmul_pallas``
(src/repro/kernels/dequant_matmul.py). The source's header says what
bounds it on the H100 and what the design does about it; its plain
version is ``kernels/ref.py::dequant_matmul_ref``.

``launches`` counts the kernel's launches in this process (reset it by
assigning 0); nothing but the launch below adds to it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.quant.types import packed_rows
from repro_torch.kernels import build

launches = 0

# the kernel's output tile and K step (csrc/dequant_matmul.cu)
TILE_M, TILE_N, TILE_K = 64, 64, 32
# blocks that keep every one of the H100's 132 SMs busy several times over
TARGET_BLOCKS = 1024
# a split walks at least this many K steps, bounding the partials' traffic
MIN_STEPS_PER_SPLIT = 4


def plan_splits(m: int, k: int, n: int,
                group_rows: int | None = None) -> tuple[int, int]:
    """(splits, k_per_split): cut K across blocks when the output tiles
    alone are too few to fill the card (the decode shapes).
    k_per_split is a whole number of K steps and no split is empty. With
    ``group_rows`` (< K: grouped scales, which the W8A8 kernel sums apart)
    it is also a whole number of scale groups."""
    group_rows = k if group_rows is None else group_rows
    unit = TILE_K if group_rows >= k else max(TILE_K, group_rows)
    if unit % TILE_K:
        unit *= 2                          # a group of 16 rows: two a step
    tiles = -(-m // TILE_M) * -(-n // TILE_N)
    units = -(-k // unit)
    splits = max(1, min(-(-TARGET_BLOCKS // tiles),
                        units * unit // (TILE_K * MIN_STEPS_PER_SPLIT)))
    per = -(-units // splits)
    return -(-units // per), per * unit


def check_operands(name: str, x: torch.Tensor, x_dtype: torch.dtype,
                   qw: torch.Tensor, scale: torch.Tensor, *, bits: int,
                   group_size: int, k: int, experts: bool) -> None:
    """Raise ValueError on operands the packed-matmul kernels do not take:
    x (M, K) of ``x_dtype``, qw (packed_rows(K), N) uint8 and scale (G, N)
    f32 on x's card, contiguous; with ``experts`` each with a leading
    expert dim E (x the (E, C, K) capacity buffer)."""
    lead = 1 if experts else 0
    e = (x.shape[0],) if experts and x.ndim == 3 else ()
    n = qw.shape[-1]
    want_g = 1 if group_size == -1 else k // group_size
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA tensor")
    if bits not in (2, 3, 4, 8):
        raise ValueError(f"{name}: bits={bits} not in (2, 3, 4, 8)")
    if not (x.dtype == x_dtype and x.ndim == 2 + lead and x.shape[-1] == k
            and qw.dtype == torch.uint8
            and tuple(qw.shape) == e + (packed_rows(k, bits), n)
            and scale.dtype == torch.float32
            and tuple(scale.shape) == e + (want_g, n)
            and (group_size == -1 or k % group_size == 0)):
        lead_s = "E, " if experts else ""
        raise ValueError(
            f"{name}: want x ({lead_s}{'C' if experts else 'M'}, {k}) "
            f"{x_dtype}, qw ({lead_s}{packed_rows(k, bits)}, N) uint8, "
            f"scale ({lead_s}{want_g}, N) f32 for group_size={group_size}; "
            f"got {tuple(x.shape)} {x.dtype}, {tuple(qw.shape)} {qw.dtype}, "
            f"{tuple(scale.shape)} {scale.dtype}")
    if not (qw.device == x.device and scale.device == x.device):
        raise ValueError(f"{name}: x, qw and scale must be on one device")
    if not (x.is_contiguous() and qw.is_contiguous()
            and scale.is_contiguous()):
        raise ValueError(f"{name}: operands must be contiguous")


def _lib(name: str):
    fn = getattr(build.load(name), name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def run(name: str, x: torch.Tensor, qw: torch.Tensor, scale: torch.Tensor,
        *, bits: int, group_size: int, k: int) -> torch.Tensor:
    """Check, plan and launch the dequant-matmul body as library ``name``:
    x (M, K) f32. Returns the f32 output; the caller counts the launch."""
    check_operands(name, x, torch.float32, qw, scale, bits=bits,
                   group_size=group_size, k=k, experts=False)
    n = qw.shape[-1]
    want_g = 1 if group_size == -1 else k // group_size
    m = x.shape[-2]
    out = torch.empty(x.shape[:-1] + (n,), dtype=torch.float32,
                      device=x.device)
    if m == 0:
        return out
    splits, k_per_split = plan_splits(m, k, n)
    work = (torch.empty((splits, m, n), dtype=torch.float32,
                        device=x.device) if splits > 1 else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    code = _lib(name)(x.data_ptr(), qw.data_ptr(), scale.data_ptr(),
                      out.data_ptr(),
                      None if work is None else work.data_ptr(),
                      m, k, n, want_g, bits, splits, k_per_split, stream)
    build.check(name, code)
    return out


def dequant_matmul_cuda(x: torch.Tensor, qw: torch.Tensor,
                        scale: torch.Tensor, *, bits: int, group_size: int,
                        k: int) -> torch.Tensor:
    """x (M, K) f32 @ packed qw (packed_rows(K), N) uint8 with scale (G, N)
    f32 -> (M, N) f32, on the card. Raises on anything the kernel does not
    take."""
    global launches
    out = run("dequant_matmul", x, qw, scale, bits=bits,
              group_size=group_size, k=k)
    if out.numel():                      # an empty x launches nothing
        launches += 1
    return out
