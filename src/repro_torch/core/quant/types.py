"""Quantized tensor representation + symmetric per-channel / group quantizers.

Port of ``repro.core.quant.types``; the packed bytes are identical, so a
tree packed by either package runs in the other.

Layout convention: linear weights are (K, N) = (d_in, d_out); ``out = x @ w``.
The grid is symmetric: q in [-qmax, qmax], qmax = 2^(bits-1) - 1, value =
q * scale. ``scale[g, n]`` applies to rows k in [g*group_size,
(g+1)*group_size).

Packing: values are stored offset-binary (u = q + qmax) and packed along K
into uint8. ``pack_layout(bits)`` gives (bytes_per_group, values_per_group):
2-bit packs 4 values a byte, 4-bit 2, 8-bit is pass-through, and 3-bit packs
8 values into a 24-bit little-endian word stored as 3 consecutive bytes.
Value i of packed group r holds K row ``r * vpg + i``.
"""
from __future__ import annotations

import dataclasses

import torch


def qmax_for_bits(bits: int) -> int:
    return 2 ** (bits - 1) - 1


def pack_layout(bits: int) -> tuple[int, int]:
    """(bytes_per_group, values_per_group) of the K-packed byte layout."""
    return {2: (1, 4), 3: (3, 8), 4: (1, 2), 8: (1, 1)}[bits]


def packed_rows(k: int, bits: int) -> int:
    """Rows of the uint8 qw array holding k packed values."""
    bpg, vpg = pack_layout(bits)
    return -(-k // vpg) * bpg


@dataclasses.dataclass
class QuantizedTensor:
    """Packed low-bit weight; the drop-in leaf for a linear's ``w``."""

    qw: torch.Tensor     # uint8 (packed_rows(K), N); scan-stacked: (L, ., N)
    scale: torch.Tensor  # f32 (n_groups, N); scan-stacked: (L, G, N)
    bits: int
    group_size: int      # -1 means one group over all of K
    shape: tuple         # original (K, N) or (L, K, N)

    @property
    def k(self) -> int:
        return self.shape[-2]

    @property
    def n(self) -> int:
        return self.shape[-1]

    def __getitem__(self, i: int) -> "QuantizedTensor":
        """Layer i of a scan-stacked tensor (views, no copy)."""
        return QuantizedTensor(self.qw[i], self.scale[i], self.bits,
                               self.group_size, tuple(self.shape[1:]))

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.qw.to(device), self.scale.to(device),
                               self.bits, self.group_size, self.shape)


def _group_count(k: int, group_size: int) -> int:
    if group_size == -1:
        return 1
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    return k // group_size


def compute_scales(w: torch.Tensor, bits: int,
                   group_size: int = -1) -> torch.Tensor:
    """Symmetric scales: (n_groups, N). w is (K, N)."""
    k, n = w.shape
    g = _group_count(k, group_size)
    amax = w.reshape(g, k // g, n).abs().amax(dim=1)
    scale = amax / qmax_for_bits(bits)
    return scale.clamp_min(1e-10).to(torch.float32)


def quantize_values(w: torch.Tensor, scale: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Round half to even onto the grid: int32 q in [-qmax, qmax], (K, N)."""
    k, n = w.shape
    g = scale.shape[0]
    qmax = qmax_for_bits(bits)
    q = torch.round(w.reshape(g, k // g, n) / scale[:, None, :])
    return q.clamp(-qmax, qmax).reshape(k, n).to(torch.int32)


def pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack offset-binary values along K into uint8. q: int32 (K, N)."""
    k, n = q.shape
    qmax = qmax_for_bits(bits)
    bpg, vpg = pack_layout(bits)
    u = (q + qmax).to(torch.int32)
    if (bpg, vpg) == (1, 1):
        return u.to(torch.uint8)
    pad = (-k) % vpg
    if pad:
        u = torch.cat([u, u.new_zeros((pad, n))], dim=0)
    u = u.reshape(-1, vpg, n)
    word = torch.zeros_like(u[:, 0, :])
    for i in range(vpg):
        word = word | (u[:, i, :] << (bits * i))
    if bpg == 1:
        return word.to(torch.uint8)
    # multi-byte group (3-bit): emit the word little-endian along K
    out = torch.stack([(word >> (8 * b)) & 0xFF for b in range(bpg)], dim=1)
    return out.reshape(-1, n).to(torch.uint8)


def unpack(qw: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of ``pack``: int32 q in [-qmax, qmax], (K, N)."""
    qmax = qmax_for_bits(bits)
    bpg, vpg = pack_layout(bits)
    b = qw.to(torch.int32)
    if (bpg, vpg) == (1, 1):
        return b[:k] - qmax
    if bpg == 1:
        word = b
    else:
        grp = b.reshape(-1, bpg, qw.shape[1])
        word = grp[:, 0, :]
        for i in range(1, bpg):
            word = word | (grp[:, i, :] << (8 * i))
    mask = (1 << bits) - 1
    parts = [(word >> (bits * i)) & mask for i in range(vpg)]
    u = torch.stack(parts, dim=1).reshape(-1, qw.shape[1])
    return u[:k] - qmax


def quantize(w: torch.Tensor, bits: int,
             group_size: int = -1) -> QuantizedTensor:
    """RTN-quantize a (K, N) weight to a packed QuantizedTensor."""
    scale = compute_scales(w, bits, group_size)
    q = quantize_values(w, scale, bits)
    return QuantizedTensor(pack(q, bits), scale, bits, group_size,
                           tuple(w.shape))


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """(K, N) f32 weight of a 2-D QuantizedTensor."""
    k = qt.k
    q = unpack(qt.qw, qt.bits, k).to(torch.float32)
    g = qt.scale.shape[0]
    if g == 1:
        return q * qt.scale
    rows = torch.arange(k, device=q.device) // (k // g)
    return q * qt.scale[rows]


def quantize_stacked(w: torch.Tensor, bits: int,
                     group_size: int = -1) -> QuantizedTensor:
    """RTN-quantize weights with any leading batch dims (..., K, N)."""
    if w.ndim == 2:
        return quantize(w, bits, group_size)
    parts = [quantize_stacked(wi, bits, group_size) for wi in w]
    return QuantizedTensor(torch.stack([p.qw for p in parts]),
                           torch.stack([p.scale for p in parts]),
                           bits, group_size, tuple(w.shape))
