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
from typing import Optional

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
    act_bits: int = 0    # 8: per-token int8 activations (the W8A8 kernel)

    @property
    def k(self) -> int:
        return self.shape[-2]

    @property
    def n(self) -> int:
        return self.shape[-1]

    def __getitem__(self, i: int) -> "QuantizedTensor":
        """Layer i of a scan-stacked tensor (views, no copy)."""
        return QuantizedTensor(self.qw[i], self.scale[i], self.bits,
                               self.group_size, tuple(self.shape[1:]),
                               self.act_bits)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.qw.to(device), self.scale.to(device),
                               self.bits, self.group_size, self.shape,
                               self.act_bits)


def _group_count(k: int, group_size: int) -> int:
    if group_size == -1:
        return 1
    if k % group_size:
        raise ValueError(f"K={k} not divisible by group_size={group_size}")
    return k // group_size


def compute_scales(w: torch.Tensor, bits: int,
                   group_size: int = -1) -> torch.Tensor:
    """Symmetric scales: (..., n_groups, N). w is (..., K, N)."""
    lead, (k, n) = w.shape[:-2], w.shape[-2:]
    g = _group_count(k, group_size)
    amax = w.reshape(*lead, g, k // g, n).abs().amax(dim=-2)
    scale = amax / qmax_for_bits(bits)
    return scale.clamp_min(1e-10).to(torch.float32)


def quantize_values(w: torch.Tensor, scale: torch.Tensor,
                    bits: int) -> torch.Tensor:
    """Round half to even onto the grid: int32 q in [-qmax, qmax],
    (..., K, N), with scale (..., G, N)."""
    lead, (k, n) = w.shape[:-2], w.shape[-2:]
    g = scale.shape[-2]
    qmax = qmax_for_bits(bits)
    q = torch.round(w.reshape(*lead, g, k // g, n) / scale[..., :, None, :])
    return q.clamp(-qmax, qmax).reshape(w.shape).to(torch.int32)


def pack(q: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack offset-binary values along K into uint8. q: int32 (..., K, N)
    -> (..., packed_rows(K), N)."""
    lead, (k, n) = q.shape[:-2], q.shape[-2:]
    qmax = qmax_for_bits(bits)
    bpg, vpg = pack_layout(bits)
    u = (q + qmax).to(torch.int32)
    if (bpg, vpg) == (1, 1):
        return u.to(torch.uint8)
    pad = (-k) % vpg
    if pad:
        u = torch.cat([u, u.new_zeros(lead + (pad, n))], dim=-2)
    u = u.reshape(*lead, -1, vpg, n)
    word = torch.zeros_like(u[..., 0, :])
    for i in range(vpg):
        word = word | (u[..., i, :] << (bits * i))
    if bpg == 1:
        return word.to(torch.uint8)
    # multi-byte group (3-bit): emit the word little-endian along K
    out = torch.stack([(word >> (8 * b)) & 0xFF for b in range(bpg)],
                      dim=-2)
    return out.reshape(*lead, -1, n).to(torch.uint8)


def unpack(qw: torch.Tensor, bits: int, k: int) -> torch.Tensor:
    """Inverse of ``pack``: int32 q in [-qmax, qmax], (..., K, N) from
    (..., packed_rows(K), N) (leading dims: stacked layers or experts)."""
    qmax = qmax_for_bits(bits)
    bpg, vpg = pack_layout(bits)
    lead, n = qw.shape[:-2], qw.shape[-1]
    if (bpg, vpg) == (1, 1):
        return qw[..., :k, :].to(torch.int32) - qmax
    if bpg == 1:
        # fields of one byte: shift and mask in uint8, widen once
        word = qw
    else:
        grp = qw.to(torch.int32).reshape(*lead, -1, bpg, n)
        word = grp[..., 0, :]
        for i in range(1, bpg):
            word = word | (grp[..., i, :] << (8 * i))
    mask = (1 << bits) - 1
    parts = [(word >> (bits * i)) & mask for i in range(vpg)]
    u = torch.stack(parts, dim=-2).reshape(*lead, -1, n)
    return u[..., :k, :].to(torch.int32) - qmax


def quantize(w: torch.Tensor, bits: int, group_size: int = -1,
             act_bits: int = 0) -> QuantizedTensor:
    """RTN-quantize a (K, N) weight, or a stack of them (..., K, N) (layers,
    experts), to a packed QuantizedTensor. The scales are computed here;
    the rounding and packing are ``kernels.ops.quantize_pack`` (on the
    card one launch of the quantize-pack kernel for the whole stack)."""
    # imported here: kernels/ops.py imports this module
    from repro_torch.kernels import ops

    scale = compute_scales(w, bits, group_size)
    return QuantizedTensor(ops.quantize_pack(w, scale, bits=bits), scale,
                           bits, group_size, tuple(w.shape), act_bits)


def dequantize(qt: QuantizedTensor) -> torch.Tensor:
    """(..., K, N) f32 weight of a QuantizedTensor (2-D, or stacked experts
    or layers)."""
    k = qt.k
    q = unpack(qt.qw, qt.bits, k).to(torch.float32)
    g = qt.scale.shape[-2]
    if g == 1:
        return q * qt.scale
    lead, n = q.shape[:-2], q.shape[-1]
    return (q.reshape(*lead, g, k // g, n)
            * qt.scale[..., :, None, :]).reshape(q.shape)


# the JAX package's name for ``quantize`` on stacked weights
quantize_stacked = quantize


def fake_quant(w: torch.Tensor, bits: int,
               group_size: int = -1) -> torch.Tensor:
    """Quantize then dequantize a (K, N) weight without packing (the grid
    of ``quantize``), in w's dtype."""
    scale = compute_scales(w, bits, group_size)
    k, n = w.shape
    g = scale.shape[0]
    q = quantize_values(w, scale, bits).reshape(g, k // g, n)
    return (q.to(w.dtype) * scale[:, None, :].to(w.dtype)).reshape(k, n)


def stack_quantized(parts: list) -> QuantizedTensor:
    """Stack same-layout packed tensors along a new leading dim (the
    scan-stacked layer axis); ``act_bits`` and the layout are kept."""
    p0 = parts[0]
    if any((p.bits, p.group_size, p.shape, p.act_bits) !=
           (p0.bits, p0.group_size, p0.shape, p0.act_bits) for p in parts):
        raise ValueError("cannot stack packed tensors of different layouts")
    return QuantizedTensor(torch.stack([p.qw for p in parts]),
                           torch.stack([p.scale for p in parts]),
                           p0.bits, p0.group_size,
                           (len(parts),) + tuple(p0.shape), p0.act_bits)


def quantize_activation(x: torch.Tensor, bits: int = 8,
                        axis_name: Optional[str] = None):
    """Dynamic symmetric per-token activation quantization.

    Returns (q, scale): q int8 with the shape of x, scale f32 (..., 1) with
    q * scale ~= x, |error| <= scale / 2 (each row's amax lands on the
    grid). Rounds half to even like ``jnp.round``. q carries no gradient;
    scale does, through the amax (to each row's largest |x|).

    ``axis_name``: a mesh axis over which the token's feature dim is split
    (a tensor-parallel row-parallel linear). The amax is then all-reduced
    with MAX, so every rank quantizes its slice on the grid one device
    would use; a rank-local amax would change the quantization itself."""
    qmax = qmax_for_bits(bits)
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=-1, keepdim=True)
    if axis_name is not None:
        from repro_torch.distributed.collectives import all_reduce
        amax = all_reduce(amax, axis_name, op="max")
    scale = amax.clamp_min(1e-10) / qmax
    q = torch.round(xf / scale).clamp(-qmax, qmax).to(torch.int8)
    return q, scale
