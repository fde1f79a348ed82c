"""Port packing vs the JAX package: the same float weights (made with numpy
from a seed) give byte-identical packed weights and bit-identical scales."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import types as jt
from repro_torch.core.quant import types as tt

# K = 192 exercises W3's 8-value words and the end-of-K handling; K = 100
# is not a multiple of 8 (W3) or 4 (W2), so packing pads the last group
SHAPES = [(192, 24), (100, 8)]


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("group", [-1, 32, 128])
def test_pack_bytes_match_jax(bits, group):
    for k, n in SHAPES:
        if group != -1 and k % group:
            continue
        w = np.random.default_rng(bits * 1000 + k).normal(
            size=(k, n)).astype(np.float32) * 0.05
        qj = jt.quantize(jnp.asarray(w), bits, group)
        qt = tt.quantize(torch.from_numpy(w), bits, group)
        # exact: same IEEE f32 division and round-half-to-even on both sides
        np.testing.assert_array_equal(qt.qw.numpy(), np.asarray(qj.qw))
        np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
        assert qt.shape == tuple(qj.shape)
        # the port's dequantize of JAX-packed bytes equals JAX's
        qt_from_jax = tt.QuantizedTensor(
            torch.from_numpy(np.array(qj.qw)),
            torch.from_numpy(np.array(qj.scale)), bits, group, (k, n))
        np.testing.assert_array_equal(
            tt.dequantize(qt_from_jax).numpy(),
            np.asarray(jt.dequantize(qj)))


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
def test_unpack_pack_identity(bits):
    qmax = tt.qmax_for_bits(bits)
    for k in (192, 100, 7):
        q = torch.from_numpy(np.random.default_rng(k + bits).integers(
            -qmax, qmax + 1, size=(k, 5)).astype(np.int32))
        packed = tt.pack(q, bits)
        assert packed.dtype == torch.uint8
        assert packed.shape == (tt.packed_rows(k, bits), 5)
        assert torch.equal(tt.unpack(packed, bits, k), q)


def test_quantize_stacked_matches_jax():
    w = np.random.default_rng(5).normal(size=(3, 64, 16)).astype(np.float32)
    qj = jt.quantize_stacked(jnp.asarray(w), 4, 32)
    qt = tt.quantize_stacked(torch.from_numpy(w), 4, 32)
    np.testing.assert_array_equal(qt.qw.numpy(), np.asarray(qj.qw))
    np.testing.assert_array_equal(qt.scale.numpy(), np.asarray(qj.scale))
    assert qt.shape == (3, 64, 16) and qt[1].shape == (64, 16)
