"""Kernel 6, RTN quantize + pack: the port's plain version (what
``ops.quantize_pack`` runs on the CPU, and what the CUDA kernel is held
against on the card) and ``types.quantize`` against the JAX package's
reference and its Pallas kernel in interpret mode, byte for byte, on the
same seeded weights."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import types as jt
from repro.kernels import ref as jref
from repro.kernels.quantize import quantize_pack_pallas
from repro_torch.core.quant import types as tt
from repro_torch.kernels import ops, ref

# tests/test_kernels.py's cases, plus W3 (8 values in a 3-byte word)
PALLAS_CASES = [(2, -1), (2, 32), (4, -1), (4, 64), (8, -1), (3, -1),
                (3, 32)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _w(shape, seed):
    return (np.random.default_rng(seed).normal(size=shape) * 0.2).astype(
        np.float32)


@pytest.mark.parametrize("bits,group", PALLAS_CASES)
def test_quantize_pack_matches_jax_ref_and_pallas(bits, group):
    """(128, 64) weights, the Pallas kernel on 64 x 32 tiles: exact (the
    same IEEE f32 quotient, rounded half to even, on every side)."""
    w = _w((128, 64), 7)
    s = np.array(jt.compute_scales(jnp.asarray(w), bits, group))
    want = np.asarray(jref.quantize_pack_ref(jnp.asarray(w), jnp.asarray(s),
                                             bits=bits))
    pallas = np.asarray(quantize_pack_pallas(
        jnp.asarray(w), jnp.asarray(s), bits=bits, group_size=group, bk=64,
        bn=32, interpret=True))
    got = ops.quantize_pack(torch.from_numpy(w), torch.from_numpy(s),
                            bits=bits)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pallas)
    # types.quantize packs through the same wrapper, with its own scales
    qt = tt.quantize(torch.from_numpy(w), bits, group)
    np.testing.assert_array_equal(qt.scale.numpy(), s)
    np.testing.assert_array_equal(qt.qw.numpy(), want)


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("k,n,group", [(768, 16, 3), (100, 24, -1),
                                       (100, 24, 4), (36, 5, 12)])
def test_quantize_pack_odd_shapes_match_jax_ref(bits, k, n, group):
    """A group of 3 (no Pallas tiling exists for it: the JAX wrapper falls
    back to its reference), K not a multiple of a packed group (the last
    group's missing values are zero fields), a group smaller than a W3
    word: exact against the JAX reference."""
    w = _w((k, n), k + bits)
    s = np.array(jt.compute_scales(jnp.asarray(w), bits, group))
    want = np.asarray(jref.quantize_pack_ref(jnp.asarray(w), jnp.asarray(s),
                                             bits=bits))
    got = ref.quantize_pack_ref(torch.from_numpy(w), torch.from_numpy(s),
                                bits=bits)
    assert got.shape == (tt.packed_rows(k, bits), n)
    np.testing.assert_array_equal(got.numpy(), want)
    # and back: unpacking gives the rounded, clipped codes
    q = tt.quantize_values(torch.from_numpy(w), torch.from_numpy(s), bits)
    assert torch.equal(tt.unpack(got, bits, k), q)


@pytest.mark.parametrize("bits,group", [(4, 32), (3, -1), (2, 16)])
def test_quantize_pack_of_a_stack_matches_jax(bits, group):
    """Leading (L, E) dims in one call, against the JAX package's
    per-weight reference, and ``quantize_stacked`` against its own."""
    w = _w((2, 3, 64, 24), bits)
    got = tt.quantize_stacked(torch.from_numpy(w), bits, group)
    want = jt.quantize_stacked(jnp.asarray(w), bits, group)
    np.testing.assert_array_equal(got.qw.numpy(), np.asarray(want.qw))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    scale = np.asarray(want.scale)
    for i in range(2):
        for j in range(3):
            one = np.asarray(jref.quantize_pack_ref(
                jnp.asarray(w[i, j]), jnp.asarray(scale[i, j]), bits=bits))
            np.testing.assert_array_equal(got.qw[i, j].numpy(), one)


@pytest.mark.parametrize("bits", [3, 4])
def test_quantize_pack_bf16_input_matches_jax_ref(bits):
    """bf16 weights are read exactly and divided in f32, as the JAX
    reference casts them."""
    w = torch.from_numpy(_w((64, 32), 3)).to(torch.bfloat16)
    wj = jnp.asarray(w.float().numpy()).astype(jnp.bfloat16)
    s = jt.compute_scales(wj.astype(jnp.float32), bits, 32)
    want = np.asarray(jref.quantize_pack_ref(wj, s, bits=bits))
    got = ops.quantize_pack(w, torch.from_numpy(np.array(s)), bits=bits)
    np.testing.assert_array_equal(got.numpy(), want)


def test_quantize_pack_rounds_half_to_even_and_clips():
    """Exact halves round to even (roundf would round them away from 0),
    and values past the grid clip to +-qmax after rounding."""
    s = torch.ones((1, 8))
    w = torch.tensor([[0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 9.0, -9.0]])
    q = tt.unpack(ops.quantize_pack(w, s, bits=4), 4, 1)
    assert q.tolist() == [[0, 2, 2, 0, -2, -2, 7, -7]]
