"""The port's W8A8 path against the JAX package's on the same inputs, made
with numpy from a seed: per-token activation quantization, the plain
int8 matmul (the CUDA kernel's plain version) against
``repro.kernels.ref.w8a8_matmul_ref`` and the Pallas kernel in interpret
mode, and the A8 branch of a packed linear."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import types as jt
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.linear import dense as jdense
from repro_torch.core.quant import types as tt
from repro_torch.kernels import ops, ref
from repro_torch.models.linear import dense

BITS = [2, 3, 4, 8]
GROUPS = [-1, 16, 32, 128]
MS = [1, 5, 8, 40]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(m, k, n, bits, group, seed):
    """x (M, K) with a few outlier channels, and W packed (the two packages
    pack the same bytes, tests/test_torch_quant_types.py), as numpy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x[:, rng.integers(0, k, 3)] *= 20.0
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    qt = tt.quantize(torch.from_numpy(w), bits, group, act_bits=8)
    return x, qt.qw.numpy(), qt.scale.numpy()


def _group_terms_bound(xq, qw, scale, bits, group, k):
    """max over outputs of sum_g |int group sum| * |scale|: the magnitude
    the f32 group sum rounds against."""
    q = tt.unpack(torch.from_numpy(qw), bits, k).numpy().astype(np.float64)
    g = scale.shape[0]
    acc = np.einsum("mgk,gkn->mgn",
                    np.abs(xq.astype(np.float64)).reshape(-1, g, k // g),
                    np.abs(q).reshape(g, k // g, -1))
    return float((acc * np.abs(scale)[None]).sum(axis=1).max())


@pytest.mark.parametrize("m", MS)
def test_quantize_activation_matches_jax(m):
    rng = np.random.default_rng(m)
    x = (rng.normal(size=(m, 3, 192)) * rng.uniform(0.01, 30, (m, 3, 1))
         ).astype(np.float32)
    x[0, 0] = 0.0                                   # an all-zero token
    x[-1, -1, :4] = [2.54, -2.54, 1.27, 0.5]        # round-half cases
    qj, sj = jt.quantize_activation(jnp.asarray(x), 8)
    qt, st = tt.quantize_activation(torch.from_numpy(x), 8)
    assert qt.dtype == torch.int8 and tuple(st.shape) == (m, 3, 1)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))


# every (bits, group) pair, each at one of the M values in turn, on TINY's
# 192 x 576 (K = 256 for groups of 128, which 192 does not divide)
W8A8_CASES = [(bits, group, MS[(i + j) % len(MS)],
               (256, 576) if group == 128 else (192, 576))
              for i, bits in enumerate(BITS)
              for j, group in enumerate(GROUPS)]


@pytest.mark.parametrize("bits,group,m,kn", W8A8_CASES)
def test_w8a8_plain_matches_jax_ref(bits, group, m, kn):
    k, n = kn
    x, qw, scale = _case(m, k, n, bits, group, seed=bits * 1000 + m + k)
    xq = np.asarray(jt.quantize_activation(jnp.asarray(x), 8)[0])
    want = np.asarray(jref.w8a8_matmul_ref(
        jnp.asarray(xq), jnp.asarray(qw), jnp.asarray(scale), bits=bits,
        group_size=group, k=k))
    got = ref.w8a8_matmul_ref(torch.from_numpy(xq), torch.from_numpy(qw),
                              torch.from_numpy(scale), bits=bits,
                              group_size=group, k=k).numpy()
    # both sums inside a group are exact integers (int32 / float64) and are
    # converted and rescaled the same way; the sums over groups round in
    # f32 in another order: 1e-6 of the sum of |group terms|
    tol = 1e-6 * _group_terms_bound(xq, qw, scale, bits, group, k)
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("bits,group,m", [(4, -1, 8), (3, 32, 5), (2, 16, 1),
                                          (8, 32, 40)])
def test_w8a8_matches_pallas_interpret(bits, group, m):
    """``ops.w8a8_matmul`` (quantize, plain int8 matmul, rescale) against the
    JAX wrapper on the Pallas kernel in interpret mode."""
    k, n = 192, 64
    x, qw, scale = _case(m, k, n, bits, group, seed=7 + m)
    qj = jt.QuantizedTensor(jnp.asarray(qw), jnp.asarray(scale), bits,
                            group, (k, n), 8)
    want = np.asarray(jops.w8a8_matmul(jnp.asarray(x), qj))
    got = ops.w8a8_matmul(torch.from_numpy(x), tt.QuantizedTensor(
        torch.from_numpy(qw), torch.from_numpy(scale), bits, group,
        (k, n), 8)).numpy()
    xq = np.asarray(jt.quantize_activation(jnp.asarray(x), 8)[0])
    xs = np.abs(x).max(axis=-1, keepdims=True) / 127.0
    tol = 1e-6 * _group_terms_bound(xq, qw, scale, bits, group, k) * xs.max()
    assert np.abs(got - want).max() <= tol


@pytest.mark.parametrize("bits,group", [(4, -1), (4, 32)])
def test_a8_linear_matches_jax_cpu_path(bits, group):
    """A packed A8 linear of the port (plain version) against the JAX
    package's CPU path (quantize_activation + the int32 oracle), leading
    batch dims and a bias included."""
    k, n = 576, 192
    x, qw, scale = _case(12, k, n, bits, group, seed=3)
    x = x.reshape(2, 6, k)
    b = np.random.default_rng(4).normal(size=(n,)).astype(np.float32)
    qj = jt.QuantizedTensor(jnp.asarray(qw), jnp.asarray(scale), bits,
                            group, (k, n), 8)
    want = np.asarray(jdense({"w": qj, "b": jnp.asarray(b)}, jnp.asarray(x)))
    got = dense({"w": tt.QuantizedTensor(
        torch.from_numpy(qw), torch.from_numpy(scale), bits, group, (k, n),
        8), "b": torch.from_numpy(b)}, torch.from_numpy(x)).numpy()
    # the same exact integer sums, rescaled in f32: ~1e-7 relative
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_act_bits_survives_indexing_moving_and_stacking():
    w = torch.from_numpy(np.random.default_rng(0).normal(
        size=(3, 64, 32)).astype(np.float32))
    qt = tt.quantize_stacked(w, 4, 16, act_bits=8)
    assert qt.act_bits == 8 and qt.shape == (3, 64, 32)
    assert qt[1].act_bits == 8 and qt[1].shape == (64, 32)
    assert qt.to("cpu").act_bits == 8
    restacked = tt.stack_quantized([qt[i] for i in range(3)])
    assert restacked.act_bits == 8 and restacked.shape == (3, 64, 32)
    assert torch.equal(restacked.qw, qt.qw)
    with pytest.raises(ValueError):
        tt.stack_quantized([qt[0], tt.quantize(w[0], 4, 16)])


@pytest.mark.parametrize("m,k,n,group", [
    (8, 2048, 8192, 128), (8, 8192, 2048, 128), (8, 2048, 2048, 16),
    (8, 2048, 512, 64), (5, 576, 192, 32), (512, 2048, 8192, 128),
    (1, 192, 192, -1)])
def test_w8a8_split_plan_cuts_whole_groups(m, k, n, group):
    """The K split the W8A8 wrapper hands its kernel (the dense planner,
    ``plan`` with the scale groups): whole ring stages of the body it
    picks and, for grouped scales, whole scale groups, no empty split, all
    of K covered; per-channel scales (whose split sums add in int32) plan
    as the dequant matmul does."""
    from repro_torch.kernels.dequant_matmul import STREAM, TILE_K, plan
    from repro_torch.kernels.expert_dequant_matmul import STAGE_K

    groups = 1 if group == -1 else k // group
    p = plan(m, k, n, 4, groups, int8=True)
    step = STAGE_K if p.body == STREAM else TILE_K
    assert p.splits >= 1 and p.k_per_split % step == 0
    if group != -1:
        assert p.k_per_split % group == 0
    assert (p.splits - 1) * p.k_per_split < k <= p.splits * p.k_per_split
    if group == -1:
        q = plan(m, k, n, 4, 1, int8=False)
        assert (p.body, p.splits, p.k_per_split) == (q.body, q.splits,
                                                      q.k_per_split)
