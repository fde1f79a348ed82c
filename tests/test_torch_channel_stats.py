"""Kernel 7, per-channel statistics: the port's plain version (what
``ops.channel_stats`` runs on the CPU, and what the CUDA kernel is held
against on the card) against the JAX package's reference and its Pallas
kernel in interpret mode, and the norm tweak's ``channel_stats`` (an
autograd Function over it) against the JAX loss's statistics and
gradient, on the same seeded inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.normtweak import losses as jl
from repro.kernels import ref as jref
from repro.kernels.channel_stats import channel_stats_pallas
from repro_torch.core.normtweak import losses as tl
from repro_torch.kernels import ops, ref


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _x(t, c, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(t, c)) * 3 + 1).astype(dtype)


# tests/test_kernels.py's shapes and Pallas tiles
@pytest.mark.parametrize("t,c,bt,bc", [(256, 128, 64, 64), (128, 64, 128, 64),
                                       (512, 32, 256, 32)])
@pytest.mark.parametrize("bf16", [False, True])
def test_channel_stats_matches_jax_ref_and_pallas(t, c, bt, bc, bf16):
    """Mean 1, std 3. Against the JAX reference (f32 mean and two-pass
    variance): the same function summed in another order, 1e-6 relative.
    Against the Pallas kernel (sum x^2 / T - mean^2 in f32): 2e-5 of the
    variance, that formula's rounding at |mean| / std = 1/3."""
    x = _x(t, c, t + c)
    xj = jnp.asarray(x)
    xt = torch.from_numpy(x)
    if bf16:
        xj = xj.astype(jnp.bfloat16)
        xt = xt.to(torch.bfloat16)
    mu, var = ops.channel_stats(xt)
    assert mu.dtype == var.dtype == torch.float32
    m_r, v_r = jref.channel_stats_ref(xj)
    m_p, v_p = channel_stats_pallas(xj, bt=bt, bc=bc, interpret=True)
    scale = float(np.asarray(v_r).max())
    np.testing.assert_allclose(mu.numpy(), np.asarray(m_r), rtol=0,
                               atol=1e-6 * np.sqrt(scale))
    np.testing.assert_allclose(var.numpy(), np.asarray(v_r), rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(mu.numpy(), np.asarray(m_p), rtol=0,
                               atol=1e-6 * np.sqrt(scale))
    np.testing.assert_allclose(var.numpy(), np.asarray(v_p), rtol=0,
                               atol=2e-5 * scale)


def test_channel_stats_two_pass_at_a_large_mean():
    """Mean 1e3, std 1: the plain version keeps the variance to 1e-5 of
    the f64 truth, where the TPU kernel's one-pass formula loses it."""
    rng = np.random.default_rng(4)
    x = (1e3 + rng.normal(size=(4096, 48))).astype(np.float32)
    _, var = ref.channel_stats_ref(torch.from_numpy(x))
    truth = x.astype(np.float64).var(axis=0)
    np.testing.assert_allclose(var.numpy(), truth, rtol=1e-5)
    _, v_p = channel_stats_pallas(jnp.asarray(x), bt=256, bc=48,
                                  interpret=True)
    assert np.abs(np.asarray(v_p) - truth).max() > 1e-2


@pytest.mark.parametrize("shape", [(4, 40, 24), (3, 7, 5)])
def test_loss_channel_stats_matches_jax(shape):
    """The tweak's statistics over all token dims, forward and gradient:
    d/dx of sum(a * mean + b * var) against jax.grad, 1e-6 relative."""
    rng = np.random.default_rng(sum(shape))
    x = rng.normal(size=shape).astype(np.float32) * 2 + 0.5
    a = rng.normal(size=shape[-1]).astype(np.float32)
    b = rng.normal(size=shape[-1]).astype(np.float32)

    def jloss(xx):
        m, v = jl.channel_stats(xx)
        return jnp.sum(jnp.asarray(a) * m + jnp.asarray(b) * v)

    want = np.asarray(jax.grad(jloss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    m, v = tl.channel_stats(xt)
    jm, jv = jl.channel_stats(jnp.asarray(x))
    np.testing.assert_allclose(m.detach().numpy(), np.asarray(jm), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(v.detach().numpy(), np.asarray(jv), rtol=1e-6)
    (torch.from_numpy(a) * m + torch.from_numpy(b) * v).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def test_channel_stats_function_gradcheck():
    """torch.autograd.gradcheck of the Function in f64 (both outputs)."""
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(6, 4))).requires_grad_(True)
    assert torch.autograd.gradcheck(tl.channel_stats, (x,))


def test_l_dist_gradient_matches_jax():
    """The distribution loss (Eq. 2) through the Function, against
    jax.grad of the JAX loss with respect to the quantized stream."""
    rng = np.random.default_rng(11)
    f = rng.normal(size=(2, 16, 32)).astype(np.float32)
    q = (f + 0.1 * rng.normal(size=f.shape) + 0.05).astype(np.float32)
    want = np.asarray(jax.grad(lambda qq: jl.l_dist(jnp.asarray(f), qq))(
        jnp.asarray(q)))
    qt = torch.from_numpy(q).requires_grad_(True)
    tl.l_dist(torch.from_numpy(f), qt).backward()
    np.testing.assert_allclose(qt.grad.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
