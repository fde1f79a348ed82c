"""The port's self-generated calibration against the JAX package's on the
same weights: greedy generation through the contiguous-cache decode, with
the first tokens drawn on one side and injected into both (the packages'
random streams differ), plus the shapes and ranges of the sampled sets."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.calibration.generator import _generate_batch as jgenerate
from repro.models.transformer import init_lm as jinit
from repro.models.transformer import lm_loss as jlm_loss
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.calibration.generator import (_generate_batch,
                                                    generate_calibration,
                                                    random_calibration)
from repro_torch.models.transformer import init_lm, lm_loss

# TINY, and the llama3.2-1b SMOKE config (GQA) with an int8 contiguous KV
# cache and with a sliding window shorter than the generation (the ring
# buffer wraps)
ARCHS = {"tiny": (tc.TINY.replace(n_repeats=2), jc.TINY.replace(n_repeats=2)),
         "llama3.2-1b-smoke-int8kv": (
             tc.get_smoke_config("llama3.2-1b").replace(kv_cache_bits=8),
             jc.get_smoke_config("llama3.2-1b").replace(kv_cache_bits=8)),
         "llama3.2-1b-smoke-swa": (
             tc.get_smoke_config("llama3.2-1b").replace(attn_window=8),
             jc.get_smoke_config("llama3.2-1b").replace(attn_window=8))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_greedy_generation_matches_jax(arch):
    tcfg, jcfg = ARCHS[arch]
    params = jinit(jcfg, jax.random.PRNGKey(0))
    first = np.random.default_rng(3).integers(0, jcfg.vocab_size, 6)
    want = np.asarray(jgenerate(jcfg, params, jnp.asarray(first, jnp.int32),
                                jax.random.PRNGKey(1), 24,
                                stochastic_prefix=0))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    gen = torch.Generator().manual_seed(1)
    got = _generate_batch(tcfg, tparams, torch.from_numpy(first), gen, 24,
                          stochastic_prefix=0).numpy()
    assert got.shape == want.shape == (6, 24)
    np.testing.assert_array_equal(got[:, 0], first)
    np.testing.assert_array_equal(got, want)


def test_generate_calibration_shapes_and_first_tokens():
    cfg = tc.get_smoke_config("llama3.2-1b")
    params = init_lm(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(0)
    allowed = np.array([3, 17, 42])
    calib = generate_calibration(cfg, params, gen, n_samples=5,
                                 token_length=12, allowed_first=allowed,
                                 batch_size=2)
    assert calib.shape == (5, 12) and calib.dtype == torch.int32
    assert set(calib[:, 0].tolist()) <= set(allowed.tolist())
    assert int(calib.min()) >= 0 and int(calib.max()) < cfg.vocab_size
    # seeded: the same generator seed gives the same set
    again = generate_calibration(cfg, params,
                                 torch.Generator().manual_seed(0),
                                 n_samples=5, token_length=12,
                                 allowed_first=allowed, batch_size=2)
    assert torch.equal(calib, again)
    rnd = random_calibration(cfg, gen, n_samples=3, token_length=7)
    assert rnd.shape == (3, 7) and int(rnd.max()) < cfg.vocab_size


def test_lm_loss_matches_jax():
    tcfg, jcfg = ARCHS["tiny"]
    params = jinit(jcfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 16))
    labels = rng.integers(0, jcfg.vocab_size, (2, 16))
    mask = (rng.random((2, 16)) > 0.3).astype(np.float32)
    want, _ = jlm_loss(jcfg, params, {"tokens": jnp.asarray(tokens),
                                      "labels": jnp.asarray(labels),
                                      "mask": jnp.asarray(mask)})
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    got, parts = lm_loss(tcfg, tparams, {"tokens": torch.from_numpy(tokens),
                                         "labels": torch.from_numpy(labels),
                                         "mask": torch.from_numpy(mask)})
    # f32 logits summed in another order (1e-5 on TINY's logits) and a
    # log-sum-exp over 256 classes
    assert abs(float(got) - float(want)) <= 1e-5 * abs(float(want))
    assert float(parts["aux"]) == 0.0
