"""The port's outlier injection and real-corpus calibration against the JAX
package's: ``apply_outliers`` given the JAX package's channels gives the
reference's tree bit for bit, the transform is float-equivalent, the
port's own channel draw has the reference's distribution (distinct
channels of d_model), and ``real_calibration`` returns corpus windows."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.calibration.generator import real_calibration as jreal
from repro.core.quant.outliers import inject_outliers as jinject
from repro.models.transformer import init_lm as jinit
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.calibration.generator import real_calibration
from repro_torch.core.quant.outliers import (apply_outliers, inject_outliers,
                                             outlier_channels)
from repro_torch.data.synthetic import make_corpus
from repro_torch.models.transformer import lm_forward

JCFG = jc.TINY.replace(n_repeats=2)
TCFG = tc.TINY.replace(n_repeats=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree)}


@pytest.fixture(scope="module")
def jparams():
    return jinit(JCFG, jax.random.PRNGKey(0))


@pytest.mark.parametrize("n,factor,seed", [(12, 60.0, 0), (8, 40.0, 3)])
def test_apply_outliers_with_jax_channels_equals_jax(jparams, n, factor,
                                                     seed):
    want = jinject(JCFG, jparams, n_channels=n, factor=factor, seed=seed)
    chans = np.asarray(jax.random.choice(jax.random.PRNGKey(seed),
                                         JCFG.d_model, (n,), replace=False))
    got = apply_outliers(TCFG, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu"), chans,
        factor)
    # the same f32 products and quotients: equal bits
    want, got = _flat(want), _flat(got)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_outliers_are_float_equivalent(jparams):
    params = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                               device="cpu")
    out = inject_outliers(TCFG, params, n_channels=12, factor=60.0)
    ln1 = out["stack"]["p0"]["ln1"]["scale"]
    moved = (ln1 != params["stack"]["p0"]["ln1"]["scale"]).any(0)
    assert int(moved.sum()) == 12
    tok = torch.from_numpy(np.random.default_rng(5).integers(4, 256,
                                                             (2, 24)))
    want = lm_forward(TCFG, params, tok)[0]
    got = lm_forward(TCFG, out, tok)[0]
    # w / 60 then (x * 60) @ that: the same function up to f32 rounding
    # of the quotients and products, ~1e-7 of logits of rms ~0.3
    assert float((got - want).abs().max()) <= 1e-5


def test_outlier_channels_are_distinct_draws():
    seen = set()
    for seed in range(20):
        c = outlier_channels(tc.TINY, 12, seed)
        assert len(set(c.tolist())) == 12
        assert 0 <= int(c.min()) and int(c.max()) < tc.TINY.d_model
        seen.update(c.tolist())
        assert torch.equal(c, outlier_channels(tc.TINY, 12, seed))
    # 20 draws of 12 uniform channels cover 192 (1 - (180/192)^20) ~ 139
    # of d 192 on average
    assert len(seen) > 110


def test_real_calibration_returns_corpus_windows():
    corpus, _ = make_corpus(256, 20_000, seed=0)
    gen = torch.Generator()
    gen.manual_seed(0)
    got = real_calibration(corpus, gen, n_samples=16, token_length=64)
    want = np.asarray(jreal(corpus, jax.random.PRNGKey(0), n_samples=16,
                            token_length=64))
    assert got.dtype == torch.int32 and got.shape == want.shape == (16, 64)
    n_windows = (len(corpus) - 1) // 64
    windows = {corpus[w * 64:(w + 1) * 64].tobytes(): w
               for w in range(n_windows)}
    for rows in (got.numpy(), want):
        assert all(r.astype(np.int32).tobytes() in windows for r in rows)
    assert len({windows[r.tobytes()] for r in got.numpy()}) > 8
