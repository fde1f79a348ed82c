"""The port's GPTQ (and the RTN / SmoothQuant block drivers) against the
JAX package's on the same inputs, made with numpy from a seed."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.quant import blockquant as jbq
from repro.core.quant import gptq as jg
from repro.models.blocks import apply_block as japply
from repro.models.transformer import get_block as jget
from repro.models.transformer import init_lm as jinit
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.quant import blockquant as tbq
from repro_torch.core.quant import gptq as tg
from repro_torch.core.quant.types import QuantizedTensor, unpack
from repro_torch.models.blocks import apply_block
from repro_torch.models.transformer import get_block
from repro_torch.utils.tree import tree_get


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs. GPTQ's row loop (and the
    engine's decode loop) issues thousands of small ops; when several test
    processes share the machine, each op's thread-pool barrier waits on
    descheduled threads (the launcher's TINY GPTQ pipeline on an 8-core
    CPU: 3.6 s alone; 915 s each for six processes at the default thread
    count, 2 s each with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(t, k, n, seed, dead=()):
    """Correlated calibration inputs (T, K) and a weight (K, N); ``dead``
    input channels are all zero."""
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(k, k)) / np.sqrt(k) + np.eye(k)
    x = (rng.normal(size=(t, k)) @ mix).astype(np.float32)
    x[:, list(dead)] = 0.0
    w = (rng.normal(size=(k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


def _assert_codes_close(got, want):
    """GPTQ's row loop feeds each rounding on the errors of all rows before
    it. The JAX package runs it (and its LAPACK inverse and Cholesky) in
    f32, the port in f64 with a blocked update (a sum in another order),
    so a value within f32 rounding of a boundary may round the other way:
    at least 99% of codes equal, none more than one step apart."""
    diff = np.abs(got.astype(np.int64) - want.astype(np.int64))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def test_hessian_matches_jax():
    x, _ = _inputs(96, 64, 8, seed=0)
    x = x.reshape(2, 48, 64)
    want = np.asarray(jg.hessian_from_inputs(jnp.asarray(x)))
    got = tg.hessian_from_inputs(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


# (K, N, bits, group, actorder, dead input channels): TINY's K = 192 and
# 576 (two and five of the port's 128-row blocks), per-channel and grouped
# scales, W2-W4
GPTQ_CASES = [(192, 64, 4, -1, False, ()), (192, 64, 4, 32, True, ()),
              (192, 48, 3, 64, False, (5, 17, 130)),
              (576, 32, 4, 64, True, (0, 300)), (192, 64, 2, 32, False, ())]


@pytest.mark.parametrize("k,n,bits,group,actorder,dead", GPTQ_CASES)
def test_gptq_matches_jax(k, n, bits, group, actorder, dead):
    x, w = _inputs(256, k, n, seed=k + n + bits, dead=dead)
    h = np.asarray(jg.hessian_from_inputs(jnp.asarray(x)))
    qj, sj, ej = jg.gptq_quantize_array(jnp.asarray(w), jnp.asarray(h),
                                        bits=bits, group_size=group,
                                        actorder=actorder)
    qt, st, et = tg.gptq_quantize_array(torch.from_numpy(w),
                                        torch.from_numpy(h), bits=bits,
                                        group_size=group, actorder=actorder)
    # scales come from the (dead-row-zeroed) weights alone: amax / qmax in
    # f32; XLA may compile the division inside the jitted JAX function as
    # a product with 1/qmax, one ulp off: 2.5e-7 relative
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=2.5e-7,
                               atol=0)
    _assert_codes_close(qt.numpy(), np.asarray(qj))
    for c in dead:                              # dead rows quantize to 0
        assert not qt[c].any()
    # the reconstruction error follows the codes: within 5%
    assert abs(float(et) - float(ej)) <= 0.05 * float(ej)


def test_gptq_quantize_packs_the_codes():
    x, w = _inputs(128, 192, 32, seed=5)
    h = tg.hessian_from_inputs(torch.from_numpy(x))
    qt, err = tg.gptq_quantize(torch.from_numpy(w), h, bits=3, group_size=32,
                               act_bits=8)
    q, scale, _ = tg.gptq_quantize_array(torch.from_numpy(w), h, bits=3,
                                         group_size=32)
    assert isinstance(qt, QuantizedTensor) and qt.act_bits == 8
    assert qt.shape == (192, 32) and torch.equal(qt.scale, scale)
    assert torch.equal(unpack(qt.qw, 3, 192), q)
    assert float(err) > 0


@pytest.fixture(scope="module")
def tiny_block():
    """TINY's block 0 and its calibration taps in both packages, from the
    same seeded weights and inputs: the launcher's 8 samples x 32 tokens."""
    jp = jinit(jc.TINY, jax.random.PRNGKey(0))
    jb = jget(jc.TINY, jp, 0)
    tb = get_block(tc.TINY, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jp), device="cpu"), 0)
    x = np.random.default_rng(0).normal(size=(8, 32, 192)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (8, 32))
    jtaps, ttaps = {}, {}
    japply(jc.TINY, jc.TINY.pattern[0], jb, jnp.asarray(x),
           positions=jnp.asarray(pos), taps=jtaps)
    apply_block(tc.TINY, tb, torch.from_numpy(x),
                positions=torch.from_numpy(pos.copy()), taps=ttaps)
    return jb, tb, jtaps, ttaps


def test_taps_match_jax(tiny_block):
    _, _, jtaps, ttaps = tiny_block
    assert sorted(ttaps) == sorted(jtaps)
    for key in jtaps:
        np.testing.assert_allclose(ttaps[key].numpy(), np.asarray(jtaps[key]),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("method", ["gptq", "rtn", "smoothquant"])
def test_quantize_block_matches_jax(tiny_block, method):
    jb, tb, jtaps, ttaps = tiny_block
    act_bits = 8 if method == "smoothquant" else 0
    kw = dict(method=method, bits=4, group_size=64, act_bits=act_bits)
    jq = jbq.quantize_block(jb, jtaps, **kw)
    tq = tbq.quantize_block(tb, ttaps, **kw)
    paths = [path for path, _ in jbq.iter_linears(jb)]
    assert len(paths) == 7
    for path in paths:
        tw = tree_get(tq, path)["w"]
        jw = tree_get(jq, path)["w"]
        assert isinstance(tw, QuantizedTensor) and tw.act_bits == act_bits
        k = tw.k
        codes_t = unpack(tw.qw, 4, k).numpy()
        codes_j = np.asarray(unpack(torch.from_numpy(np.asarray(jw.qw)), 4,
                                    k))
        if method == "gptq":
            _assert_codes_close(codes_t, codes_j)
        else:
            # RTN of the same (smoothed) weights: a value within an ulp of a
            # rounding boundary may round the other way
            assert (codes_t == codes_j).mean() >= 0.999
        np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale),
                                   rtol=1e-5)
    for norm in ("ln1", "ln2"):                 # SmoothQuant folds 1/s here
        np.testing.assert_allclose(tq[norm]["scale"].numpy(),
                                   np.asarray(jq[norm]["scale"]), rtol=1e-5)
