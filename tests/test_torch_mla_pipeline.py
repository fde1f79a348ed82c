"""The paper's pipeline on deepseek-v2-lite-16b's SMOKE config (an MLA
dense first block, then MoE blocks with a shared expert) in the port
against the JAX package, on the same seeded weights (every norm scale,
the latent "kvnorm" included, from a numpy seed) and the launcher's
8 x 32 calibration tokens: the self-generated calibration through the
contiguous latent cache, SmoothQuant's fold (ln1 folded twice on an MLA
block, the shared expert's ln2 row rescaling the router and the routed
experts), GPTQ W4 + NT and SmoothQuant W4A8 + NT over the prefix block,
then the stack, with ln1, kvnorm and ln2 tweaked, and the per-channel
scales of a linear whose K is no multiple of the group."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.calibration.generator import _generate_batch as jgenerate
from repro.core.normtweak import pipeline as jpipe
from repro.core.quant import blockquant as jbq
from repro.models.blocks import apply_block as japply
from repro.models.transformer import _embed as jembed
from repro.models.transformer import block_spec as jblock_spec
from repro.models.transformer import get_block as jget
import repro_torch.core.quant.types as tt
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.calibration.generator import _generate_batch
from repro_torch.core.normtweak import pipeline as tpipe
from repro_torch.core.quant import blockquant as tbq
from repro_torch.kernels import ops
from repro_torch.models.blocks import apply_block
from repro_torch.models.transformer import get_block
from repro_torch.utils.tree import tree_get
from test_torch_dense_variants import perturbed_numpy, smoke_pair, to_jax

TCFG, JCFG = smoke_pair("deepseek-v2-lite-16b")
N_SAMPLES, SEQ = 8, 32
NT_KW = dict(lr0=1e-3, iters=1, sample_batch=4, bits=4, group_size=32)
ATTN = ("attn/wq", "attn/wdkv", "attn/wukv", "attn/wo")
DENSE = ATTN + ("mlp/wi", "mlp/wg", "mlp/wo")
MOE = ATTN + ("moe/shared/wi", "moe/shared/wg", "moe/shared/wo",
              "moe/experts/wi", "moe/experts/wg", "moe/experts/wo")
NORMS = ("ln1/scale", "attn/kvnorm/scale", "ln2/scale")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (GPTQ's row loop issues many small ops; see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _port(tree):
    return params_from_numpy(tree, device="cpu")


@pytest.fixture(scope="module")
def setup():
    tree = perturbed_numpy(JCFG)
    tokens = np.random.default_rng(2).integers(0, JCFG.vocab_size,
                                               (N_SAMPLES, SEQ))
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (N_SAMPLES, SEQ))
    jp = to_jax(tree)
    x0 = np.array(jembed(JCFG, jp, jnp.asarray(tokens), None,
                         jnp.asarray(pos)))
    nl = JCFG.n_layers
    return {"tree": tree, "tokens": tokens, "pos": pos, "x0": x0,
            "blocks": [_np(jget(JCFG, jp, i)) for i in range(nl)],
            "specs": [jblock_spec(JCFG, i) for i in range(nl)]}


def _taps(setup, li):
    jtaps, ttaps = {}, {}
    x, pos = setup["x0"], setup["pos"]
    japply(JCFG, setup["specs"][li], to_jax(setup["blocks"][li]),
           jnp.asarray(x), positions=jnp.asarray(pos), taps=jtaps)
    apply_block(TCFG, _port(setup["blocks"][li]), torch.from_numpy(x),
                positions=torch.from_numpy(pos.copy()), taps=ttaps)
    return jtaps, ttaps


def _leaf(tree, path):
    return np.asarray(tree_get(tree, path))


def test_greedy_calibration_matches_jax(setup):
    """Self-generated calibration through ``lm_decode`` on the contiguous
    latent cache (the absorbed decode), greedy after injected first
    tokens: the same tokens."""
    first = np.random.default_rng(3).integers(0, JCFG.vocab_size, 4)
    want = np.asarray(jgenerate(JCFG, to_jax(setup["tree"]),
                                jnp.asarray(first, jnp.int32),
                                jax.random.PRNGKey(1), 16,
                                stochastic_prefix=0))
    got = _generate_batch(TCFG, _port(setup["tree"]),
                          torch.from_numpy(first),
                          torch.Generator().manual_seed(1), 16,
                          stochastic_prefix=0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("li", [0, 1])
def test_smoothquant_fold_matches_jax(setup, li):
    """SmoothQuant's fold as the JAX package's, to 1e-6 relative, on the
    MLA dense block (li 0) and an MLA MoE block (li 1). ln1 is folded
    twice: the GQA row matches through wq alone, then the MLA row scales wq
    and wdkv, so wq carries both factors and wdkv only the second — the
    smoothed block computes another function than the float one (the JAX
    package's behaviour, reproduced: ROADMAP.md §3). On the MoE block the
    shared expert's ln2 row fires and scales the router's and the routed
    experts' wi / wg rows by its factor too."""
    jtaps, ttaps = _taps(setup, li)
    assert sorted(ttaps) == sorted(jtaps)
    block = setup["blocks"][li]
    jb = _np(jbq.smooth_block(to_jax(block), jtaps, 0.5))
    tb = tbq.smooth_block(_port(block), ttaps, 0.5)
    paths = [n for n in NORMS if n != "attn/kvnorm/scale"] + [
        p + "/w" for p in (DENSE if li == 0 else MOE)] + (
        ["moe/router/w"] if li else [])
    for path in paths:
        np.testing.assert_allclose(tree_get(tb, path).numpy(),
                                   _leaf(jb, path), rtol=1e-6, atol=1e-7)
    # the factors the fold left on each ln1 linear's rows
    fold = _leaf(block, "ln1/scale") / tb["ln1"]["scale"].numpy()
    wq = tb["attn"]["wq"]["w"].numpy() / block["attn"]["wq"]["w"]
    wdkv = tb["attn"]["wdkv"]["w"].numpy() / block["attn"]["wdkv"]["w"]
    np.testing.assert_allclose(wq, np.broadcast_to(fold[:, None], wq.shape),
                               rtol=1e-5)
    assert np.abs(wdkv[:, 0] / fold - 1).max() > 1e-2
    np.testing.assert_array_equal(tb["attn"]["kvnorm"]["scale"].numpy(),
                                  block["attn"]["kvnorm"]["scale"])
    if li:
        s = block["ln2"]["scale"] / tb["ln2"]["scale"].numpy()
        for path in ("moe/router/w", "moe/experts/wi/w", "moe/experts/wg/w"):
            ratio = tree_get(tb, path).numpy() / _leaf(block, path)
            axis = -2
            want = np.expand_dims(s, tuple(a for a in range(ratio.ndim)
                                           if a != ratio.ndim + axis))
            np.testing.assert_allclose(ratio, np.broadcast_to(want,
                                                              ratio.shape),
                                       rtol=1e-5)


def test_per_channel_where_k_is_no_group_multiple(setup):
    """The deploy's rule inside ``quantize_block``: at group 64 the prefix
    block's wukv (K 32) and mlp/wo (K 160) take per-channel scales, equal
    to a group -1 quantization of the same linear; the others keep
    groups of 64. (The JAX package raises on such a linear instead.)"""
    _, ttaps = _taps(setup, 0)
    block = setup["blocks"][0]
    got = tbq.quantize_block(_port(block), ttaps, method="gptq", bits=4,
                             group_size=64)
    per_ch = tbq.quantize_block(_port(block), ttaps, method="gptq", bits=4,
                                group_size=-1)
    for path in DENSE:
        w = tree_get(got, path)["w"]
        if w.k % 64:
            assert w.group_size == -1 and w.scale.shape[0] == 1
            assert torch.equal(w.qw, tree_get(per_ch, path)["w"].qw)
        else:
            assert w.group_size == 64 and w.scale.shape[0] == w.k // 64
    with pytest.raises(AssertionError):
        jbq.quantize_block(to_jax(block), _taps(setup, 0)[0],
                           method="rtn", bits=4, group_size=64)


def _code_diff(tw, jw):
    got = tt.unpack(tw.qw, tw.bits, tw.k).numpy().astype(np.int64)
    want = tt.unpack(torch.from_numpy(np.array(jw.qw)), tw.bits,
                     tw.k).numpy().astype(np.int64)
    return np.abs(got - want)


@pytest.mark.parametrize("method", ["gptq", "smoothquant"])
def test_pipeline_matches_jax(setup, method, monkeypatch):
    """``norm_tweak_ptq`` on the whole model (the prefix block, then the
    two MoE repeats) in both packages, each on its own quantized stream,
    the port's packed products set to the JAX CPU path's function (f32 x
    times the f32 dequantized weight; the JAX package cannot differentiate
    its kernel). Both return the prefix block under "prefix/0" and every
    linear but the routers packed.

    Layer 0, the MLA dense block, on the same inputs in both:
    SmoothQuant W4A8 (RTN after the fold) >= 99.9% of codes equal and none
    more than a step apart, ln1, kvnorm and ln2 within 1e-2 lr of JAX's,
    the loss within 1e-3; GPTQ W4, whose row loop runs in f32 in the JAX
    package and in f64 with a blocked update in the port (a value within
    rounding of a boundary rounds the other way and moves every later
    row; tests/test_torch_dense_variants_pipeline.py), >= 99% of codes
    equal, the loss within 5% and the norms within a mean of 0.5 lr. The
    MoE layers take streams that layer 0's last-bit differences set apart,
    and an MoE's ln2 reaches the loss through the float router, whose
    dense gradient has near-zero components whose sign the two packages'
    f32 sums set apart (measured on SmoothQuant: 2 of layer 1's 64 ln2
    channels 0.043 lr apart): their tweak is held on equal quantized
    blocks in ``test_tweak_matches_jax``.

    Every layer's ln1, kvnorm and ln2 moved from the untweaked run's by
    more than 0.5 lr (Adam's first step moves a channel by about lr)."""
    act_bits = 8 if method == "smoothquant" else 0
    kw = dict(method=method, act_bits=act_bits, **NT_KW)
    jq, jstats = jpipe.norm_tweak_ptq(JCFG, to_jax(setup["tree"]),
                                      jnp.asarray(setup["tokens"]),
                                      jpipe.NTConfig(**kw))
    f32 = lambda x, qt: torch.matmul(x, tt.dequantize(qt))  # noqa: E731
    monkeypatch.setattr(ops, "dequant_matmul", f32)
    monkeypatch.setattr(ops, "expert_dequant_matmul", f32)
    tq, tstats = tpipe.norm_tweak_ptq(
        TCFG, _port(setup["tree"]), torch.from_numpy(setup["tokens"]),
        tpipe.NTConfig(**kw))
    assert tstats["layer_lr"] == jstats["layer_lr"]
    assert sorted(tq["prefix"]) == sorted(jq["prefix"]) == ["0"]
    np.testing.assert_allclose(tstats["layer_loss"][0],
                               jstats["layer_loss"][0],
                               rtol=5e-2 if method == "gptq" else 1e-3)
    for li in range(JCFG.n_layers):
        tb, jb = get_block(TCFG, tq, li), _np(jget(JCFG, jq, li))
        for path in (DENSE if li == 0 else MOE):
            tw, jw = tree_get(tb, path)["w"], tree_get(jb, path)["w"]
            assert isinstance(tw, tt.QuantizedTensor)
            assert tw.act_bits == act_bits and tw.qw.shape == jw.qw.shape
            if li == 0:
                diff = _code_diff(tw, jw)
                if method == "gptq":
                    assert (diff == 0).mean() >= 0.99, path
                else:
                    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
        if li:
            assert not isinstance(tb["moe"]["router"]["w"],
                                  tt.QuantizedTensor)
    lr = tstats["layer_lr"][0]
    tb, jb = get_block(TCFG, tq, 0), _np(jget(JCFG, jq, 0))
    for norm in NORMS:
        err = np.abs(tree_get(tb, norm).numpy() - _leaf(jb, norm))
        if method == "gptq":
            assert err.mean() <= 0.5 * lr, norm
        else:
            assert err.max() <= 1e-2 * lr, norm
    untweaked, _ = tpipe.norm_tweak_ptq(
        TCFG, _port(setup["tree"]), torch.from_numpy(setup["tokens"]),
        tpipe.NTConfig(tweak=False, **kw))
    for li, lr in enumerate(tstats["layer_lr"]):
        tb, ub = get_block(TCFG, tq, li), get_block(TCFG, untweaked, li)
        for norm in NORMS:
            moved = (tree_get(tb, norm) - tree_get(ub, norm)).abs()
            assert float(moved.max()) > 0.5 * lr, (li, norm)


@pytest.mark.parametrize("method", ["gptq", "smoothquant"])
def test_tweak_matches_jax(setup, method, monkeypatch):
    """Both packages tweak the same quantized blocks, the JAX package's
    untweaked ones along its own stream (``quantize_block`` replaced in
    both pipelines, tests/test_torch_moe.py's method), over the prefix
    block and the two MoE repeats, the port's packed products set to the
    JAX CPU path's function: ln1, kvnorm and ln2 of every layer move the
    same channels and stay within 1e-3 lr of JAX's, and the layers' final
    losses agree to 1e-4 (Mixtral's bounds there). No other leaf moves."""
    act_bits = 8 if method == "smoothquant" else 0
    kw = dict(method=method, act_bits=act_bits, **NT_KW)
    jblocks, _, _ = jpipe.tweak_layers(
        JCFG, setup["specs"], to_jax(setup["blocks"]),
        jnp.asarray(setup["x0"]), jpipe.NTConfig(tweak=False, **kw))
    jblocks = [_np(b) for b in jblocks]
    tq = [_port(b) for b in jblocks]
    jit, tit = iter(to_jax(jblocks)), iter(tq)
    monkeypatch.setattr(jpipe, "quantize_block", lambda *a, **k: next(jit))
    monkeypatch.setattr(tpipe, "quantize_block", lambda *a, **k: next(tit))
    f32 = lambda x, qt: torch.matmul(x, tt.dequantize(qt))  # noqa: E731
    monkeypatch.setattr(ops, "dequant_matmul", f32)
    monkeypatch.setattr(ops, "expert_dequant_matmul", f32)
    jout, _, jstats = jpipe.tweak_layers(
        JCFG, setup["specs"], to_jax(setup["blocks"]),
        jnp.asarray(setup["x0"]), jpipe.NTConfig(**kw))
    tout, _, tstats = tpipe.tweak_layers(
        TCFG, [_port(b) for b in setup["blocks"]],
        torch.from_numpy(setup["x0"]), tpipe.NTConfig(**kw))
    assert tstats["layer_lr"] == jstats["layer_lr"]
    np.testing.assert_allclose(tstats["layer_loss"], jstats["layer_loss"],
                               rtol=1e-4)
    for li, (j0, t0, jb, tb) in enumerate(zip(jblocks, tq, jout, tout)):
        lr = tstats["layer_lr"][li]
        for path in (DENSE if li == 0 else MOE):
            w0, w1 = tree_get(t0, path)["w"], tree_get(tb, path)["w"]
            assert torch.equal(w0.qw, w1.qw) and torch.equal(w0.scale,
                                                            w1.scale)
        for norm in NORMS:
            jd = _leaf(jb, norm) - _leaf(j0, norm)
            td = (tree_get(tb, norm) - tree_get(t0, norm)).numpy()
            np.testing.assert_array_equal(td != 0, jd != 0)
            assert np.abs(td - jd).max() <= 1e-3 * lr, (li, norm)
            assert np.abs(jd).max() > 0.5 * lr, (li, norm)
