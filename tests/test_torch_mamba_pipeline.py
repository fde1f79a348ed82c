"""The paper's pipeline on the SMOKE configs of mamba2-2.7b (mamba blocks
with no MLP) and jamba-1.5-large-398b (mamba and attention blocks, dense
MLPs and MoEs) in the port against the JAX package, on the same seeded
weights (``perturbed_mamba_numpy``) and the launcher's 8 x 32 calibration
tokens: the self-generated calibration through the contiguous cache that
carries SSM state, SmoothQuant's fold of ln1 into in_proj (out_proj
unsmoothed), RTN / GPTQ W4 / SmoothQuant W4A8 + NT over every layer with
ln1, the gated norm "gnorm" and ln2 tweaked through autograd over the
SSD."""
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
from test_torch_dense_variants import smoke_pair, to_jax
from test_torch_mamba import perturbed_mamba_numpy

ARCHS = ["mamba2-2.7b", "jamba-1.5-large-398b"]
N_SAMPLES, SEQ = 8, 32
NT_KW = dict(lr0=1e-3, iters=1, sample_batch=4, bits=4, group_size=32)


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
def setups():
    out = {}
    for arch in ARCHS:
        tcfg, jcfg = smoke_pair(arch)
        tree = perturbed_mamba_numpy(jcfg)
        tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                                   (N_SAMPLES, SEQ))
        pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32),
                              (N_SAMPLES, SEQ))
        jp = to_jax(tree)
        x0 = np.array(jembed(jcfg, jp, jnp.asarray(tokens), None,
                             jnp.asarray(pos)))
        nl = jcfg.n_layers
        out[arch] = {"tcfg": tcfg, "jcfg": jcfg, "tree": tree,
                     "tokens": tokens, "pos": pos, "x0": x0,
                     "blocks": [_np(jget(jcfg, jp, i)) for i in range(nl)],
                     "specs": [jblock_spec(jcfg, i) for i in range(nl)]}
    return out


def _linears(block):
    return [p for p, _ in tbq.iter_linears(block) if "router" not in p]


def _norms(block):
    """The tweakable norm scales of a block: ln1, gnorm, and ln2 under an
    MLP or MoE."""
    out = ["ln1/scale"]
    if "mamba" in block:
        out.append("mamba/gnorm/scale")
    if "ln2" in block:
        out.append("ln2/scale")
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_calibration_matches_jax(setups, arch):
    """Self-generated calibration through ``lm_decode`` on the contiguous
    cache (the SSM decode step), greedy after injected first tokens: the
    same tokens."""
    s = setups[arch]
    first = np.random.default_rng(3).integers(0, s["jcfg"].vocab_size, 4)
    want = np.asarray(jgenerate(s["jcfg"], to_jax(s["tree"]),
                                jnp.asarray(first, jnp.int32),
                                jax.random.PRNGKey(1), 16,
                                stochastic_prefix=0))
    got = _generate_batch(s["tcfg"], _port(s["tree"]),
                          torch.from_numpy(first),
                          torch.Generator().manual_seed(1), 16,
                          stochastic_prefix=0).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_taps_and_smoothquant_fold_match_jax(setups, arch):
    """Layer 0's calibration taps ("mamba/in_proj", "mamba/out_proj", the
    MLP's) equal JAX's to 1e-5, and SmoothQuant's fold of ln1 into
    in_proj (the reference's ("ln1", ["mamba/in_proj"]) row) to 1e-6
    relative; out_proj and the gated norm are left as they are."""
    s = setups[arch]
    jtaps, ttaps = {}, {}
    x, pos = s["x0"], s["pos"]
    japply(s["jcfg"], s["specs"][0], to_jax(s["blocks"][0]), jnp.asarray(x),
           positions=jnp.asarray(pos), taps=jtaps)
    apply_block(s["tcfg"], _port(s["blocks"][0]), torch.from_numpy(x),
                positions=torch.from_numpy(pos.copy()), taps=ttaps)
    assert "mamba/in_proj" in ttaps and "mamba/out_proj" in ttaps
    assert sorted(ttaps) == sorted(jtaps)
    for key in ttaps:
        np.testing.assert_allclose(ttaps[key].numpy(),
                                   np.asarray(jtaps[key]), rtol=0,
                                   atol=1e-5, err_msg=key)
    jf = _np(jbq.smooth_block(to_jax(s["blocks"][0]), jtaps))
    tf = tbq.smooth_block(_port(s["blocks"][0]), ttaps)
    for path in ("ln1/scale", "mamba/in_proj/w", "mamba/out_proj/w",
                 "mamba/gnorm/scale"):
        np.testing.assert_allclose(tree_get(tf, path).numpy(),
                                   np.asarray(tree_get(jf, path)),
                                   rtol=1e-6, atol=1e-7, err_msg=path)
    for path in ("mamba/out_proj/w", "mamba/gnorm/scale"):
        np.testing.assert_array_equal(tree_get(tf, path).numpy(),
                                      tree_get(s["blocks"][0], path))
    assert not np.array_equal(tree_get(tf, "ln1/scale").numpy(),
                              tree_get(s["blocks"][0], "ln1/scale"))


def _code_diff(tw, jw):
    got = tt.unpack(tw.qw, tw.bits, tw.k).numpy().astype(np.int64)
    want = tt.unpack(torch.from_numpy(np.array(jw.qw)), tw.bits,
                     tw.k).numpy().astype(np.int64)
    return np.abs(got - want)


def _f32_products(monkeypatch):
    """The port's packed products set to the JAX CPU path's function (f32
    x times the f32 dequantized weight; the JAX package cannot
    differentiate its kernel)."""
    f32 = lambda x, qt: torch.matmul(x, tt.dequantize(qt))  # noqa: E731
    monkeypatch.setattr(ops, "dequant_matmul", f32)
    monkeypatch.setattr(ops, "expert_dequant_matmul", f32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("method", ["rtn", "gptq", "smoothquant"])
def test_pipeline_matches_jax(setups, arch, method, monkeypatch):
    """``norm_tweak_ptq`` on the whole model in both packages, each on its
    own quantized stream. Every linear but the routers packed, conv and
    the SSM leaves float. RTN: every packed byte equal (RTN reads only the
    float weights). Layer 0 on the same inputs in both: SmoothQuant W4A8
    >= 99.9% of codes equal, none more than a step apart, ln1 and gnorm
    (and ln2) within 1e-2 lr; GPTQ W4 (f32 row loop in the JAX package,
    f64 blocked in the port: tests/test_torch_dense_variants_pipeline.py)
    >= 99% of codes equal and the norms within a mean of 0.5 lr; RTN's
    norms within 1e-2 lr. The losses of layer 0 within 5% (GPTQ) or 1e-3.
    Every layer's ln1 and gnorm (and ln2) moved from the untweaked run's
    by more than 0.5 lr."""
    s = setups[arch]
    tcfg, jcfg = s["tcfg"], s["jcfg"]
    act_bits = 8 if method == "smoothquant" else 0
    kw = dict(method=method, act_bits=act_bits, **NT_KW)
    jq, jstats = jpipe.norm_tweak_ptq(jcfg, to_jax(s["tree"]),
                                      jnp.asarray(s["tokens"]),
                                      jpipe.NTConfig(**kw))
    _f32_products(monkeypatch)
    tq, tstats = tpipe.norm_tweak_ptq(
        tcfg, _port(s["tree"]), torch.from_numpy(s["tokens"]),
        tpipe.NTConfig(**kw))
    assert tstats["layer_lr"] == jstats["layer_lr"]
    np.testing.assert_allclose(tstats["layer_loss"][0],
                               jstats["layer_loss"][0],
                               rtol=5e-2 if method == "gptq" else 1e-3)
    for li in range(jcfg.n_layers):
        tb, jb = get_block(tcfg, tq, li), _np(jget(jcfg, jq, li))
        for path in _linears(tb):
            tw, jw = tree_get(tb, path)["w"], tree_get(jb, path)["w"]
            assert isinstance(tw, tt.QuantizedTensor), path
            assert tw.act_bits == act_bits and tw.qw.shape == jw.qw.shape
            if method == "rtn":
                np.testing.assert_array_equal(tw.qw.numpy(),
                                              np.asarray(jw.qw))
            elif li == 0:
                diff = _code_diff(tw, jw)
                if method == "gptq":
                    assert (diff == 0).mean() >= 0.99, path
                else:
                    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
        if "mamba" in tb:
            assert not isinstance(tb["mamba"]["conv_w"], tt.QuantizedTensor)
            assert tb["mamba"]["A_log"].dtype == torch.float32
    lr = tstats["layer_lr"][0]
    tb, jb = get_block(tcfg, tq, 0), _np(jget(jcfg, jq, 0))
    for norm in _norms(tb):
        err = np.abs(tree_get(tb, norm).numpy()
                     - np.asarray(tree_get(jb, norm)))
        if method == "gptq":
            assert err.mean() <= 0.5 * lr, norm
        else:
            assert err.max() <= 1e-2 * lr, norm
    untweaked, _ = tpipe.norm_tweak_ptq(
        tcfg, _port(s["tree"]), torch.from_numpy(s["tokens"]),
        tpipe.NTConfig(tweak=False, **kw))
    for li, lr in enumerate(tstats["layer_lr"]):
        tb, ub = get_block(tcfg, tq, li), get_block(tcfg, untweaked, li)
        for norm in _norms(tb):
            moved = (tree_get(tb, norm) - tree_get(ub, norm)).abs()
            assert float(moved.max()) > 0.5 * lr, (li, norm)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("method", ["gptq", "smoothquant"])
def test_tweak_matches_jax(setups, arch, method, monkeypatch):
    """Both packages tweak the same quantized blocks (the JAX package's
    untweaked ones along its own stream, ``quantize_block`` replaced in
    both pipelines), layer by layer on the same input, the JAX package's
    tweaked stream: ln1, gnorm and ln2 move the same channels and stay
    within 1e-3 lr of JAX's, the layer's final loss agrees to 1e-4 and
    no linear moves. Each layer starts from JAX's stream because W4A8's
    per-token int8 rounding turns a last-bit difference of the stream
    into a step of one element (measured: the layer outputs of the two
    packages on equal inputs agree to 2e-6 but for such flips of up to
    0.016 in layers 0, 1 and 6 of Jamba), which the next layers carry."""
    s = setups[arch]
    tcfg, jcfg = s["tcfg"], s["jcfg"]
    nl = jcfg.n_layers
    act_bits = 8 if method == "smoothquant" else 0
    kw = dict(method=method, act_bits=act_bits, **NT_KW)
    jblocks, _, _ = jpipe.tweak_layers(
        jcfg, s["specs"], to_jax(s["blocks"]), jnp.asarray(s["x0"]),
        jpipe.NTConfig(tweak=False, **kw))
    jblocks = [_np(b) for b in jblocks]
    _f32_products(monkeypatch)
    x = jnp.asarray(s["x0"])
    for li in range(nl):
        monkeypatch.setattr(jpipe, "quantize_block",
                            lambda *a, **k: to_jax(jblocks[li]))
        monkeypatch.setattr(tpipe, "quantize_block",
                            lambda *a, **k: _port(jblocks[li]))
        (jb,), x_next, jstats = jpipe.tweak_layers(
            jcfg, [s["specs"][li]], [to_jax(s["blocks"][li])], x,
            jpipe.NTConfig(**kw), layer_offset=li, total_layers=nl)
        (tb,), _, tstats = tpipe.tweak_layers(
            tcfg, [_port(s["blocks"][li])], torch.from_numpy(np.array(x)),
            tpipe.NTConfig(**kw), layer_offset=li, total_layers=nl)
        assert tstats["layer_lr"] == jstats["layer_lr"]
        np.testing.assert_allclose(tstats["layer_loss"],
                                   jstats["layer_loss"], rtol=1e-4)
        lr = tstats["layer_lr"][0]
        t0, j0 = _port(jblocks[li]), jblocks[li]
        for path in _linears(t0):
            w0, w1 = tree_get(t0, path)["w"], tree_get(tb, path)["w"]
            assert torch.equal(w0.qw, w1.qw) and torch.equal(w0.scale,
                                                            w1.scale)
        for norm in _norms(t0):
            jd = np.asarray(tree_get(jb, norm)) - tree_get(j0, norm)
            td = (tree_get(tb, norm) - tree_get(t0, norm)).numpy()
            np.testing.assert_array_equal(td != 0, jd != 0)
            assert np.abs(td - jd).max() <= 1e-3 * lr, (li, norm)
            assert np.abs(jd).max() > 0.5 * lr, (li, norm)
        x = x_next
