"""The port's norm tweaking against the JAX package's on the same inputs,
made with numpy from a seed: the losses, the layer LR, one Adam update, the
tweak of quantized TINY blocks (GPTQ W4 and SmoothQuant W4A8) and the A8
gradient."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.normtweak import losses as jl
from repro.core.normtweak import pipeline as jpipe
from repro.core.normtweak.schedule import layer_lr as jlayer_lr
from repro.models.blocks import apply_block as japply
from repro.models.norms import is_norm_path as jis_norm_path
from repro.models.transformer import _embed as jembed
from repro.models.transformer import block_spec as jblock_spec
from repro.models.transformer import get_block as jget
from repro.models.transformer import init_lm as jinit
from repro.optim.adam import adam_init as jadam_init
from repro.optim.adam import adam_update as jadam_update
from repro.utils.tree import tree_merge as jmerge
from repro.utils.tree import tree_partition as jpartition
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.normtweak import losses as tl
from repro_torch.core.normtweak import pipeline as tpipe
from repro_torch.core.normtweak.schedule import layer_lr
from repro_torch.core.quant.types import QuantizedTensor, dequantize
from repro_torch.kernels import ops
from repro_torch.models.blocks import apply_block
from repro_torch.models.norms import is_norm_path
from repro_torch.optim.adam import adam_init, adam_update
from repro_torch.utils.tree import (tree_get, tree_map, tree_merge,
                                    tree_partition)

JCFG = jc.TINY.replace(n_repeats=2)
TCFG = tc.TINY.replace(n_repeats=2)
# the launcher's calibration set (8 samples x 32 tokens) and NT settings
N_SAMPLES, SEQ = 8, 32
NT_KW = dict(lr0=1e-3, iters=1, sample_batch=4, bits=4, group_size=64)


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


def _np(tree):
    """A numpy copy (the JAX tweak donates its norm buffers)."""
    return jax.tree_util.tree_map(np.array, tree)


def _jax(tree):
    """Fresh JAX arrays of a numpy tree, for one JAX call."""
    return jax.tree_util.tree_map(jnp.array, tree)


def _to_port(tree):
    return params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("name", ["dist", "mse", "kl", "divergence"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(0)
    f = rng.normal(size=(4, 32, 64)).astype(np.float32)
    q = (f + 0.1 * rng.normal(size=f.shape) + 0.05).astype(np.float32)
    jfn = (jl.activation_divergence if name == "divergence"
           else jl.LOSSES[name])
    tfn = (tl.activation_divergence if name == "divergence"
           else tl.LOSSES[name])
    want = float(jfn(jnp.asarray(f), jnp.asarray(q)))
    got = float(tfn(torch.from_numpy(f), torch.from_numpy(q)))
    # f32 means and variances summed in another order
    assert abs(got - want) <= 1e-6 * max(1.0, abs(want))


def test_layer_lr_matches_jax():
    for li in range(16):
        assert layer_lr(1e-3, 10.0, li, 16) == jlayer_lr(1e-3, 10.0, li, 16)


def test_adam_update_matches_jax():
    """Two steps on a norm tree with the holes ``tree_partition`` leaves."""
    rng = np.random.default_rng(1)
    block = {"ln1": {"scale": rng.normal(size=64).astype(np.float32)},
             "attn": {"wq": {"w": rng.normal(size=(64, 8)).astype(
                 np.float32)}},
             "ln2": {"scale": rng.normal(size=64).astype(np.float32)}}
    jn, _ = jpartition(jax.tree_util.tree_map(jnp.asarray, block),
                       jis_norm_path)
    tn, _ = tree_partition(tree_map(torch.from_numpy, block), is_norm_path)
    js, ts = jadam_init(jn), adam_init(tn)
    for step in range(2):
        g = {k: (rng.normal(size=v.shape) * 1e-3).astype(np.float32)
             for k, v in (("ln1", block["ln1"]["scale"]),
                          ("ln2", block["ln2"]["scale"]))}
        g = {**{k: {"scale": v} for k, v in g.items()},
             "attn": block["attn"]}
        jg, _ = jpartition(jax.tree_util.tree_map(jnp.asarray, g),
                           jis_norm_path)
        tg, _ = tree_partition(tree_map(torch.from_numpy, g), is_norm_path)
        jn, js = jadam_update(jg, js, jn, lr=1e-3 * (step + 1))
        tn, ts = adam_update(tg, ts, tn, lr=1e-3 * (step + 1))
        for k in ("ln1", "ln2"):
            np.testing.assert_allclose(tn[k]["scale"].numpy(),
                                       np.asarray(jn[k]["scale"]),
                                       rtol=1e-6, atol=1e-9)
            np.testing.assert_allclose(ts["v"][k]["scale"].numpy(),
                                       np.asarray(js["v"][k]["scale"]),
                                       rtol=1e-6, atol=1e-15)
    assert tn["attn"]["wq"]["w"] is None
    assert ts["step"] == int(js["step"]) == 2


@pytest.fixture(scope="module")
def setup():
    jp = jinit(JCFG, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(2).integers(0, JCFG.vocab_size,
                                               (N_SAMPLES, SEQ))
    pos = jnp.broadcast_to(jnp.arange(SEQ, dtype=jnp.int32)[None],
                           (N_SAMPLES, SEQ))
    x0 = np.asarray(jembed(JCFG, jp, jnp.asarray(tokens), None, pos))
    nl = JCFG.n_layers
    return {"blocks": [_np(jget(JCFG, jp, i)) for i in range(nl)],
            "specs": [jblock_spec(JCFG, i) for i in range(nl)], "x0": x0,
            "quantized": {}}


def _quantized_blocks(setup, method):
    """The JAX package's quantized blocks (GPTQ or SmoothQuant W4A8 along
    its own quantized stream, untweaked), as numpy."""
    if method not in setup["quantized"]:
        nt = jpipe.NTConfig(method=method, tweak=False,
                            act_bits=8 if method == "smoothquant" else 0,
                            **NT_KW)
        qblocks, _, _ = jpipe.tweak_layers(JCFG, setup["specs"],
                                           _jax(setup["blocks"]),
                                           jnp.asarray(setup["x0"]), nt)
        setup["quantized"][method] = [_np(b) for b in qblocks]
    return setup["quantized"][method]


def _tweak_both(setup, method, monkeypatch):
    """Both packages tweak the same quantized blocks (the JAX package's,
    converted): ``quantize_block`` is replaced in both pipelines by a
    function that hands out those blocks in layer order, so code flips
    between the two GPTQs do not mask the tweak. Returns, per layer and
    norm, (port delta, JAX delta, lr), and the two stats."""
    jq = _quantized_blocks(setup, method)
    tq = [_to_port(b) for b in jq]
    jit, tit = iter(_jax(jq)), iter(tq)
    monkeypatch.setattr(jpipe, "quantize_block", lambda *a, **k: next(jit))
    monkeypatch.setattr(tpipe, "quantize_block", lambda *a, **k: next(tit))
    act_bits = 8 if method == "smoothquant" else 0
    jnt = jpipe.NTConfig(method=method, act_bits=act_bits, **NT_KW)
    tnt = tpipe.NTConfig(method=method, act_bits=act_bits, **NT_KW)
    jout, _, jstats = jpipe.tweak_layers(JCFG, setup["specs"],
                                         _jax(setup["blocks"]),
                                         jnp.asarray(setup["x0"]), jnt)
    tout, _, tstats = tpipe.tweak_layers(
        TCFG, [_to_port(b) for b in setup["blocks"]],
        torch.from_numpy(setup["x0"]), tnt)
    assert tstats["layer_lr"] == jstats["layer_lr"]
    deltas = []
    for li, (j0, t0, jb, tb) in enumerate(zip(jq, tq, jout, tout)):
        # only the norm params change, in the port as in the reference
        for path in ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wi",
                     "mlp/wg", "mlp/wo"):
            w0, w1 = tree_get(t0, path)["w"], tree_get(tb, path)["w"]
            assert isinstance(w1, QuantizedTensor)
            assert w1.act_bits == act_bits
            assert torch.equal(w0.qw, w1.qw) and torch.equal(w0.scale,
                                                            w1.scale)
        for norm in ("ln1", "ln2"):
            jd = np.asarray(jb[norm]["scale"]) - j0[norm]["scale"]
            td = (tb[norm]["scale"] - t0[norm]["scale"]).numpy()
            deltas.append((td, jd, tstats["layer_lr"][li]))
            assert np.abs(jd).max() > 0.5 * deltas[-1][2]   # they moved
    return deltas, tstats, jstats


def test_tweak_matches_jax_w4a8(setup, monkeypatch):
    """W4A8: the port computes what the JAX CPU path computes (exact int8
    products, f32 rescale), so only f32 rounding separates the gradients;
    Adam's first steps move each channel by about lr * sign(grad): the
    same channels move, to 1e-3 lr."""
    deltas, tstats, jstats = _tweak_both(setup, "smoothquant", monkeypatch)
    np.testing.assert_allclose(tstats["layer_loss"], jstats["layer_loss"],
                               rtol=1e-4)
    for td, jd, lr in deltas:
        np.testing.assert_array_equal(td != 0, jd != 0)
        assert np.abs(td - jd).max() <= 1e-3 * lr


def _cpu_path_product(x, qt):
    """The JAX package's CPU product for packed linears: f32 x times the
    f32 dequantized weight, without the kernel's bf16 rounding of x."""
    return torch.matmul(x, dequantize(qt))


def test_tweak_matches_jax_w4_on_the_cpu_path_function(setup, monkeypatch):
    """W4 GPTQ with the packed product set to the JAX CPU path's function:
    the tweak itself (losses, gradients through ``_DequantMatmul``'s
    backward, Adam, chunk order) then matches to 1e-3 lr (measured
    1.2e-4 lr)."""
    monkeypatch.setattr(ops, "dequant_matmul", _cpu_path_product)
    deltas, tstats, jstats = _tweak_both(setup, "gptq", monkeypatch)
    np.testing.assert_allclose(tstats["layer_loss"], jstats["layer_loss"],
                               rtol=1e-4)
    for td, jd, lr in deltas:
        assert np.abs(td - jd).max() <= 1e-3 * lr


def test_tweak_near_jax_w4_through_the_kernel(setup, monkeypatch):
    """W4 GPTQ through the kernel's function: the dequant kernel (and its
    plain version) rounds each linear's input to bf16, the JAX CPU path
    does not, and the gradients differ by that rounding. Adam's first
    steps move each channel by about lr * sign(grad), so channels whose
    gradient is small step differently. Measured on these inputs: mean
    |port - JAX| 0.19-0.31 lr per norm, a quarter to a third of channels
    more than 0.1 lr apart, while the deltas average 1.4 lr; the bound is
    a mean of 0.5 lr, and the layers' final losses within 5%."""
    deltas, tstats, jstats = _tweak_both(setup, "gptq", monkeypatch)
    np.testing.assert_allclose(tstats["layer_loss"], jstats["layer_loss"],
                               rtol=5e-2)
    for td, jd, lr in deltas:
        assert np.abs(td - jd).mean() <= 0.5 * lr
        assert np.abs(td).mean() >= 0.5 * lr


def test_a8_gradient_pattern_matches_jax(setup):
    """On W4A8 the loss sees the norm params only through each token's
    activation scale amax/127 (the int8 codes carry no gradient): the
    gradient is nonzero exactly on each token's largest-|h| channels, the
    same in both packages."""
    qb = _quantized_blocks(setup, "smoothquant")[0]
    tq = _to_port(qb)
    x = setup["x0"][:4]
    pos = np.broadcast_to(np.arange(SEQ, dtype=np.int32), (4, SEQ))
    fout = np.asarray(japply(JCFG, setup["specs"][0],
                             _jax(setup["blocks"][0]), jnp.asarray(x),
                             positions=jnp.asarray(pos))[0])
    jn, jrest = jpartition(_jax(qb), jis_norm_path)

    def jloss(nrm):
        y = japply(JCFG, setup["specs"][0], jmerge(nrm, jrest),
                   jnp.asarray(x), positions=jnp.asarray(pos))[0]
        return jl.l_dist(jnp.asarray(fout), y)

    jg = jax.jit(jax.grad(jloss))(jn)
    tn, trest = tree_partition(tq, is_norm_path)
    tracked = tree_map(lambda t: t.detach().requires_grad_(True), tn)
    y, _ = apply_block(TCFG, tree_merge(tracked, trest),
                       torch.from_numpy(x),
                       positions=torch.from_numpy(pos.copy()))
    norms = ("ln1", "ln2")
    grads = torch.autograd.grad(tl.l_dist(torch.from_numpy(fout), y),
                                [tracked[n]["scale"] for n in norms])
    for norm, g in zip(norms, grads):
        want = np.asarray(jg[norm]["scale"])
        np.testing.assert_array_equal(g.numpy() != 0, want != 0)
        assert 0 < (want != 0).sum() <= 4 * SEQ     # argmax channels only
        # the same exact integer products; f32 sums in another order
        np.testing.assert_allclose(g.numpy(), want, rtol=1e-3,
                                   atol=1e-5 * np.abs(want).max())
