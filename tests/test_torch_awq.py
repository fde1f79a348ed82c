"""AWQ in the port against the JAX package's on the same inputs, made with
numpy from a seed: the scale search (alpha and s), ``awq_block``'s folded
float block and ``quantize_block(method="awq")``'s packed codes on TINY
(MHA), the llama3.2-1b SMOKE config (GQA: the MLA row of the smoothing
table matches through wq, so ln1 is searched and folded twice) and
Mixtral SMOKE (no ln2 row matches: router and experts keep their rows),
and the whole AWQ + NT pipeline on TINY."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.normtweak import pipeline as jpipe
from repro.core.quant import awq as jawq
from repro.core.quant import blockquant as jbq
from repro.models.blocks import apply_block as japply
from repro.models.transformer import _embed as jembed
from repro.models.transformer import block_spec as jblock_spec
from repro.models.transformer import get_block as jget
from repro.models.transformer import init_lm as jinit
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.normtweak import pipeline as tpipe
from repro_torch.core.quant import awq as tawq
from repro_torch.core.quant import blockquant as tbq
from repro_torch.core.quant import types as tt
from repro_torch.kernels import ops
from repro_torch.models.blocks import apply_block
from repro_torch.utils.tree import tree_get

MODELS = {"tiny": (jc.TINY, tc.TINY),
          "llama-smoke": (jc.get_smoke_config("llama3.2-1b"),
                          tc.get_smoke_config("llama3.2-1b")),
          "mixtral-smoke": (jc.get_smoke_config("mixtral-8x22b"),
                            tc.get_smoke_config("mixtral-8x22b"))}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: the tweak issues
    thousands of small ops (see tests/test_torch_gptq.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


def _port(tree):
    return params_from_numpy(tree, device="cpu")


@pytest.mark.parametrize("bits,group", [(4, -1), (4, 32), (3, 16), (2, 32)])
def test_awq_search_scales_matches_jax(bits, group):
    """The same alpha (a strict < over the 9 grid points on both sides)
    and the same s to 1e-6 relative (f32 powers and sums in another
    order). Activations with a few salient channels, as AWQ assumes."""
    rng = np.random.default_rng(bits * 100 + group)
    x = rng.normal(size=(3, 40, 64)).astype(np.float32)
    x[..., :4] *= 20.0
    ws = [rng.normal(size=(64, n)).astype(np.float32) * 0.1
          for n in (32, 96)]
    js, jalpha = jawq.awq_search_scales(jnp.asarray(x),
                                        [jnp.asarray(w) for w in ws],
                                        bits=bits, group_size=group)
    ts, talpha = tawq.awq_search_scales(torch.from_numpy(x),
                                        [torch.from_numpy(w) for w in ws],
                                        bits=bits, group_size=group)
    assert talpha == jalpha
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)


@pytest.fixture(scope="module")
def blocks():
    """Block 0 of each model and its calibration taps in both packages (8
    samples x 32 tokens, the launcher's calibration shape)."""
    out = {}
    for name, (jcfg, tcfg) in MODELS.items():
        jp = jinit(jcfg, jax.random.PRNGKey(0))
        tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                                   (8, 32))
        pos = np.broadcast_to(np.arange(32, dtype=np.int32), (8, 32))
        x0 = np.asarray(jembed(jcfg, jp, jnp.asarray(tokens), None,
                               jnp.asarray(pos)))
        block = _np(jget(jcfg, jp, 0))
        jtaps, ttaps = {}, {}
        japply(jcfg, jblock_spec(jcfg, 0), _jax(block), jnp.asarray(x0),
               positions=jnp.asarray(pos), taps=jtaps)
        apply_block(tcfg, _port(block), torch.from_numpy(x0),
                    positions=torch.from_numpy(pos.copy()), taps=ttaps)
        out[name] = dict(block=block, jtaps=jtaps, ttaps=ttaps)
    return out


@pytest.mark.parametrize("model", list(MODELS))
def test_awq_block_matches_jax(blocks, model):
    """The folded float block: norms divided by s and the weight rows
    scaled by it, to 1e-5 relative. On the GQA and MHA blocks ln1 is
    searched twice (its row and the MLA row through wq); on Mixtral no
    ln2 row matches, so ln2, the router and the experts stay as they
    are. (On these random SMOKE weights both packages pick alpha 0, s = 1,
    for some rows.)"""
    st = blocks[model]
    kw = dict(bits=4, group_size=32)
    want = jbq.awq_block(_jax(st["block"]), st["jtaps"], **kw)
    got = tbq.awq_block(_port(st["block"]), st["ttaps"], **kw)
    orig = _port(st["block"])
    paths = ["ln1/scale", "ln2/scale"] + [
        p + "/w" for p, _ in jbq.iter_linears(st["block"])]
    for path in paths:
        np.testing.assert_allclose(tree_get(got, path).numpy(),
                                   np.asarray(tree_get(want, path)),
                                   rtol=1e-5, atol=1e-8)
    if model == "mixtral-smoke":
        for path in ("ln2/scale", "moe/router/w", "moe/experts/wi/w",
                     "moe/experts/wg/w"):
            assert torch.equal(tree_get(got, path), tree_get(orig, path))


@pytest.mark.parametrize("model", list(MODELS))
def test_quantize_block_awq_matches_jax(blocks, model):
    """Every linear after AWQ's fold, RTN-packed through the quantize-pack
    wrapper: scales to 1e-5 relative, and at least 99.9% of the codes
    equal (a weight that the fold leaves within an f32 ulp of a rounding
    boundary may round the other way), none more than a step apart."""
    st = blocks[model]
    kw = dict(method="awq", bits=4, group_size=32)
    jq = jbq.quantize_block(_jax(st["block"]), st["jtaps"], **kw)
    tq = tbq.quantize_block(_port(st["block"]), st["ttaps"], **kw)
    for path, _ in jbq.iter_linears(st["block"]):
        jw, tw = tree_get(jq, path)["w"], tree_get(tq, path)["w"]
        if "router" in path:
            assert not isinstance(tw, tt.QuantizedTensor)
            continue
        assert isinstance(tw, tt.QuantizedTensor) and tw.act_bits == 0
        got = tt.unpack(tw.qw, 4, tw.k).numpy().astype(np.int64)
        want = tt.unpack(torch.from_numpy(np.array(jw.qw)), 4,
                         tw.k).numpy().astype(np.int64)
        diff = np.abs(got - want)
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, path
        np.testing.assert_allclose(tw.scale.numpy(), np.asarray(jw.scale),
                                   rtol=1e-5)


def test_awq_pipeline_matches_jax(monkeypatch):
    """AWQ W4 g64 + NT on TINY (2 layers, 8 x 32 calibration, the
    launcher's NT settings) through both ``tweak_layers``, each on its own
    quantized stream: per layer the packed codes (>= 99.9% equal, none
    more than a step apart), and with the packed product set to the JAX
    CPU path's function (f32 x times the f32 dequantized weight; the JAX
    package cannot differentiate its kernel) the tweaked norms within
    1e-2 lr and the final losses within 1e-3 (a flipped code moves the
    stream the tweak sees)."""
    jcfg, tcfg = jc.TINY.replace(n_repeats=2), tc.TINY.replace(n_repeats=2)
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (8, 32))
    pos = jnp.broadcast_to(jnp.arange(32, dtype=jnp.int32)[None], (8, 32))
    x0 = np.asarray(jembed(jcfg, jp, jnp.asarray(tokens), None, pos))
    blocks = [_np(jget(jcfg, jp, i)) for i in range(2)]
    nt = dict(method="awq", lr0=1e-3, iters=1, sample_batch=4, bits=4,
              group_size=64)
    jout, _, jstats = jpipe.tweak_layers(
        jcfg, [jblock_spec(jcfg, i) for i in range(2)], _jax(blocks),
        jnp.asarray(x0), jpipe.NTConfig(**nt))
    monkeypatch.setattr(ops, "dequant_matmul",
                        lambda x, qt: torch.matmul(x, tt.dequantize(qt)))
    tout, _, tstats = tpipe.tweak_layers(
        tcfg, [_port(b) for b in blocks], torch.from_numpy(x0.copy()),
        tpipe.NTConfig(**nt))
    assert tstats["layer_lr"] == jstats["layer_lr"]
    np.testing.assert_allclose(tstats["layer_loss"], jstats["layer_loss"],
                               rtol=1e-3)
    for jb, tb, lr in zip(jout, tout, tstats["layer_lr"]):
        for path, _ in jbq.iter_linears(blocks[0]):
            jw, tw = tree_get(jb, path)["w"], tree_get(tb, path)["w"]
            got = tt.unpack(tw.qw, 4, tw.k).numpy().astype(np.int64)
            want = tt.unpack(torch.from_numpy(np.array(jw.qw)), 4,
                             tw.k).numpy().astype(np.int64)
            diff = np.abs(got - want)
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.999, path
        for norm in ("ln1", "ln2"):
            np.testing.assert_allclose(tb[norm]["scale"].numpy(),
                                       np.asarray(jb[norm]["scale"]),
                                       rtol=0, atol=1e-2 * lr)
