"""The port's checkpoint store against the JAX package's: a tree saved by
either package loads in the other, float and packed, with layer-stacked
``QuantizedTensor`` leaves as each package's pipeline and serving deploy
hold them (per-layer or full shape) and the W8A8 tag (``act_bits``)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.checkpoint.store import load_tree as jload_tree
from repro.checkpoint.store import save_tree as jsave_tree
from repro.core.normtweak.pipeline import _restack as jrestack
from repro.core.quant.deploy import quantize_params_for_serving as jquant
from repro.core.quant.types import QuantizedTensor as JQT
from repro.core.quant.types import quantize as jquantize
from repro.models.transformer import get_block as jget_block
from repro.models.transformer import init_lm as jinit
from repro.models.transformer import lm_forward as jforward
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.checkpoint.store import load_tree, save_tree
from repro_torch.core.quant.types import QuantizedTensor
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


def _pipeline_stacked(params, bits, group, act_bits):
    """Per-layer packed linears stacked as the JAX pipeline's ``_restack``
    does: each leaf's static shape stays the layer's (K, N)."""
    blocks = []
    for i in range(JCFG.n_repeats):
        bp = jget_block(JCFG, params, i)
        for sub in ("attn", "mlp"):
            bp[sub] = {name: {"w": jquantize(lin["w"], bits, group,
                                             act_bits=act_bits)}
                       for name, lin in bp[sub].items()}
        blocks.append(bp)
    return jrestack(JCFG, params, blocks)


def _trees():
    params = jinit(JCFG, jax.random.PRNGKey(0))
    return {"float": params,
            "deploy_w4g64": jquant(JCFG, params, bits=4, group_size=64),
            "deploy_w4a8": jquant(JCFG, params, bits=4, group_size=-1,
                                  act_bits=8),
            "pipeline_w2g64": _pipeline_stacked(params, 2, 64, 0),
            "pipeline_w4a8": _pipeline_stacked(params, 4, -1, 8)}


TREES = ["float", "deploy_w4g64", "deploy_w4a8", "pipeline_w2g64",
         "pipeline_w4a8"]


@pytest.fixture(scope="module")
def trees():
    out = _trees()
    assert list(out) == TREES
    return out


def _leaves(tree, prefix=""):
    """path -> numpy array or packed-field tuple, over either package's
    tree."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}{k}/"))
    elif isinstance(tree, (JQT, QuantizedTensor)):
        out[prefix[:-1]] = (np.asarray(tree.qw), np.asarray(tree.scale),
                            tree.bits, tree.group_size,
                            tuple(tree.shape)[-2:], tree.act_bits)
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _assert_same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], tuple):
            np.testing.assert_array_equal(a[k][0], b[k][0])
            np.testing.assert_array_equal(a[k][1], b[k][1])
            assert a[k][2:] == b[k][2:], k
        else:
            np.testing.assert_array_equal(a[k], b[k])


TOKENS = np.random.default_rng(4).integers(4, 256, (2, 12))


@pytest.mark.parametrize("name", TREES)
def test_jax_saved_tree_loads_in_port(name, trees, tmp_path):
    jtree = trees[name]
    jsave_tree(str(tmp_path / "ck"), jtree, {"steps": 7})
    got, extra = load_tree(str(tmp_path / "ck"), device="cpu")
    assert extra == {"steps": 7}
    _assert_same(_leaves(got), _leaves(jtree))
    # the same tree params_from_numpy makes: stacked shapes (L, K, N)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                             device="cpu")
    tok = torch.from_numpy(TOKENS)
    assert torch.equal(lm_forward(TCFG, got, tok)[0],
                       lm_forward(TCFG, want, tok)[0])
    qt = got["stack"]["p0"]["attn"]["wq"]["w"]
    if name != "float":
        assert qt.shape == (2, 192, 192)


@pytest.mark.parametrize("name", TREES)
def test_port_saved_tree_loads_in_jax(name, trees, tmp_path):
    jtree = trees[name]
    port = params_from_numpy(jax.tree_util.tree_map(np.asarray, jtree),
                             device="cpu")
    save_tree(str(tmp_path / "ck"), port, {"steps": 7})
    got, extra = jload_tree(str(tmp_path / "ck"))
    assert extra == {"steps": 7}
    _assert_same(_leaves(got), _leaves(jtree))
    if name != "float":
        # the per-layer (K, N) under the layer-stacked codes, as the JAX
        # pipeline writes it
        assert got["stack"]["p0"]["mlp"]["wo"]["w"].shape == (576, 192)
    if name.startswith("deploy"):
        # the JAX deploy wrote (L, K, N) here; it runs on the (K, N) too
        tok = jnp.asarray(TOKENS, jnp.int32)
        np.testing.assert_array_equal(
            np.asarray(jforward(JCFG, got, tok)[0]),
            np.asarray(jforward(JCFG, jtree, tok)[0]))


def test_port_round_trip_and_atomic_replace(trees, tmp_path):
    port = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, trees["pipeline_w4a8"]), device="cpu")
    tree = {"params": port, "opt": {"step": 3, "lr": 1e-3}}
    path = str(tmp_path / "ck")
    save_tree(path, {"stale": torch.zeros(2)})
    save_tree(path, tree, {"a": [1, 2]})
    got, extra = load_tree(path, device="cpu")
    assert extra == {"a": [1, 2]} and "stale" not in got
    assert got["opt"] == {"step": 3, "lr": 1e-3}
    _assert_same(_leaves(got["params"]), _leaves(port))
    qt = got["params"]["stack"]["p0"]["mlp"]["wi"]["w"]
    assert qt.shape == (2, 192, 576) and qt.act_bits == 8
    assert sorted(os.listdir(tmp_path)) == ["ck"]     # no temp dir left
