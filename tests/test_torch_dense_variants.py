"""The dense architecture variants — qwen2-0.5b (QKV biases), chatglm3-6b
(RoPE on half the channels) and granite-20b (LayerNorm, GELU MLP, biases
everywhere, a learned position table, MQA) — in the port against the JAX
package on their SMOKE configs: LayerNorm and the RoPE variants alone, the
LM forward float and W4 packed, paged prefill chunks and decode, the
contiguous-cache decode, and ``convert`` there and back.

The JAX package inits every bias and LayerNorm bias at zero and every norm
scale at one, so a port that dropped them would agree all the same: the
shared params (``jax_params``) set them from a numpy seed, biases to
N(0, 0.02^2) and scales to 1 + N(0, 0.02^2)."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.quant.deploy import quantize_params_for_serving as jquant
from repro.models.norms import apply_norm as japply_norm
from repro.models.rope import apply_rope as japply_rope
from repro.models.transformer import init_lm as jinit
from repro.models.transformer import lm_forward as _jforward
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.launch import serve as launcher
from repro_torch.models.norms import apply_norm, init_norm
from repro_torch.models.rope import apply_rope
from repro_torch.models.transformer import (init_cache, init_contiguous_cache,
                                            init_lm, lm_decode, lm_forward,
                                            lm_prefill)
from repro_torch.serve.kvcache import PageSpec

VARIANTS = ["qwen2-0.5b", "chatglm3-6b", "granite-20b"]


def smoke_pair(name: str):
    """(port SMOKE config, JAX SMOKE config)."""
    return tc.get_smoke_config(name), jc.get_smoke_config(name)


def perturbed_numpy(jcfg, seed: int = 0) -> dict:
    """JAX ``init_lm`` params as numpy, every linear "b" and norm "bias"
    drawn from N(0, 0.02^2) and every norm "scale" from 1 + N(0, 0.02^2)
    (numpy seed ``seed``), so each of them reaches the logits."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jinit(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = path[-1].key
        if key in ("b", "bias"):
            return (0.02 * rng.normal(size=x.shape)).astype(np.float32)
        if key == "scale":
            return (1.0 + 0.02 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, tree)


def jitted(fn):
    """``fn(cfg, *args, **kw)`` of the JAX package jitted, the config
    static and the trace keyed on REPRO_DEQUANT_IMPL too (read while it
    traces): an eager call retraces and compiles its layer scan each
    time."""
    j = jax.jit(lambda impl, cfg, *a, **kw: fn(cfg, *a, **kw),
                static_argnums=(0, 1))
    return lambda cfg, *a, **kw: j(os.environ.get("REPRO_DEQUANT_IMPL", ""),
                                   cfg, *a, **kw)


jforward = jitted(_jforward)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (GPTQ's row loop and the engine's decode loop
    issue many small ops; see tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    return {name: perturbed_numpy(smoke_pair(name)[1]) for name in VARIANTS}


def test_layernorm_matches_jax():
    tcfg, jcfg = smoke_pair("granite-20b")
    rng = np.random.default_rng(0)
    x = (3.0 * rng.normal(size=(2, 5, 96)) + 1.5).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.normal(size=96)).astype(np.float32),
         "bias": (0.1 * rng.normal(size=96)).astype(np.float32)}
    want = np.asarray(japply_norm(jcfg, to_jax(p), jnp.asarray(x)))
    got = apply_norm(tcfg, {k: torch.from_numpy(v) for k, v in p.items()},
                     torch.from_numpy(x)).numpy()
    # f32 mean and variance summed in another order
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    init = init_norm(tcfg, 96, "cpu")
    assert sorted(init) == ["bias", "scale"]
    assert torch.all(init["bias"] == 0) and torch.all(init["scale"] == 1)


@pytest.mark.parametrize("variant", ["full", "half", "none"])
def test_rope_variants_match_jax(variant):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 24)).astype(np.float32)
    pos = rng.integers(-1, 300, (2, 7)).astype(np.int32)
    want = np.asarray(japply_rope(jnp.asarray(x), jnp.asarray(pos),
                                  theta=1e4, variant=variant))
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta=1e4,
                     variant=variant).numpy()
    # the same f32 angles, cos and sin; ~1 ulp of an angle near 300 rad
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if variant == "half":
        # the second half of the channels passes through untouched, and the
        # first half's frequencies run over its own width (hd / 4 pairs)
        np.testing.assert_array_equal(got[..., 12:], x[..., 12:])
        assert not np.allclose(got[..., :12], x[..., :12])
    if variant == "none":
        np.testing.assert_array_equal(got, x)


@pytest.mark.parametrize("name", VARIANTS)
def test_lm_forward_matches_jax(name, jax_params):
    tcfg, jcfg = smoke_pair(name)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))
    want = np.asarray(jforward(jcfg, to_jax(jax_params[name]),
                               jnp.asarray(tokens, jnp.int32))[0])
    got = lm_forward(tcfg, params_from_numpy(jax_params[name], device="cpu"),
                     torch.from_numpy(tokens))[0].numpy()
    # f32 on both sides, sums in another order (tests/test_models_
    # consistency.py's bound): measured ~7e-7 on logits of max ~0.8
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


@pytest.mark.parametrize("name", VARIANTS)
def test_prefill_chunks_and_decode_match_jax_forward(name, jax_params):
    """A left-padded first chunk (pads at position -1 read the position
    table's row 0, as in JAX), a second chunk at positions 8-15 that reads
    the first through the paged multi-row read, then paged decode steps;
    and the contiguous cache (the calibration generator's) decoding every
    position from 0: each at the JAX forward's logits of the same
    position. With learned positions a wrong offset changes the logits
    of every token, not only the keys."""
    tcfg, jcfg = smoke_pair(name)
    b, s, pad = 2, 21, 3
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (b, s))
    want = np.asarray(jforward(jcfg, to_jax(jax_params[name]),
                               jnp.asarray(tokens, jnp.int32))[0])
    params = params_from_numpy(jax_params[name], device="cpu")
    toks = torch.from_numpy(tokens).to(torch.int32)
    spec = PageSpec(n_pages=9, page_size=8, max_pages=4)
    cache = init_cache(tcfg, spec, "cpu")
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    got = {}
    first = torch.cat([torch.zeros((b, pad), dtype=torch.int32),
                       toks[:, :8]], dim=1)
    pos = torch.cat([torch.full((b, pad), -1, dtype=torch.int32),
                     torch.arange(8, dtype=torch.int32).expand(b, -1)], dim=1)
    got[7] = lm_prefill(tcfg, params, first, cache, pos, {"bt_rows": bt})
    pos = torch.arange(8, 16, dtype=torch.int32).expand(b, -1)
    got[15] = lm_prefill(tcfg, params, toks[:, 8:16], cache, pos,
                         {"bt_rows": bt,
                          "kv_len": torch.full((b,), 16, dtype=torch.int32)})
    for t in range(16, s):
        clen = torch.full((b,), t, dtype=torch.int32)
        paged = {"block_table": bt, "write_page": bt[:, t // 8],
                 "write_off": clen % 8, "kv_len": clen + 1}
        got[t] = lm_decode(tcfg, params, toks[:, t:t + 1], cache,
                           clen[:, None], paged)
    ccache = init_contiguous_cache(tcfg, b, s, "cpu")
    for t in range(s):
        pos = torch.full((b, 1), t, dtype=torch.int32)
        out = lm_decode(tcfg, params, toks[:, t:t + 1], ccache, pos)
        np.testing.assert_allclose(out.numpy(), want[:, t], rtol=0,
                                   atol=2e-4)
    for t, logits in got.items():
        np.testing.assert_allclose(logits.numpy(), want[:, t], rtol=0,
                                   atol=2e-4)


@pytest.mark.parametrize("name", VARIANTS)
def test_packed_w4_logits_match_jax(name, jax_params, monkeypatch):
    """W4 g32 packed by the JAX package's deploy (biases, norms and the
    position table stay float), carried across, against the JAX forward
    on its kernel path (Pallas interpret mode: bf16 operands, f32 sums,
    the function the port's kernel and plain version compute)."""
    tcfg, jcfg = smoke_pair(name)
    jq = jquant(jcfg, to_jax(jax_params[name]), bits=4, group_size=32)
    monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24))
    want = np.asarray(jforward(jcfg, jq, jnp.asarray(tokens, jnp.int32))[0])
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq),
                           device="cpu")
    lin = tq["stack"]["p0"]["attn"]["wq"]
    assert isinstance(lin["w"], QuantizedTensor)
    assert ("b" in lin) == tcfg.qkv_bias
    got = lm_forward(tcfg, tq, torch.from_numpy(tokens))[0].numpy()
    # packed linears round their inputs to bf16 on both sides; a last-ulp
    # f32 difference can flip one rounding and cascade
    # (tests/test_torch_model.py's bound for packed logits; measured max
    # 1.8e-7 qwen2, 7.5e-6 chatglm3, 1.3e-3 granite)
    err = np.abs(got - want)
    assert err.max() <= 2e-2 and err.mean() <= 2e-3


@pytest.mark.parametrize("name", VARIANTS)
def test_convert_round_trip(name, jax_params):
    """The JAX tree, float and W4 g32 packed, to the port and back: every
    leaf the same bytes, the position table, each linear's "b" and each
    norm's "bias" included; the packed tree back in JAX gives the JAX
    forward's logits bit for bit."""
    tcfg, jcfg = smoke_pair(name)
    tree = jax_params[name]
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for key, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[key], leaf)
    keys = {jax.tree_util.keystr(k) for k in flat}
    assert ("['pos']['w']" in keys) == (tcfg.pos_emb == "learned")
    assert ("['stack']['p0']['ln1']['bias']" in keys) == (
        tcfg.norm == "layernorm")
    assert ("['stack']['p0']['attn']['wq']['b']" in keys) == tcfg.qkv_bias
    assert ("['stack']['p0']['mlp']['wo']['b']" in keys) == tcfg.mlp_bias

    jq = jax.tree_util.tree_map(
        np.asarray, jquant(jcfg, to_jax(tree), bits=4, group_size=32))
    qback = params_to_numpy(params_from_numpy(jq, device="cpu"))
    from repro.core.quant.types import QuantizedTensor as JQT

    def to_jqt(node):
        if isinstance(node, dict) and "qw" in node:
            return JQT(jnp.asarray(node["qw"]), jnp.asarray(node["scale"]),
                       node["bits"], node["group_size"], node["shape"],
                       node["act_bits"])
        if isinstance(node, dict):
            return {k: to_jqt(v) for k, v in node.items()}
        return jnp.asarray(node)

    tokens = jnp.asarray(np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (1, 12)), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(jforward(jcfg, to_jqt(qback), tokens)[0]),
        np.asarray(jforward(jcfg, to_jax(jq), tokens)[0]))


@pytest.mark.parametrize("name", VARIANTS)
def test_init_lm_has_the_variant_leaves(name):
    """The port's own init: the position table, zero biases where the
    config asks for them, no "wg" on a GELU MLP."""
    tcfg, _ = smoke_pair(name)
    p = init_lm(tcfg, seed=0, device="cpu")
    blk = p["stack"]["p0"]
    assert ("pos" in p) == (tcfg.pos_emb == "learned")
    if "pos" in p:
        assert p["pos"]["w"].shape == (tcfg.max_position, tcfg.d_model)
    assert ("wg" in blk["mlp"]) == (tcfg.act == "silu")
    for lin, on in (("wq", tcfg.qkv_bias), ("wk", tcfg.qkv_bias),
                    ("wv", tcfg.qkv_bias), ("wo", tcfg.o_bias)):
        assert ("b" in blk["attn"][lin]) == on
        if on:
            assert blk["attn"][lin]["b"].shape == (tcfg.n_repeats,
                                                   blk["attn"][lin]["w"]
                                                   .shape[-1])
            assert torch.all(blk["attn"][lin]["b"] == 0)
    assert ("b" in blk["mlp"]["wi"]) == tcfg.mlp_bias
    assert ("bias" in blk["ln1"]) == (tcfg.norm == "layernorm")


@pytest.mark.parametrize("name,method", [
    ("qwen2-0.5b", "gptq"), ("chatglm3-6b", "gptq"), ("granite-20b", "gptq"),
    ("granite-20b", "smoothquant")])
def test_launcher_runs_each_variant_on_cpu(name, method):
    """``--arch NAME --smoke --device cpu``: the pipeline packs every
    linear (granite's six, no wg), biases, norm biases and the position
    table stay float beside the packed weights, the tweak moves
    LayerNorm's bias, and the engine serves every request."""
    tcfg, _ = smoke_pair(name)
    eng, report, stats = launcher.main(
        ["--device", "cpu", "--arch", name, "--smoke", "--requests", "4",
         "--prompt-len-max", "20", "--max-new-min", "2", "--max-new-max",
         "6", "--virtual-clock", "--method", method])
    blk = eng.params["stack"]["p0"]
    act_bits = 8 if method == "smoothquant" else 0
    lins = [blk["attn"][n] for n in ("wq", "wk", "wv", "wo")] + list(
        blk["mlp"].values())
    assert len(lins) == (6 if tcfg.act == "gelu" else 7)
    for lin in lins:
        assert isinstance(lin["w"], QuantizedTensor)
        assert lin["w"].act_bits == act_bits
        for key, leaf in lin.items():
            if key != "w":
                assert key == "b" and leaf.dtype == torch.float32
    assert blk["attn"]["wq"].keys() == ({"w", "b"} if tcfg.qkv_bias
                                        else {"w"})
    if tcfg.pos_emb == "learned":
        assert eng.params["pos"]["w"].dtype == torch.float32
    if tcfg.norm == "layernorm":
        # the tweak moved β away from its seeded zero init
        assert float(blk["ln1"]["bias"].abs().max()) > 0
    assert len(stats["layer_loss"]) == 2
    assert all(np.isfinite(stats["layer_loss"]))
    done = report["requests"]
    assert len(done) == 4 and all(len(r.tokens) == r.max_new for r in done)
