"""Multi-head Latent Attention and the unstacked dense first layer
(deepseek-v2-lite-16b's SMOKE config) in the port against the JAX
package: ``apply_mla`` in its non-absorbed prefill (single-shot and the
chunked core), its absorbed decode over the contiguous cache and over page
pools, the LM forward with the "prefix" block float and W4 packed, the
contiguous and paged caches through ``lm_prefill`` / ``lm_decode``,
``convert`` there and back with the prefix subtree, and MLA's pools under
``kv_cache_bits=8``. Weights come from the JAX package's ``init_lm`` with
every norm scale (the latent "kvnorm" included) drawn from a numpy seed
(``perturbed_numpy``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant.deploy import quantize_params_for_serving as jquant
from repro.models import mla as jmla
from repro.models.linear import materialize as jmaterialize
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import init_lm as jinit
from repro.models.transformer import lm_decode as _jdecode
from repro.models.transformer import lm_forward as _jforward
from repro.models.transformer import lm_prefill as _jprefill
from repro.serve.kvcache import PageSpec as JPageSpec
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.core.quant.types import QuantizedTensor, dequantize
from repro_torch.kernels import ops
from repro_torch.models import mla
from repro_torch.models.linear import materialize
from repro_torch.models.transformer import (get_block, init_cache,
                                            init_contiguous_cache, init_lm,
                                            lm_decode, lm_forward,
                                            lm_prefill, num_blocks)
from repro_torch.serve.kvcache import PageSpec
from repro_torch.utils.tree import tree_index
from test_torch_dense_variants import (jitted, perturbed_numpy, smoke_pair,
                                      to_jax)

jprefill, jdecode = jitted(_jprefill), jitted(_jdecode)
jforward = jitted(_jforward)

ARCH = "deepseek-v2-lite-16b"
TCFG, JCFG = smoke_pair(ARCH)
# f32 on both sides, sums in another order (tests/test_torch_dense_
# variants.py's bounds): the attention block's output, and logits
ATOL_BLOCK = 2e-5
ATOL_LOGITS = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the engine's decode loop issues many small ops,
    which several test processes' thread pools would contend for (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return perturbed_numpy(JCFG)


def _attn_params(tree):
    """The prefix block's MLA params, numpy."""
    return tree["prefix"]["0"]["attn"]


def _x(b, s, seed=0):
    return np.random.default_rng(seed).normal(
        size=(b, s, JCFG.d_model)).astype(np.float32)


def _pos(b, s, start=0):
    return np.broadcast_to(np.arange(start, start + s, dtype=np.int32),
                           (b, s)).copy()


def test_init_lm_has_the_jax_layout():
    """The port's own init: the prefix block (MLA with its kvnorm, a dense
    MLP of d_ff) and the stacked MoE repeats, every leaf at the JAX
    package's shape; kvnorm starts at one."""
    tp = init_lm(TCFG, seed=0, device="cpu")
    jshapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jinit(JCFG, jax.random.PRNGKey(0)))
    tshapes = jax.tree_util.tree_map(
        lambda t: tuple(t.shape), params_to_numpy(tp))
    assert tshapes == jshapes
    assert torch.all(tp["prefix"]["0"]["attn"]["kvnorm"]["scale"] == 1)
    assert num_blocks(TCFG) == JCFG.n_layers == 3
    assert "mlp" in get_block(TCFG, tp, 0) and "moe" in get_block(TCFG, tp, 1)


@pytest.mark.parametrize("block_kv", [512, 8])
def test_apply_mla_prefill_matches_jax(tree, block_kv):
    """The non-absorbed form over the sequence, with every tap: K/V
    materialized per head through wukv, qk width nope + rope = 24 and v
    width 16, single-shot (the whole sequence in one KV block) and
    through the chunked online softmax (block_kv 8 < 21 tokens)."""
    tcfg = TCFG.replace(attn_block_kv=block_kv)
    jcfg = JCFG.replace(attn_block_kv=block_kv)
    p = _attn_params(tree)
    x, pos = _x(2, 21), _pos(2, 21)
    jtaps, ttaps = {}, {}
    want, _ = jmla.apply_mla(jcfg, to_jax(p), jnp.asarray(x),
                             positions=jnp.asarray(pos), taps=jtaps)
    got = mla.apply_mla(tcfg, params_from_numpy(p, device="cpu"),
                        torch.from_numpy(x), positions=torch.from_numpy(pos),
                        taps=ttaps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)
    assert sorted(ttaps) == sorted(jtaps) == ["wdkv", "wo", "wq", "wukv"]
    for key in jtaps:
        np.testing.assert_allclose(ttaps[key].numpy(),
                                   np.asarray(jtaps[key]), rtol=0,
                                   atol=ATOL_BLOCK)


def test_apply_mla_contiguous_decode_matches_jax(tree):
    """A 9-token prefill into the contiguous latent cache, then absorbed
    decode steps: outputs, c_kv, k_pe, positions and fill counts."""
    p = _attn_params(tree)
    b, s, steps = 2, 9, 4
    x = _x(b, s + steps, seed=1)
    jc = jmla.init_mla_cache(JCFG, b, s + steps)
    tc_ = mla.init_mla_cache(TCFG, b, s + steps, "cpu", n_layers=1)
    tcache = tree_index(tc_, 0)
    tp = params_from_numpy(p, device="cpu")
    want, jc = jmla.apply_mla(JCFG, to_jax(p), jnp.asarray(x[:, :s]),
                              positions=jnp.asarray(_pos(b, s)), cache=jc)
    got = mla.apply_mla(TCFG, tp, torch.from_numpy(x[:, :s]),
                        positions=torch.from_numpy(_pos(b, s)),
                        cache=tcache)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_BLOCK)
    for t in range(s, s + steps):
        want, jc = jmla.apply_mla(JCFG, to_jax(p), jnp.asarray(x[:, t:t + 1]),
                                  positions=jnp.asarray(_pos(b, 1, t)),
                                  cache=jc, decode=True)
        got = mla.apply_mla(TCFG, tp, torch.from_numpy(x[:, t:t + 1]),
                            positions=torch.from_numpy(_pos(b, 1, t)),
                            cache=tcache, decode=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL_BLOCK)
    for key in ("k", "v", "pos", "len"):
        np.testing.assert_allclose(tcache[key].numpy(), np.asarray(jc[key]),
                                   rtol=0, atol=ATOL_BLOCK)


def test_apply_mla_paged_prefill_and_decode_match_jax(tree):
    """Left-padded prompts scattered into page pools (pads on the scratch
    page), then absorbed decode steps over the gathered pages, one slot
    idle (kv_len 0) on the last step: outputs of the live rows and every
    pool byte."""
    p = _attn_params(tree)
    tp = params_from_numpy(p, device="cpu")
    b, s, pad, ps = 2, 11, 5, 4
    x = _x(b, pad + s + 3, seed=2)
    jc = jmla.init_paged_mla_cache(JCFG, JPageSpec(n_pages=9, page_size=ps,
                                                   max_pages=4))
    tcache = tree_index(mla.init_paged_mla_cache(
        TCFG, PageSpec(n_pages=9, page_size=ps, max_pages=4), "cpu", 1), 0)
    bt = np.array([[1, 2, 3, 4], [5, 6, 7, 8]], np.int32)
    pos = np.concatenate([np.full((b, pad), -1, np.int32), _pos(b, s)], 1)
    want, jc = jmla.apply_mla(JCFG, to_jax(p), jnp.asarray(x[:, :pad + s]),
                              positions=jnp.asarray(pos), cache=jc,
                              paged={"bt_rows": jnp.asarray(bt)})
    got = mla.apply_mla(TCFG, tp, torch.from_numpy(x[:, :pad + s]),
                        positions=torch.from_numpy(pos), cache=tcache,
                        paged={"bt_rows": torch.from_numpy(bt)})
    np.testing.assert_allclose(got.numpy()[:, pad:],
                               np.asarray(want)[:, pad:], rtol=0,
                               atol=ATOL_BLOCK)
    for i, t in enumerate(range(s, s + 3)):
        live = np.array([True, i < 2])
        clen = np.full(b, t, np.int32)
        paged = dict(block_table=bt,
                     write_page=np.where(live, bt[:, t // ps], 0),
                     write_off=np.where(live, clen % ps, 0),
                     kv_len=np.where(live, clen + 1, 0).astype(np.int32))
        xt, pt = x[:, pad + t:pad + t + 1], np.where(live, clen, 0)[:, None]
        want, jc = jmla.apply_mla(
            JCFG, to_jax(p), jnp.asarray(xt), positions=jnp.asarray(pt),
            cache=jc, decode=True,
            paged={k: jnp.asarray(v) for k, v in paged.items()})
        got = mla.apply_mla(
            TCFG, tp, torch.from_numpy(xt), positions=torch.from_numpy(pt),
            cache=tcache, decode=True,
            paged={k: torch.from_numpy(np.asarray(v))
                   for k, v in paged.items()})
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live],
                                   rtol=0, atol=ATOL_BLOCK)
    for key in ("k_pool", "v_pool"):
        np.testing.assert_allclose(tcache[key].numpy()[1:],
                                   np.asarray(jc[key])[1:], rtol=0,
                                   atol=ATOL_BLOCK)


def test_context_prefill_refused_as_in_jax(tree):
    """A chunk that would read earlier context from the pages (a later
    chunk, a suffix after shared pages, a verify: "kv_len" beside
    "bt_rows") raises in both packages instead of attending to the chunk
    alone."""
    p = _attn_params(tree)
    x, pos = _x(1, 4), _pos(1, 4, 8)
    bt = np.array([[1, 2, 3]], np.int32)
    jc = jmla.init_paged_mla_cache(JCFG, JPageSpec(n_pages=4, page_size=4,
                                                   max_pages=3))
    with pytest.raises(NotImplementedError):
        jmla.apply_mla(JCFG, to_jax(p), jnp.asarray(x),
                       positions=jnp.asarray(pos), cache=jc,
                       paged={"bt_rows": jnp.asarray(bt),
                              "kv_len": jnp.asarray([12], jnp.int32)})
    tcache = tree_index(mla.init_paged_mla_cache(
        TCFG, PageSpec(n_pages=4, page_size=4, max_pages=3), "cpu", 1), 0)
    with pytest.raises(NotImplementedError, match="MLA"):
        mla.apply_mla(TCFG, params_from_numpy(p, device="cpu"),
                      torch.from_numpy(x), positions=torch.from_numpy(pos),
                      cache=tcache,
                      paged={"bt_rows": torch.from_numpy(bt),
                             "kv_len": torch.tensor([12], dtype=torch.int32),
                             "verify": True})


def test_lm_forward_matches_jax(tree):
    """The prefix block (MLA + dense MLP) ahead of the MoE repeats."""
    tokens = np.random.default_rng(1).integers(0, JCFG.vocab_size, (2, 24))
    want, jaux = jforward(JCFG, to_jax(tree), jnp.asarray(tokens, jnp.int32))
    got, taux = lm_forward(TCFG, params_from_numpy(tree, device="cpu"),
                           torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL_LOGITS)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)


def test_packed_w4_logits_match_jax(tree, monkeypatch):
    """W4 g32 packed by the JAX package's deploy (the prefix block's seven
    linears and each repeat's ten, routers and kvnorm float), carried
    across. With the packed products set to the JAX CPU path's function
    (f32 x times the f32 dequantized weight) the port computes the JAX
    forward to f32 rounding. Against the JAX forward on its kernel path
    (Pallas interpret mode: bf16 operands, the function of the port's
    kernel and its plain version) a last-ulp f32 difference can flip one
    bf16 rounding, and here that can flip a top-2 expert choice: layer 2's
    router has a token whose second and third expert probabilities are
    1.6e-4 apart, and a 1e-6 relative change of the embeddings moves the
    port's own logits by 0.056. So the bound is per position: at most 10%
    of the 48 positions more than 2e-2 off (measured: 2, at 0.10), and a
    mean of 2e-3 (measured 5.3e-4)."""
    jq = jquant(JCFG, to_jax(tree), bits=4, group_size=32)
    tokens = np.random.default_rng(3).integers(0, JCFG.vocab_size, (2, 24))
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq),
                           device="cpu")
    pre = tq["prefix"]["0"]
    for lin in ("wq", "wdkv", "wukv", "wo"):
        assert isinstance(pre["attn"][lin]["w"], QuantizedTensor)
    assert not isinstance(tq["stack"]["p0"]["moe"]["router"]["w"],
                          QuantizedTensor)
    want = np.asarray(jforward(JCFG, jq, jnp.asarray(tokens, jnp.int32))[0])
    with monkeypatch.context() as m:
        f32 = lambda x, qt: torch.matmul(x, dequantize(qt))  # noqa: E731
        m.setattr(ops, "dequant_matmul", f32)
        m.setattr(ops, "expert_dequant_matmul", f32)
        got = lm_forward(TCFG, tq, torch.from_numpy(tokens))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_LOGITS)
    monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    want = np.asarray(jforward(JCFG, jq, jnp.asarray(tokens, jnp.int32))[0])
    got = lm_forward(TCFG, tq, torch.from_numpy(tokens))[0].numpy()
    err = np.abs(got - want)
    assert (err.max(-1) > 2e-2).mean() <= 0.1 and err.mean() <= 2e-3


@pytest.mark.parametrize("packed", [False, True])
def test_prefill_and_decode_match_jax(tree, packed, monkeypatch):
    """``lm_prefill`` then ``lm_decode`` steps, over the contiguous cache
    (the static engine's and the calibration generator's) and over page
    pools, against the JAX package's same calls, float and W4 g32 (the
    absorbed decode dequantizes wukv in f32 on both sides). Every call's
    logits."""
    params = to_jax(tree)
    if packed:
        params = jquant(JCFG, params, bits=4, group_size=32)
        monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                           device="cpu")
    atol = 2e-2 if packed else ATOL_LOGITS
    b, s, steps, ps = 2, 13, 4, 8
    tokens = np.random.default_rng(4).integers(0, JCFG.vocab_size,
                                               (b, s + steps))
    toks = torch.from_numpy(tokens).to(torch.int32)
    # contiguous
    jc = jinit_cache(JCFG, b, s + steps)
    tc_ = init_contiguous_cache(TCFG, b, s + steps, "cpu")
    want, jc = jprefill(JCFG, params, jnp.asarray(tokens[:, :s], jnp.int32),
                        jc)
    got = lm_prefill(TCFG, tp, toks[:, :s], tc_,
                     torch.from_numpy(_pos(b, s)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)
    for t in range(s, s + steps):
        want, jc = jdecode(JCFG, params,
                           jnp.asarray(tokens[:, t:t + 1], jnp.int32), jc,
                           jnp.asarray(_pos(b, 1, t)))
        got = lm_decode(TCFG, tp, toks[:, t:t + 1], tc_,
                        torch.from_numpy(_pos(b, 1, t)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)
    # paged
    jspec = JPageSpec(n_pages=7, page_size=ps, max_pages=3)
    jc = jinit_cache(JCFG, b, 24, paged=jspec)
    tc_ = init_cache(TCFG, PageSpec(n_pages=7, page_size=ps, max_pages=3),
                     "cpu")
    bt = np.array([[1, 2, 3], [4, 5, 6]], np.int32)
    pad = 3
    first = np.concatenate([np.zeros((b, pad), np.int32),
                            tokens[:, :s].astype(np.int32)], 1)
    pos = np.concatenate([np.full((b, pad), -1, np.int32), _pos(b, s)], 1)
    want, jc = jprefill(JCFG, params, jnp.asarray(first), jc,
                        positions=jnp.asarray(pos),
                        paged={"bt_rows": jnp.asarray(bt)})
    got = lm_prefill(TCFG, tp, torch.from_numpy(first), tc_,
                     torch.from_numpy(pos), {"bt_rows": torch.from_numpy(bt)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)
    for t in range(s, s + steps):
        clen = np.full(b, t, np.int32)
        paged = dict(block_table=bt, write_page=bt[:, t // ps],
                     write_off=clen % ps, kv_len=clen + 1)
        want, jc = jdecode(JCFG, params,
                           jnp.asarray(tokens[:, t:t + 1], jnp.int32), jc,
                           jnp.asarray(clen[:, None]),
                           paged={k: jnp.asarray(v)
                                  for k, v in paged.items()})
        got = lm_decode(TCFG, tp, toks[:, t:t + 1], tc_,
                        torch.from_numpy(clen[:, None]),
                        {k: torch.from_numpy(np.asarray(v))
                         for k, v in paged.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=atol)
    # the prefix block's pools, a stack of one, hold the JAX pools' bytes
    for key in ("k_pool", "v_pool"):
        np.testing.assert_allclose(
            tc_["prefix"]["0"][key][0].numpy()[1:],
            np.asarray(jc["prefix"]["0"]["attn"][key])[1:], rtol=0,
            atol=ATOL_BLOCK if not packed else 2e-2)


def test_convert_round_trip(tree):
    """The JAX tree, float and W4 g32 packed, to the port and back: the
    prefix subtree and every MLA leaf (kvnorm included) the same bytes;
    the packed tree back in JAX gives the JAX forward's logits bit for
    bit."""
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    keys = {jax.tree_util.keystr(k) for k in flat}
    assert "['prefix']['0']['attn']['kvnorm']['scale']" in keys
    assert "['stack']['p0']['moe']['shared']['wi']['w']" in keys
    for key, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[key], leaf)

    jq = jax.tree_util.tree_map(
        np.asarray, jquant(JCFG, to_jax(tree), bits=4, group_size=32))
    tq = params_from_numpy(jq, device="cpu")
    assert tq["prefix"]["0"]["attn"]["wukv"]["w"].shape == (32, 128)
    assert tq["stack"]["p0"]["moe"]["experts"]["wo"]["w"].shape == (
        2, 8, 32, 64)
    qback = params_to_numpy(tq)
    from repro.core.quant.types import QuantizedTensor as JQT

    def to_jqt(node):
        if isinstance(node, dict) and "qw" in node:
            return JQT(jnp.asarray(node["qw"]), jnp.asarray(node["scale"]),
                       node["bits"], node["group_size"], node["shape"],
                       node["act_bits"])
        if isinstance(node, dict):
            return {k: to_jqt(v) for k, v in node.items()}
        return jnp.asarray(node)

    tokens = jnp.asarray(np.random.default_rng(5).integers(
        0, JCFG.vocab_size, (1, 12)), jnp.int32)
    np.testing.assert_array_equal(
        np.asarray(jforward(JCFG, to_jqt(qback), tokens)[0]),
        np.asarray(jforward(JCFG, to_jax(jq), tokens)[0]))


def test_materialize_matches_jax(tree):
    """``materialize``: a packed wukv dequantized in f32 (no bf16
    rounding) as the JAX package's, a float one cast."""
    w = _attn_params(tree)["wukv"]["w"]
    jq = jquant(JCFG, {"lin": {"w": jnp.asarray(w)}}, bits=4,
                group_size=32)["lin"]["w"]
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                  {"w": jq}), device="cpu")
    np.testing.assert_array_equal(
        materialize(tq["w"]).numpy(),
        np.asarray(jmaterialize(jq, jnp.float32)))
    np.testing.assert_array_equal(materialize(torch.tensor(w)).numpy(), w)


def test_int8_kv_setting_leaves_mla_pools_alone(tree):
    """``kv_cache_bits=8`` quantizes GQA pools only: MLA's pools stay f32
    latents with no scale pools, in both packages, and the logits of a
    paged prefill and decode equal those without the setting."""
    tcfg8, jcfg8 = (TCFG.replace(kv_cache_bits=8),
                    JCFG.replace(kv_cache_bits=8))
    spec = PageSpec(n_pages=5, page_size=8, max_pages=2)
    jcache = jinit_cache(jcfg8, 2, 16, paged=JPageSpec(5, 8, 2))
    for name, ref in (("8", init_cache(tcfg8, spec, "cpu")),
                      ("0", init_cache(TCFG, spec, "cpu"))):
        for sub in ("prefix", "stack"):
            for key, pools in ref[sub].items():
                jp = (jcache[sub][key]["attn"])
                assert sorted(pools) == sorted(jp) == ["k_pool", "v_pool"]
                for k, t in pools.items():
                    assert t.dtype == torch.float32, (name, sub, k)
                    lead = 1 if sub == "prefix" else TCFG.n_repeats
                    want = np.asarray(jp[k]).shape
                    assert tuple(t.shape) == (
                        want if sub == "stack" else (lead,) + want)
    tp = params_from_numpy(tree, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(6).integers(
        0, JCFG.vocab_size, (2, 9))).to(torch.int32)
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    outs = []
    for cfg in (TCFG, tcfg8):
        cache = init_cache(cfg, spec, "cpu")
        out = [lm_prefill(cfg, tp, tokens[:, :8], cache,
                          torch.from_numpy(_pos(2, 8)), {"bt_rows": bt})]
        clen = torch.full((2,), 8, dtype=torch.int32)
        out.append(lm_decode(cfg, tp, tokens[:, 8:], cache, clen[:, None],
                             {"block_table": bt, "write_page": bt[:, 1],
                              "write_off": clen % 8, "kv_len": clen + 1}))
        outs.append(out)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
