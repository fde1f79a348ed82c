"""The port's MoE against the JAX package's on the same inputs, made with
numpy from a seed: capacity, routing and the float MoE layer (capacity
binding, left-padding, shared experts), the packed expert matmuls and
their plain versions, the deploy packing of stacked experts, GPTQ of
stacked experts, SmoothQuant's MoE scaling and the norm tweak on MoE
blocks."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.normtweak import pipeline as jpipe
from repro.core.quant import blockquant as jbq
from repro.core.quant import gptq as jg
from repro.core.quant import types as jt
from repro.core.quant.deploy import quantize_params_for_serving as jdeploy
from repro.kernels import ref as jref
from repro.models import config as jmc
from repro.models import linear as jlin
from repro.models import mlp_moe as jmoe
from repro.models.transformer import _embed as jembed
from repro.models.transformer import block_spec as jblock_spec
from repro.models.transformer import get_block as jget
from repro.models.transformer import init_lm as jinit
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.normtweak import pipeline as tpipe
from repro_torch.core.quant import blockquant as tbq
from repro_torch.core.quant import gptq as tg
from repro_torch.core.quant import types as tt
from repro_torch.core.quant.deploy import quantize_params_for_serving
from repro_torch.kernels import ops, ref
from repro_torch.kernels.expert_dequant_matmul import (STAGE_K,
                                                       TARGET_BLOCKS)
from repro_torch.kernels.expert_dequant_matmul import plan as plan_expert
from repro_torch.models import config as tmc
from repro_torch.models import linear as tlin
from repro_torch.models import mlp_moe as tmoe
from repro_torch.utils.tree import tree_get

JMIX = jc.get_smoke_config("mixtral-8x22b")
TMIX = tc.get_smoke_config("mixtral-8x22b")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: GPTQ's row loop and the
    tweak issue thousands of small ops, and with several test processes on
    the machine each op's thread-pool barrier waits on descheduled
    threads (see tests/test_torch_gptq.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _to_port(tree):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                             device="cpu")


def _cfgs(**moe):
    """Mixtral SMOKE in both packages with the MoE fields replaced."""
    jm = dataclasses.replace(JMIX.moe, **moe)
    tm = dataclasses.replace(TMIX.moe, **moe)
    return JMIX.replace(moe=jm), TMIX.replace(moe=tm)


@pytest.mark.parametrize("n_tokens", [1, 8, 12, 16, 100, 256, 2048])
@pytest.mark.parametrize("factor,e,k", [(1.25, 8, 2), (1.0, 4, 2),
                                        (0.5, 4, 1)])
def test_moe_capacity_matches_jax(n_tokens, factor, e, k):
    jcfg, tcfg = _cfgs(capacity_factor=factor, n_experts=e, top_k=k)
    got = tmoe.moe_capacity(tcfg, n_tokens)
    assert got == jmoe.moe_capacity(jcfg, n_tokens)
    assert got % 8 == 0 and got >= 8


# (name, moe fields, valid pattern): the SMOKE MoE; capacity binding (a
# factor of 0.5 drops tokens); left-padding as a paged prefill pads
# (positions -1 are not valid); shared experts (DeepSeek-style)
MOE_CASES = [("smoke", {}, None), ("binding", {"capacity_factor": 0.5},
                                   None),
             ("left-pad", {}, "left"), ("left-pad-binding",
                                        {"capacity_factor": 0.5}, "left"),
             ("shared", {"n_shared": 1}, None)]


@pytest.mark.parametrize("name,moe,pad", MOE_CASES)
def test_apply_moe_float_matches_jax(name, moe, pad):
    """Outputs, aux loss and calibration taps of one float MoE layer:
    the same routing, the same dropped tokens."""
    jcfg, tcfg = _cfgs(**moe)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(3))
    tp = _to_port(jp)
    b, s, d = 3, 16, jcfg.d_model
    x = np.random.default_rng(0).normal(size=(b, s, d)).astype(np.float32)
    valid = None
    if pad == "left":
        lens = np.array([16, 9, 4])
        valid = np.arange(s)[None, :] >= (s - lens)[:, None]
    jtaps, ttaps = {}, {}
    jy, jaux = jmoe.apply_moe(jcfg, jp, jnp.asarray(x), jtaps, "moe/",
                              valid=None if valid is None
                              else jnp.asarray(valid))
    ty, taux = tmoe.apply_moe(tcfg, tp, torch.from_numpy(x), ttaps, "moe/",
                              valid=None if valid is None
                              else torch.from_numpy(valid))
    # f32 on both sides, sums in another order (~1e-7 measured)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=1e-5)
    assert sorted(ttaps) == sorted(jtaps)
    for key in jtaps:
        np.testing.assert_allclose(ttaps[key].numpy(), np.asarray(jtaps[key]),
                                   rtol=0, atol=1e-5)
    if "binding" in name:
        # the case binds: some valid token lost an expert
        buf = ttaps["moe/experts"]
        cap = tmoe.moe_capacity(tcfg, b * s)
        assert buf.shape[1] == cap
        n_valid = int(valid.sum()) if valid is not None else b * s
        assert int((buf.abs().sum(-1) > 0).sum()) < n_valid * tcfg.moe.top_k


def test_apply_moe_gradient_matches_jax():
    """The norm tweak differentiates through routing, dispatch and combine:
    the gradient of a loss on the MoE output with respect to its input."""
    jcfg, tcfg = _cfgs(capacity_factor=0.5)
    jp = jmoe.init_moe(jcfg, jax.random.PRNGKey(4))
    tp = _to_port(jp)
    x = np.random.default_rng(1).normal(size=(2, 12, 64)).astype(np.float32)
    dy = np.random.default_rng(2).normal(size=x.shape).astype(np.float32)

    def jloss(xx):
        y, aux = jmoe.apply_moe(jcfg, jp, xx)
        return jnp.sum(y * dy) + aux

    jgx = jax.grad(jloss)(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    y, aux = tmoe.apply_moe(tcfg, tp, xt)
    (tgx,) = torch.autograd.grad((y * torch.from_numpy(dy)).sum() + aux, xt)
    np.testing.assert_allclose(tgx.numpy(), np.asarray(jgx), rtol=0,
                               atol=1e-4 * np.abs(np.asarray(jgx)).max())


def _expert_inputs(e, c, k, n, bits, group, act_bits=0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(e, c, k)).astype(np.float32)
    x[:, c - 2:] = 0.0               # empty capacity rows, as in decode
    w = (rng.normal(size=(e, k, n)) / np.sqrt(k)).astype(np.float32)
    jq = jt.quantize_stacked(jnp.asarray(w), bits, group, act_bits=act_bits)
    return x, jq, params_from_numpy({"w": jq}, device="cpu")["w"]


EXPERT_QUANTS = [(bits, group) for bits in (2, 3, 4, 8)
                 for group in (-1, 32)]


@pytest.mark.parametrize("bits,group", EXPERT_QUANTS)
def test_dense_experts_packed_matches_jax_kernel(bits, group, monkeypatch):
    """Packed experts through ``dense_experts``: the port's plain version
    against the JAX package's expert kernel (Pallas, interpret mode). Both
    round x and the dequantized weight to bf16 and sum exact products in
    f32, so they differ only in summation order: 1e-5 of the largest sum
    of |terms|."""
    monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    e, c, k, n = 4, 13, 64, 96
    x, jq, tq = _expert_inputs(e, c, k, n, bits, group)
    want = np.asarray(jlin.dense_experts({"w": jq}, jnp.asarray(x)))
    got = tlin.dense_experts({"w": tq}, torch.from_numpy(x)).numpy()
    wb = tt.dequantize(tq).to(torch.bfloat16).float()
    xb = torch.from_numpy(x).to(torch.bfloat16).float()
    bound = float(torch.matmul(xb.abs(), wb.abs()).max())
    assert np.abs(got - want).max() <= 1e-5 * bound
    assert not np.any(got[:, c - 2:])          # empty rows give zeros


@pytest.mark.parametrize("bits,group", EXPERT_QUANTS)
def test_dense_experts_w8a8_matches_jax_kernel(bits, group, monkeypatch):
    """A8 experts: per-token int8 over the flattened (E*C) rows, exact
    integer group sums, f32 rescale — the port's plain version against
    the JAX package's expert W8A8 kernel in interpret mode, to f32
    rounding; empty capacity rows give zeros, not NaN."""
    monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    e, c, k, n = 4, 13, 64, 96
    x, jq, tq = _expert_inputs(e, c, k, n, bits, group, act_bits=8, seed=1)
    assert tq.act_bits == 8
    want = np.asarray(jlin.dense_experts({"w": jq}, jnp.asarray(x)))
    got = tlin.dense_experts({"w": tq}, torch.from_numpy(x)).numpy()
    assert np.all(np.isfinite(got)) and not np.any(got[:, c - 2:])
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


@pytest.mark.parametrize("bits,group", EXPERT_QUANTS)
def test_expert_refs_match_jax_oracles(bits, group):
    """The plain versions against ``repro.kernels.ref``'s expert oracles:
    the dequant one to f32 summation order, the W8A8 one exactly (exact
    integer sums, the same f32 rescale)."""
    e, c, k, n = 3, 8, 64, 40
    x, jq, tq = _expert_inputs(e, c, k, n, bits, group, seed=2)
    kw = dict(bits=bits, group_size=group, k=k)
    want = np.asarray(jref.expert_dequant_matmul_ref(
        jnp.asarray(x), jq.qw, jq.scale, **kw))
    got = ref.expert_dequant_matmul_ref(torch.from_numpy(x), tq.qw, tq.scale,
                                        **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    xq = np.random.default_rng(3).integers(-127, 128, (e, c, k)).astype(
        np.int8)
    want = np.asarray(jref.expert_w8a8_matmul_ref(
        jnp.asarray(xq), jq.qw, jq.scale, **kw))
    got = ref.expert_w8a8_matmul_ref(torch.from_numpy(xq), tq.qw, tq.scale,
                                     **kw).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits,group,act_bits", [(4, 32, 0), (3, -1, 0),
                                                 (4, -1, 8), (2, 32, 8)])
def test_deploy_packs_experts_like_jax(bits, group, act_bits):
    """Deploy packs the scan-stacked (L, E, K, N) experts to (L, E,
    packed_rows(K), N), byte for byte as the JAX package, and leaves the
    router float."""
    jp = jinit(JMIX, jax.random.PRNGKey(0))
    want = jdeploy(JMIX, jp, bits=bits, group_size=group, act_bits=act_bits)
    got = quantize_params_for_serving(TMIX, _to_port(jp), bits=bits,
                                      group_size=group, act_bits=act_bits,
                                      device="cpu")
    for name in ("wi", "wg", "wo"):
        tw = got["stack"]["p0"]["moe"]["experts"][name]["w"]
        jw = want["stack"]["p0"]["moe"]["experts"][name]["w"]
        assert isinstance(tw, tt.QuantizedTensor) and tw.act_bits == act_bits
        assert tw.qw.ndim == 4 and tw.qw.shape[:2] == (JMIX.n_repeats, 4)
        np.testing.assert_array_equal(tw.qw.numpy(), np.asarray(jw.qw))
        np.testing.assert_array_equal(tw.scale.numpy(), np.asarray(jw.scale))
        assert tw.shape == tuple(jw.shape)
    router = got["stack"]["p0"]["moe"]["router"]["w"]
    assert not isinstance(router, tt.QuantizedTensor)
    # a layer of the packed stack is a per-block expert stack
    layer = got["stack"]["p0"]["moe"]["experts"]["wi"]["w"][1]
    assert layer.shape == (4, 64, 64) and layer.qw.shape[0] == 4


def _expert_calib(e, c, k, n, seed, empty=3):
    """Correlated (E, C, K) capacity-buffer inputs with ``empty`` empty
    rows per expert, and an (E, K, N) weight."""
    rng = np.random.default_rng(seed)
    mix = rng.normal(size=(k, k)) / np.sqrt(k) + np.eye(k)
    x = (rng.normal(size=(e, c, k)) @ mix).astype(np.float32)
    x[:, c - empty:] = 0.0
    w = (rng.normal(size=(e, k, n)) / np.sqrt(k)).astype(np.float32)
    return x, w


@pytest.mark.parametrize("bits,group,actorder", [(4, -1, False),
                                                 (4, 32, True),
                                                 (3, 64, False)])
def test_gptq_of_stacked_experts_matches_jax(bits, group, actorder,
                                             monkeypatch):
    """GPTQ of a stacked (E, K, N) expert linear with per-expert Hessians
    from its (E, C, K) taps: the JAX package vmaps one f32 GPTQ per
    expert, the port runs the experts through one f64 row loop, in chunks
    under a memory budget. Codes: at least 99% equal and none more than a
    step apart (tests/test_torch_gptq.py says why not all); the chunking
    changes nothing."""
    e, c, k, n = 4, 160, 128, 48
    x, w = _expert_calib(e, c, k, n, seed=bits + group)
    h = jax.vmap(jg.hessian_from_inputs)(jnp.asarray(x))
    jq, jerr = jg.gptq_quantize(jnp.asarray(w), h, bits=bits,
                                group_size=group, actorder=actorder)
    assert tg._experts_per_chunk(e, k, n, torch.device("cpu")) == e
    tq, terr = tg.gptq_quantize_experts(
        torch.from_numpy(w), torch.from_numpy(x), bits=bits,
        group_size=group, actorder=actorder)
    assert tq.shape == (e, k, n) and tq.qw.ndim == 3
    got = tt.unpack(tq.qw, bits, k).numpy().astype(np.int64)
    want = tt.unpack(torch.from_numpy(np.array(jq.qw)), bits,
                     k).numpy().astype(np.int64)
    diff = np.abs(got - want)
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
    np.testing.assert_allclose(tq.scale.numpy(), np.asarray(jq.scale),
                               rtol=2.5e-7, atol=0)
    assert abs(float(terr) - float(jerr)) <= 0.05 * float(jerr)
    monkeypatch.setattr(tg, "_experts_per_chunk", lambda *a: 1)
    one, _ = tg.gptq_quantize_experts(
        torch.from_numpy(w), torch.from_numpy(x), bits=bits,
        group_size=group, actorder=actorder)
    assert torch.equal(one.qw, tq.qw) and torch.equal(one.scale, tq.scale)


@pytest.mark.parametrize("e", [1, 4, 8])
@pytest.mark.parametrize("c,k,n", [(8, 6144, 16384), (8, 16384, 6144),
                                   (80, 6144, 16384), (5, 64, 96)])
def test_expert_split_plan_counts_every_expert(e, c, k, n):
    """Split-K counts the blocks of all experts: at Mixtral's decode shape
    (8 experts, C = 8, 6144 x 16384) the 512 tiles of all 8 experts are
    split only as far as the grid's target needs."""
    p = plan_expert(e, c, k, n, 4, 1, x_bytes=4)
    assert p.splits >= 1 and p.k_per_split % STAGE_K == 0
    assert (p.splits - 1) * p.k_per_split < k <= p.splits * p.k_per_split
    assert p.splits <= plan_expert(1, c, k, n, 4, 1, x_bytes=4).splits
    if e == 8 and (c, k, n) == (8, 6144, 16384):
        assert p.blocks == 512 * p.splits
        assert (p.splits - 1) * 512 < TARGET_BLOCKS <= p.blocks


@pytest.fixture(scope="module")
def mix_setup():
    """Mixtral SMOKE block 0 and its calibration inputs in both packages
    (8 samples x 32 tokens, as the launcher calibrates), and the same for
    a GQA MoE with one shared expert."""
    out = {}
    for name, (jcfg, tcfg) in {"mixtral": (JMIX, TMIX),
                               "shared": _cfgs(n_shared=1)}.items():
        jp = jinit(jcfg, jax.random.PRNGKey(0))
        tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size,
                                                   (8, 32))
        pos = jnp.broadcast_to(jnp.arange(32, dtype=jnp.int32)[None], (8, 32))
        x0 = np.asarray(jembed(jcfg, jp, jnp.asarray(tokens), None, pos))
        nl = jcfg.n_layers
        out[name] = dict(
            jcfg=jcfg, tcfg=tcfg, x0=x0,
            blocks=[jax.tree_util.tree_map(np.array, jget(jcfg, jp, i))
                    for i in range(nl)],
            specs=[jblock_spec(jcfg, i) for i in range(nl)])
    return out


def _taps_both(st, block):
    from repro.models.blocks import apply_block as japply
    from repro_torch.models.blocks import apply_block

    x = st["x0"]
    pos = np.broadcast_to(np.arange(x.shape[1], dtype=np.int32), x.shape[:2])
    jtaps, ttaps = {}, {}
    japply(st["jcfg"], st["specs"][0], jax.tree_util.tree_map(jnp.array,
                                                              block),
           jnp.asarray(x), positions=jnp.asarray(pos), taps=jtaps)
    apply_block(st["tcfg"], _to_port(block), torch.from_numpy(x),
                positions=torch.from_numpy(pos.copy()), taps=ttaps)
    return jtaps, ttaps


@pytest.mark.parametrize("model", ["mixtral", "shared"])
def test_smooth_block_moe_matches_jax(mix_setup, model):
    """SmoothQuant on MoE blocks. Mixtral has no shared experts, so no row
    of the smoothing table matches ln2: ln2, the router and the routed
    experts stay as they are (the JAX package's behaviour, reproduced).
    With a shared expert the ln2 row fires: ln2 is divided by s, and the
    router's and the routed experts' wi/wg rows are scaled by it."""
    st = mix_setup[model]
    block = st["blocks"][0]
    jtaps, ttaps = _taps_both(st, block)
    want = jbq.smooth_block(jax.tree_util.tree_map(jnp.array, block), jtaps)
    got = tbq.smooth_block(_to_port(block), ttaps)
    paths = ["ln1/scale", "ln2/scale", "moe/router/w", "moe/experts/wi/w",
             "moe/experts/wg/w", "moe/experts/wo/w", "attn/wq/w"]
    if model == "shared":
        paths += ["moe/shared/wi/w", "moe/shared/wg/w"]
    for path in paths:
        np.testing.assert_allclose(tree_get(got, path).numpy(),
                                   np.asarray(tree_get(want, path)),
                                   rtol=1e-5, atol=1e-7)
    orig = _to_port(block)
    ln2_moved = not torch.equal(got["ln2"]["scale"], orig["ln2"]["scale"])
    router_moved = not torch.equal(got["moe"]["router"]["w"],
                                   orig["moe"]["router"]["w"])
    assert ln2_moved == router_moved == (model == "shared")
    assert not torch.equal(got["ln1"]["scale"], orig["ln1"]["scale"])


@pytest.mark.parametrize("method", ["gptq", "rtn", "smoothquant"])
def test_quantize_block_moe_matches_jax(mix_setup, method):
    """Every linear of a Mixtral block, experts included, quantized by
    both packages from the same taps; routers stay float."""
    st = mix_setup["mixtral"]
    block = st["blocks"][0]
    jtaps, ttaps = _taps_both(st, block)
    act_bits = 8 if method == "smoothquant" else 0
    kw = dict(method=method, bits=4, group_size=32, act_bits=act_bits)
    jq = jbq.quantize_block(jax.tree_util.tree_map(jnp.array, block), jtaps,
                            **kw)
    tq = tbq.quantize_block(_to_port(block), ttaps, **kw)
    paths = [p for p, _ in jbq.iter_linears(block) if "router" not in p]
    assert len(paths) == 7
    for path in paths:
        tw, jw = tree_get(tq, path)["w"], tree_get(jq, path)["w"]
        assert isinstance(tw, tt.QuantizedTensor) and tw.act_bits == act_bits
        assert tw.qw.shape == tuple(jw.qw.shape)
        got = tt.unpack(tw.qw, 4, tw.k).numpy().astype(np.int64)
        want = tt.unpack(torch.from_numpy(np.array(jw.qw)), 4,
                         tw.k).numpy().astype(np.int64)
        diff = np.abs(got - want)
        if method == "gptq":
            assert diff.max() <= 1 and (diff == 0).mean() >= 0.99
        else:
            assert (diff == 0).mean() >= 0.999
    assert not isinstance(tq["moe"]["router"]["w"], tt.QuantizedTensor)


def _tweak_both(st, method, monkeypatch):
    """Both packages tweak the same quantized MoE blocks (the JAX
    package's, handed out in layer order to both pipelines, as in
    tests/test_torch_normtweak.py). Returns, per layer and norm, (port
    delta, JAX delta, lr), and the two stats."""
    act_bits = 8 if method == "smoothquant" else 0
    kw = dict(lr0=1e-3, iters=1, sample_batch=4, bits=4, group_size=32,
              act_bits=act_bits)
    jnt = jpipe.NTConfig(method=method, tweak=False, **kw)
    jblocks = [jax.tree_util.tree_map(jnp.array, b) for b in st["blocks"]]
    jq, _, _ = jpipe.tweak_layers(st["jcfg"], st["specs"], jblocks,
                                  jnp.asarray(st["x0"]), jnt)
    jq = [jax.tree_util.tree_map(np.array, b) for b in jq]
    tq = [_to_port(b) for b in jq]
    jit = iter([jax.tree_util.tree_map(jnp.array, b) for b in jq])
    tit = iter(tq)
    monkeypatch.setattr(jpipe, "quantize_block", lambda *a, **k: next(jit))
    monkeypatch.setattr(tpipe, "quantize_block", lambda *a, **k: next(tit))
    jout, _, jstats = jpipe.tweak_layers(
        st["jcfg"], st["specs"],
        [jax.tree_util.tree_map(jnp.array, b) for b in st["blocks"]],
        jnp.asarray(st["x0"]), jpipe.NTConfig(method=method, **kw))
    tout, _, tstats = tpipe.tweak_layers(
        st["tcfg"], [_to_port(b) for b in st["blocks"]],
        torch.from_numpy(st["x0"]), tpipe.NTConfig(method=method, **kw))
    assert tstats["layer_lr"] == jstats["layer_lr"]
    deltas = []
    for li, (j0, t0, jb, tb) in enumerate(zip(jq, tq, jout, tout)):
        for name in ("wi", "wg", "wo"):       # only norms move
            w0 = t0["moe"]["experts"][name]["w"]
            w1 = tb["moe"]["experts"][name]["w"]
            assert w1.act_bits == act_bits and torch.equal(w0.qw, w1.qw)
        assert torch.equal(t0["moe"]["router"]["w"], tb["moe"]["router"]["w"])
        for norm in ("ln1", "ln2"):
            jd = np.asarray(jb[norm]["scale"]) - j0[norm]["scale"]
            td = (tb[norm]["scale"] - t0[norm]["scale"]).numpy()
            deltas.append((td, jd, tstats["layer_lr"][li]))
            assert np.abs(jd).max() > 0.5 * deltas[-1][2]   # they moved
    return deltas, tstats, jstats


def test_tweak_moe_matches_jax_w4a8(mix_setup, monkeypatch):
    """SmoothQuant W4A8 + NT on Mixtral SMOKE: the port computes what the
    JAX CPU path computes (exact int8 products, f32 rescale), so the same
    channels move, to 1e-3 lr, and the losses agree to 1e-4."""
    deltas, tstats, jstats = _tweak_both(mix_setup["mixtral"], "smoothquant",
                                         monkeypatch)
    np.testing.assert_allclose(tstats["layer_loss"], jstats["layer_loss"],
                               rtol=1e-4)
    for td, jd, lr in deltas:
        np.testing.assert_array_equal(td != 0, jd != 0)
        assert np.abs(td - jd).max() <= 1e-3 * lr


def test_tweak_moe_matches_jax_w4_on_the_cpu_path_function(mix_setup,
                                                           monkeypatch):
    """GPTQ W4 + NT on Mixtral SMOKE with the packed products set to the
    JAX CPU path's function (f32 x times the f32 dequantized weight, no
    bf16 rounding): the tweak through ``_DequantMatmul``'s backward (dense
    and expert-batched), routing and Adam then matches to 1e-3 lr, as the
    dense tweak does (tests/test_torch_normtweak.py)."""
    monkeypatch.setattr(ops, "dequant_matmul",
                        lambda x, qt: torch.matmul(x, tt.dequantize(qt)))
    monkeypatch.setattr(ops, "expert_dequant_matmul",
                        lambda x, qt: torch.matmul(x, tt.dequantize(qt)))
    deltas, tstats, jstats = _tweak_both(mix_setup["mixtral"], "gptq",
                                         monkeypatch)
    np.testing.assert_allclose(tstats["layer_loss"], jstats["layer_loss"],
                               rtol=1e-4)
    for td, jd, lr in deltas:
        assert np.abs(td - jd).max() <= 1e-3 * lr


def test_packed_expert_gradient_is_the_f32_product():
    """``_DequantMatmul``'s backward on an expert stack: grad @
    dequantize(W_e).T per expert, in f32 (what the JAX CPU path's einsum
    differentiates)."""
    x, _, tq = _expert_inputs(3, 8, 64, 40, 4, 32, seed=4)
    xt = torch.from_numpy(x).requires_grad_(True)
    dy = torch.from_numpy(np.random.default_rng(5).normal(
        size=(3, 8, 40)).astype(np.float32))
    (gx,) = torch.autograd.grad((tlin.dense_experts({"w": tq}, xt)
                                 * dy).sum(), xt)
    want = torch.einsum("ecn,ekn->eck", dy, tt.dequantize(tq))
    torch.testing.assert_close(gx, want, rtol=1e-6, atol=1e-6)


def test_config_refuses_what_is_not_ported():
    """MoE blocks are accepted, and the shard_map MoE since the expert-
    parallel dispatch is ported (models/moe_shardmap.py); a dispatch of
    neither name, and MoE layers without a MoEConfig, are refused."""
    TMIX.validate()
    TMIX.replace(moe_impl="shard_map").validate()
    with pytest.raises(NotImplementedError, match="moe_impl"):
        TMIX.replace(moe_impl="all_to_all").validate()
    with pytest.raises(ValueError, match="cfg.moe"):
        TMIX.replace(moe=None).validate()
    assert dataclasses.asdict(tmc.MoEConfig()) == dataclasses.asdict(
        jmc.MoEConfig())
