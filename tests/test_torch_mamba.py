"""The Mamba2 (SSD) block and the attention/SSM hybrid in the port against
the JAX package, at the SMOKE configs of mamba2-2.7b and
jamba-1.5-large-398b: the gated RMSNorm, the depthwise causal conv, the
chunk-parallel SSD (against JAX's and against the port's own token-by-
token recurrence, at lengths that leave every remainder mod the chunk),
``apply_mamba``'s four paths (decode, contiguous prefill, slot-prefill,
left pads) with the caches written in place, the LM forward float and W4,
prefill + decode against the forward, the paged engine cache (slot rows
beside Jamba's pools), ``convert`` both ways and the deploy's packing.
Weights come from the JAX package's ``init_lm`` with every norm scale
(gnorm included) and the mamba leaves that init leaves constant (conv_b,
dt_bias, D) drawn from a numpy seed (``perturbed_mamba_numpy``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant.deploy import quantize_params_for_serving as jquant
from repro.models import mamba2 as jm
from repro.models.norms import apply_gated_rmsnorm as jgated
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import init_lm as jinit
from repro.models.transformer import lm_decode as _jdecode
from repro.models.transformer import lm_forward as _jforward
from repro.models.transformer import lm_prefill as _jprefill
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.core.quant.blockquant import iter_linears
from repro_torch.core.quant.deploy import quantize_params_for_serving
from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.models import mamba2 as tm
from repro_torch.models.norms import apply_gated_rmsnorm
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

ARCHS = ["mamba2-2.7b", "jamba-1.5-large-398b"]
MCFG, JMCFG = smoke_pair("mamba2-2.7b")
# f32 on both sides, sums in another order: module outputs, and logits
# (tests/test_models_consistency.py's bound)
ATOL_MODULE = 1e-5
ATOL_LOGITS = 2e-4


def no_drop(cfg):
    """capacity_factor 8: no token dropped (tests/test_models_consistency.
    py's setting), so a prefill's routing equals the forward's."""
    if cfg.moe is None:
        return cfg
    return cfg.replace(moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))


def perturbed_mamba_numpy(jcfg, seed: int = 0) -> dict:
    """``perturbed_numpy``'s tree, then every mamba block's conv_b, dt_bias
    and D drawn too (N(0, 0.1^2), N(0, 0.5^2) and 1 + N(0, 0.1^2)), so
    each reaches the logits."""
    tree = perturbed_numpy(jcfg, seed)
    rng = np.random.default_rng(seed + 100)
    draws = {"conv_b": lambda s: 0.1 * rng.normal(size=s),
             "dt_bias": lambda s: 0.5 * rng.normal(size=s),
             "D": lambda s: 1.0 + 0.1 * rng.normal(size=s)}

    def draw(path, x):
        key = path[-1].key
        if len(path) > 1 and path[-2].key == "mamba" and key in draws:
            return draws[key](x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, tree)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (see tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    return {a: perturbed_mamba_numpy(smoke_pair(a)[1]) for a in ARCHS}


def _mamba_params(tree):
    """Layer 0's mamba params of mamba2 SMOKE, numpy."""
    return jax.tree_util.tree_map(lambda a: a[0], tree["stack"]["p0"]["mamba"])


def _rand(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).normal(size=shape)).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_lm_has_the_jax_layout(arch):
    """The port's own init: every leaf at the JAX package's shape (mamba
    blocks with conv, A_log, D, dt_bias and gnorm; no ln2 on mamba2's
    mlp="none" blocks); A_log, D and gnorm at JAX's init values."""
    tcfg, jcfg = smoke_pair(arch)
    tp = init_lm(tcfg, seed=0, device="cpu")
    jp = jinit(jcfg, jax.random.PRNGKey(0))
    jshapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), jp)
    tshapes = jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                     params_to_numpy(tp))
    assert tshapes == jshapes
    assert num_blocks(tcfg) == jcfg.n_layers
    blk = get_block(tcfg, tp, 0)
    assert "mamba" in blk and ("ln2" in blk) == (arch != "mamba2-2.7b")
    jb = jax.tree_util.tree_map(lambda a: np.asarray(a[0]),
                                jp["stack"]["p0"]["mamba"])
    for leaf in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(blk["mamba"][leaf].numpy(), jb[leaf],
                                   rtol=1e-6)
    assert torch.all(blk["mamba"]["gnorm"]["scale"] == 1)


def test_gated_rmsnorm_matches_jax():
    di = MCFG.mamba.d_inner(MCFG.d_model)
    x, z = _rand((2, 5, di), 0), _rand((2, 5, di), 1, 2.0)
    p = {"scale": _rand((di,), 2, 0.1) + 1.0}
    want = np.asarray(jgated(JMCFG, to_jax(p), jnp.asarray(x),
                             jnp.asarray(z)))
    got = apply_gated_rmsnorm(MCFG, {"scale": _t(p["scale"])}, _t(x), _t(z))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_MODULE)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(trees, with_state):
    """From zero padding and from a carried conv state: the output and the
    new state (the last d_conv - 1 raw rows)."""
    p = _mamba_params(trees["mamba2-2.7b"])
    _, _, _, conv_dim = tm._dims(MCFG)
    xbc = _rand((2, 7, conv_dim), 3)
    state = _rand((2, MCFG.mamba.d_conv - 1, conv_dim), 4) if with_state \
        else None
    jy, jst = jm._causal_conv(JMCFG, to_jax(p), jnp.asarray(xbc),
                              None if state is None else jnp.asarray(state))
    ty, tst = tm._causal_conv(MCFG, {k: _t(v) for k, v in p.items()
                                     if k in ("conv_w", "conv_b")},
                              _t(xbc), None if state is None else _t(state))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL_MODULE)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))


def _ssd_inputs(l, seed=5, b=2):
    m = MCFG.mamba
    h = m.n_heads(MCFG.d_model)
    x = _rand((b, l, h, m.head_dim), seed)
    dt = np.log1p(np.exp(_rand((b, l, h), seed + 1)))         # softplus
    a = -np.exp(np.log(np.linspace(1.0, 16.0, h))).astype(np.float32)
    bm = _rand((b, l, m.n_groups, m.d_state), seed + 2, 0.5)
    cm = _rand((b, l, m.n_groups, m.d_state), seed + 3, 0.5)
    return x, dt.astype(np.float32), a, bm, cm


def _recurrence(x, dt, a, bm, cm):
    """Token by token: s_t = exp(dt_t a) s_{t-1} + dt_t x_t B_t^T,
    y_t = s_t C_t (the port's decode step's algebra), from a zero state."""
    b, l, h, p = x.shape
    n = bm.shape[-1]
    rep = h // bm.shape[2]
    s = torch.zeros((b, h, p, n), dtype=torch.float64)
    ys = []
    for t in range(l):
        bt = bm[:, t].repeat_interleave(rep, dim=1)
        ct = cm[:, t].repeat_interleave(rep, dim=1)
        s = (s * torch.exp(dt[:, t] * a)[:, :, None, None]
             + torch.einsum("bh,bhp,bhn->bhpn", dt[:, t], x[:, t], bt))
        ys.append(torch.einsum("bhpn,bhn->bhp", s, ct))
    return torch.stack(ys, dim=1), s


@pytest.mark.parametrize("length", [5, 16, 19, 40])
def test_ssd_chunked_matches_jax(length):
    """One chunk shorter than the chunk, a whole chunk, a padded second
    chunk and a padded third: y and the final state."""
    args = _ssd_inputs(length)
    jy, js = jm._ssd_chunked(JMCFG, *map(jnp.asarray, args))
    ty, ts = tm._ssd_chunked(MCFG, *map(_t, args))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL_MODULE)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=ATOL_MODULE)


@pytest.mark.parametrize("length", range(17, 33))
def test_ssd_chunked_matches_recurrence(length):
    """Lengths 17-32 leave every remainder mod SMOKE's chunk of 16 (the
    zero-padded last chunk: dt 0 decays by 1, x 0 adds nothing): the
    chunk-parallel form in f32 equals the recurrence in f64 to f32's
    rounding (1e-5 relative: states reach ~5 in magnitude here)."""
    args = _ssd_inputs(length, seed=length)
    ty, ts = tm._ssd_chunked(MCFG, *map(_t, args))
    ry, rs = _recurrence(*(_t(a).to(torch.float64) for a in args))
    np.testing.assert_allclose(ty.numpy(), ry.numpy(), rtol=1e-5,
                               atol=ATOL_MODULE)
    np.testing.assert_allclose(ts.numpy(), rs.numpy(), rtol=1e-5,
                               atol=ATOL_MODULE)


def test_ssd_masks_before_exp_so_gradients_stay_finite():
    """Large dt makes the upper triangle's cs_q - cs_t large and positive:
    masking after exp would give inf * 0 = NaN in the forward or the
    backward. The gradients of x, dt, B and C are finite and equal JAX's
    to f32's rounding through the large decays (1e-3: measured 4.9e-4
    relative on one of 320 dt entries of ~10)."""
    x, dt, a, bm, cm = _ssd_inputs(20)
    dt = dt * 40.0
    w = _rand(x.shape, 9)

    def jloss(*args):
        y, s = jm._ssd_chunked(JMCFG, *args)
        return jnp.sum(y * w) + jnp.sum(s)

    jg = jax.grad(jloss, argnums=(0, 1, 3, 4))(*map(jnp.asarray,
                                                    (x, dt, a, bm, cm)))
    ts = [_t(v).requires_grad_(i != 2) for i, v in
          enumerate((x, dt, a, bm, cm))]
    y, s = tm._ssd_chunked(MCFG, *ts)
    (torch.sum(y * _t(w)) + torch.sum(s)).backward()
    for tg, want in zip([ts[i].grad for i in (0, 1, 3, 4)], jg):
        assert torch.isfinite(tg).all()
        np.testing.assert_allclose(tg.numpy(), np.asarray(want), rtol=1e-3,
                                   atol=1e-3)


def _jax_cache(cache):
    return {k: jnp.asarray(v) for k, v in cache.items()}


def _port_cache(cache):
    """A stack of one of the port's cache leaves, and its layer-0 view."""
    stacked = {k: _t(v)[None].clone() for k, v in cache.items()}
    return stacked, tree_index(stacked, 0)


def _check_cache(stacked, jnew):
    for k in ("state", "conv", "len"):
        np.testing.assert_allclose(stacked[k][0].numpy(),
                                   np.asarray(jnew[k]), rtol=0,
                                   atol=ATOL_MODULE, err_msg=k)


def _start_cache(b, seed=11):
    m = MCFG.mamba
    _, _, h, conv_dim = tm._dims(MCFG)
    return {"state": _rand((b, h, m.head_dim, m.d_state), seed, 0.3),
            "conv": _rand((b, m.d_conv - 1, conv_dim), seed + 1),
            "len": np.array([5, 9, 2, 7][:b], np.int32)}


@pytest.mark.parametrize("path", ["forward", "decode", "prefill",
                                  "slot_prefill", "left_pad"])
def test_apply_mamba_paths_match_jax(trees, path):
    """Each path's output within 1e-5 of JAX's, and the cache it leaves
    (state, conv, len) written through the layer's view into the stacked
    leaf: decode steps every row and shifts the conv by the raw xBC;
    contiguous prefill continues the conv and replaces the state;
    slot-prefill writes rows (3, 1) of a 4-row cache fresh, with len the
    real token count, and leaves rows 0 and 2; left pads are zeroed."""
    p = _mamba_params(trees["mamba2-2.7b"])
    tp = {k: v for k, v in params_from_numpy(p, device="cpu").items()}
    l = 1 if path == "decode" else 21
    b = 2
    u = _rand((b, l, MCFG.d_model), 13)
    pos = np.broadcast_to(np.arange(l, dtype=np.int32), (b, l)).copy()
    if path == "left_pad":
        pos[0, :4] = -1
        pos[0, 4:] = np.arange(l - 4)
    kw, tkw = {}, {}
    cache = None
    if path == "decode":
        cache = _start_cache(b)
        kw, tkw = dict(decode=True), dict(decode=True)
    elif path in ("prefill", "left_pad"):
        cache = _start_cache(b)
        kw = tkw = {}
    elif path == "slot_prefill":
        cache = _start_cache(4)
        pos[1, :6] = -1
        pos[1, 6:] = np.arange(l - 6)
        kw = dict(slot=jnp.asarray([3, 1], jnp.int32))
        tkw = dict(slots=torch.tensor([3, 1], dtype=torch.int32))
    jy, jnew = jm.apply_mamba(
        JMCFG, to_jax(p), jnp.asarray(u), positions=jnp.asarray(pos),
        cache=None if cache is None else _jax_cache(cache), **kw)
    stacked, view = (_port_cache(cache) if cache is not None
                     else (None, None))
    ty = tm.apply_mamba(MCFG, tp, _t(u), positions=_t(pos), cache=view,
                        **tkw)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL_MODULE)
    if cache is not None:
        _check_cache(stacked, jnew)
    if path == "slot_prefill":
        for row in (0, 2):
            np.testing.assert_array_equal(stacked["state"][0, row].numpy(),
                                          cache["state"][row])
        assert stacked["len"][0].tolist() == [5, 15, 2, 21]


def test_left_padded_prompt_gives_the_unpadded_state(trees):
    """A slot-prefill of a prompt left-padded by 5 leaves the same state,
    conv tail and len as the unpadded prompt, and the same last output."""
    p = params_from_numpy(_mamba_params(trees["mamba2-2.7b"]), device="cpu")
    u = _t(_rand((1, 11, MCFG.d_model), 17))
    pads = _t(_rand((1, 5, MCFG.d_model), 18, 3.0))
    outs, caches = [], []
    for x, pos in ((u, torch.arange(11, dtype=torch.int32)[None]),
                   (torch.cat([pads, u], dim=1),
                    torch.cat([torch.full((1, 5), -1, dtype=torch.int32),
                               torch.arange(11, dtype=torch.int32)[None]],
                              dim=1))):
        stacked, view = _port_cache(_start_cache(2))
        outs.append(tm.apply_mamba(MCFG, p, x, positions=pos, cache=view,
                                   slots=torch.tensor([1]))[:, -1])
        caches.append(stacked)
    np.testing.assert_allclose(outs[0].numpy(), outs[1].numpy(), rtol=0,
                               atol=ATOL_MODULE)
    for k in ("state", "conv", "len"):
        np.testing.assert_allclose(caches[0][k][0, 1].numpy(),
                                   caches[1][k][0, 1].numpy(), rtol=0,
                                   atol=ATOL_MODULE)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_jax(arch, trees):
    tcfg, jcfg = smoke_pair(arch)
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))
    want = np.asarray(jforward(jcfg, to_jax(trees[arch]),
                               jnp.asarray(tokens, jnp.int32))[0])
    got = lm_forward(tcfg, params_from_numpy(trees[arch], device="cpu"),
                     torch.from_numpy(tokens))[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch, trees):
    """tests/test_models_consistency.py's case in the port (capacity 8, a
    prefill of 23 tokens into a contiguous cache, one decode step): both
    within 2e-4 of the port's forward and of JAX's prefill and decode;
    then a contiguous-cache decode from position 0 (the calibration
    generator's) at every position."""
    tcfg, jcfg = no_drop(smoke_pair(arch)[0]), no_drop(smoke_pair(arch)[1])
    b, s = 2, 24
    tokens = np.random.default_rng(2).integers(0, jcfg.vocab_size, (b, s))
    params = params_from_numpy(trees[arch], device="cpu")
    toks = torch.from_numpy(tokens).to(torch.int32)
    logits, _ = lm_forward(tcfg, params, toks)
    cache = init_contiguous_cache(tcfg, b, 64, "cpu")
    pos = torch.arange(s - 1, dtype=torch.int32).expand(b, -1)
    pre = lm_prefill(tcfg, params, toks[:, :s - 1], cache, pos)
    dec = lm_decode(tcfg, params, toks[:, s - 1:], cache,
                    torch.full((b, 1), s - 1, dtype=torch.int32))
    np.testing.assert_allclose(pre.numpy(), logits[:, s - 2].numpy(),
                               rtol=0, atol=ATOL_LOGITS)
    np.testing.assert_allclose(dec.numpy(), logits[:, s - 1].numpy(),
                               rtol=0, atol=ATOL_LOGITS)
    jp = to_jax(trees[arch])
    jcache = jinit_cache(jcfg, b, 64)
    jpre, jcache = jprefill(jcfg, jp, jnp.asarray(tokens[:, :s - 1],
                                                   jnp.int32), jcache)
    jdec, _ = jdecode(jcfg, jp, jnp.asarray(tokens[:, s - 1:], jnp.int32),
                      jcache, jnp.full((b, 1), s - 1, jnp.int32))
    np.testing.assert_allclose(pre.numpy(), np.asarray(jpre), rtol=0,
                               atol=ATOL_LOGITS)
    np.testing.assert_allclose(dec.numpy(), np.asarray(jdec), rtol=0,
                               atol=ATOL_LOGITS)
    ccache = init_contiguous_cache(tcfg, b, s, "cpu")
    for t in range(s):
        out = lm_decode(tcfg, params, toks[:, t:t + 1], ccache,
                        torch.full((b, 1), t, dtype=torch.int32))
        np.testing.assert_allclose(out.numpy(), logits[:, t].numpy(),
                                   rtol=0, atol=ATOL_LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_cache_slot_rows_and_decode(arch, trees):
    """The engine's cache: Jamba's attention pools and every mamba layer's
    slot rows in one tree. A left-padded slot-prefill of two prompts into
    slots (2, 0) of 3, then paged decode steps over all three slots (slot
    1 idle): the active slots' logits equal the forward's."""
    tcfg = no_drop(smoke_pair(arch)[0])
    b, s, pad = 2, 14, 3
    tokens = np.random.default_rng(4).integers(0, tcfg.vocab_size, (b, s))
    params = params_from_numpy(trees[arch], device="cpu")
    toks = torch.from_numpy(tokens).to(torch.int32)
    want, _ = lm_forward(tcfg, params, toks)
    spec = PageSpec(n_pages=9, page_size=8, max_pages=2)
    with pytest.raises(ValueError, match="n_slots"):
        init_cache(tcfg, spec, "cpu")
    cache = init_cache(tcfg, spec, "cpu", n_slots=3)
    leaves = cache["stack"]["p0"]
    assert leaves["state"].shape[:2] == (tcfg.n_repeats, 3)
    if arch != "mamba2-2.7b":
        attn = [j for j, sp in enumerate(tcfg.pattern) if sp.kind == "attn"]
        assert "k_pool" in cache["stack"][f"p{attn[0]}"]
    bt = torch.tensor([[5, 6], [0, 0], [1, 2]], dtype=torch.int32)
    slots = torch.tensor([2, 0], dtype=torch.int32)
    first = torch.cat([torch.zeros((b, pad), dtype=torch.int32),
                       toks[:, :10]], dim=1)
    pos = torch.cat([torch.full((b, pad), -1, dtype=torch.int32),
                     torch.arange(10, dtype=torch.int32).expand(b, -1)], 1)
    got = lm_prefill(tcfg, params, first, cache, pos,
                     {"bt_rows": bt[slots.long()], "slots": slots})
    np.testing.assert_allclose(got.numpy(), want[:, 9].numpy(), rtol=0,
                               atol=ATOL_LOGITS)
    assert leaves["len"][:, [2, 0]].tolist() == [[10, 10]] * tcfg.n_repeats
    rows = torch.tensor([2, 1, 0])        # slot -> prompt row (1: idle)
    for t in range(10, s):
        act = torch.tensor([True, False, True])
        clen = torch.where(act, t, 0).to(torch.int32)
        paged = {"block_table": torch.stack([bt[0], bt[1], bt[2]]),
                 "write_page": torch.where(act, bt[torch.arange(3),
                                                   clen // 8], 0),
                 "write_off": clen % 8,
                 "kv_len": torch.where(act, clen + 1, 0)}
        tok = torch.where(act, toks[rows.clamp(max=1), t], 0)[:, None]
        out = lm_decode(tcfg, params, tok, cache, clen[:, None], paged)
        for slot, row in ((0, 1), (2, 0)):
            np.testing.assert_allclose(out[slot].numpy(),
                                       want[row, t].numpy(), rtol=0,
                                       atol=ATOL_LOGITS)


@pytest.mark.parametrize("arch", ARCHS)
def test_packed_w4_logits_match_jax(arch, trees, monkeypatch):
    """W4 g32 packed by the JAX package's deploy (conv, A_log, D, dt_bias
    and gnorm stay float), carried across, against the JAX forward on its
    kernel path (bf16 operands, as the port's kernel)."""
    tcfg, jcfg = smoke_pair(arch)
    jq = jquant(jcfg, to_jax(trees[arch]), bits=4, group_size=32)
    monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    tokens = np.random.default_rng(3).integers(0, jcfg.vocab_size, (2, 24))
    want = np.asarray(jforward(jcfg, jq, jnp.asarray(tokens, jnp.int32))[0])
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq),
                           device="cpu")
    mamba = tq["stack"]["p0"]["mamba"]
    assert isinstance(mamba["in_proj"]["w"], QuantizedTensor)
    assert isinstance(mamba["out_proj"]["w"], QuantizedTensor)
    assert isinstance(mamba["conv_w"], torch.Tensor)
    got = lm_forward(tcfg, tq, torch.from_numpy(tokens))[0].numpy()
    # bf16 rounding flips cascade (tests/test_torch_dense_variants.py's
    # bound for packed logits)
    err = np.abs(got - want)
    assert err.max() <= 2e-2 and err.mean() <= 2e-3


@pytest.mark.parametrize("arch", ARCHS)
def test_deploy_packs_the_same_bytes_and_skips_conv(arch, trees):
    """The port's deploy (kernel 6's plain version on the CPU) packs the
    stacked in_proj / out_proj to the JAX deploy's bytes; ``iter_linears``
    yields no conv (a bare tensor, not a {"w": ...} linear), and conv,
    A_log, D, dt_bias and gnorm stay float."""
    tcfg, jcfg = smoke_pair(arch)
    jq = jax.tree_util.tree_map(np.asarray, jquant(
        jcfg, to_jax(trees[arch]), bits=4, group_size=32))
    tq = quantize_params_for_serving(
        tcfg, params_from_numpy(trees[arch], device="cpu"), bits=4,
        group_size=32, device="cpu")
    paths = [p for p, _ in iter_linears(get_block(
        tcfg, params_from_numpy(trees[arch], device="cpu"), 0))]
    assert "mamba/in_proj" in paths and "mamba/out_proj" in paths
    assert not any("conv" in p for p in paths)
    for j, spec in enumerate(tcfg.pattern):
        if spec.kind != "mamba":
            continue
        tm_, jm_ = tq["stack"][f"p{j}"]["mamba"], jq["stack"][f"p{j}"]["mamba"]
        for lin in ("in_proj", "out_proj"):
            np.testing.assert_array_equal(tm_[lin]["w"].qw.numpy(),
                                          np.asarray(jm_[lin]["w"].qw))
            np.testing.assert_array_equal(tm_[lin]["w"].scale.numpy(),
                                          np.asarray(jm_[lin]["w"].scale))
        for leaf in ("conv_w", "conv_b", "A_log", "D", "dt_bias"):
            assert tm_[leaf].dtype == torch.float32
            np.testing.assert_array_equal(tm_[leaf].numpy(), jm_[leaf])


@pytest.mark.parametrize("arch", ARCHS)
def test_convert_round_trip(arch, trees):
    """The JAX tree to the port and back: every leaf the same bytes, the
    mamba leaves (f32 conv_w, conv_b, A_log, D, dt_bias, gnorm/scale)
    included."""
    tree = trees[arch]
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for key, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[key], leaf)
        assert flat_back[key].dtype == leaf.dtype
    keys = {jax.tree_util.keystr(k) for k in flat}
    for leaf in ("['conv_w']", "['conv_b']", "['A_log']", "['D']",
                 "['dt_bias']", "['gnorm']['scale']"):
        assert "['stack']['p0']['mamba']" + leaf in keys
