"""Whisper's encoder-decoder in the port against the JAX package on its
SMOKE config (2 + 2 layers, d 64, LayerNorm, GELU, learned decoder
positions, an encoder of seeded frame embeddings): the sinusoidal table,
the non-causal attention core, ``encode``, ``encdec_forward``, prefill and
decode against the forward, the cross caches, the loss and one train
step, the deploy's bytes, the packed forward, greedy tokens, ``convert``
of an ``init_encdec`` tree, and the refusals of a paged cross cache.

The JAX package inits every LayerNorm bias at zero and every scale at one,
so the shared params set them from a numpy seed (biases N(0, 0.02^2),
scales 1 + N(0, 0.02^2)): a port that dropped one would differ."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.quant.deploy import quantize_params_for_serving as jquant
from repro.models import encdec as jed
from repro.models.attention import attention_core as jcore
from repro.models.rope import sinusoidal_positions as jsinus
from repro.optim import schedules as jsched
from repro.train.train_step import init_opt_state as jinit_opt
from repro.train.train_step import make_train_step as jmake_step
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.core.quant.deploy import quantize_params_for_serving
from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.launch import serve as launcher
from repro_torch.models import encdec as ted
from repro_torch.models.attention import attention_core
from repro_torch.models.rope import sinusoidal_positions
from repro_torch.models.transformer import init_cache
from repro_torch.optim import schedules
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.kvcache import PageSpec
from repro_torch.train.train_step import (_grads_of, init_opt_state,
                                          make_train_step)
from repro_torch.utils.tree import tree_map
from test_torch_train import _assert_step_matches, _flat

TCFG = tc.get_smoke_config("whisper-medium")
JCFG = jc.get_smoke_config("whisper-medium")
B, S_ENC, S_DEC = 2, 12, 10
# f32 on both sides, sums in other orders (tests/test_models_consistency.py's
# bar)
ATOL = 2e-4


def perturbed_encdec_numpy(jcfg, seed: int = 0) -> dict:
    """JAX ``init_encdec`` params as numpy, every norm "bias" drawn from
    N(0, 0.02^2) and every norm "scale" from 1 + N(0, 0.02^2)."""
    tree = jax.tree_util.tree_map(np.asarray,
                                  jed.init_encdec(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def draw(path, x):
        key = path[-1].key
        if key in ("b", "bias"):
            return (0.02 * rng.normal(size=x.shape)).astype(np.float32)
        if key == "scale":
            return (1.0 + 0.02 * rng.normal(size=x.shape)).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(draw, tree)


def to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def frames_and_tokens(seed: int = 1, b: int = B, s_enc: int = S_ENC,
                      s_dec: int = S_DEC):
    rng = np.random.default_rng(seed)
    frames = (0.3 * rng.normal(size=(b, s_enc, JCFG.d_model))).astype(
        np.float32)
    return frames, rng.integers(0, JCFG.vocab_size, (b, s_dec)).astype(
        np.int32)


@pytest.fixture(scope="module")
def tree():
    return perturbed_encdec_numpy(JCFG)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("s,d", [(12, 64), (1500, 1024), (7, 6)])
def test_sinusoidal_positions_match_jax(s, d):
    got = sinusoidal_positions(s, d).numpy()
    want = np.asarray(jsinus(s, d))
    # the same f32 angles (up to 1500 rad: ~1e-4 absolute per ulp of an
    # angle, and exp's last ulp in the frequencies)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4 if s > 100
                               else 2e-6)


@pytest.mark.parametrize("skv,block_kv", [(24, 512), (40, 16)])
def test_attention_core_non_causal_matches_jax(skv, block_kv):
    """Single-shot and chunked (KV blocks of 16 over 40 keys) with dead
    keys at position -1: every query attends every live key."""
    rng = np.random.default_rng(2)
    q = rng.normal(size=(2, 5, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5)).copy()
    kv_pos = np.broadcast_to(np.arange(skv, dtype=np.int32), (2, skv)).copy()
    kv_pos[1, -3:] = -1
    want = np.asarray(jcore(*map(jnp.asarray, (q, k, v)),
                            q_pos=jnp.asarray(q_pos),
                            kv_pos=jnp.asarray(kv_pos), causal=False,
                            block_kv=block_kv))
    got = attention_core(*map(torch.from_numpy, (q, k, v)),
                         q_pos=torch.from_numpy(q_pos),
                         kv_pos=torch.from_numpy(kv_pos), causal=False,
                         block_kv=block_kv).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    causal = attention_core(*map(torch.from_numpy, (q, k, v)),
                            q_pos=torch.from_numpy(q_pos),
                            kv_pos=torch.from_numpy(kv_pos),
                            block_kv=block_kv).numpy()
    assert not np.allclose(causal, got)


def test_encode_matches_jax(tree):
    frames, _ = frames_and_tokens()
    want = np.asarray(jed.encode(JCFG, to_jax(tree), jnp.asarray(frames)))
    got = ted.encode(TCFG, params_from_numpy(tree, device="cpu"),
                     torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_encdec_forward_matches_jax(tree):
    frames, tokens = frames_and_tokens()
    want = np.asarray(jed.encdec_forward(JCFG, to_jax(tree),
                                         jnp.asarray(frames),
                                         jnp.asarray(tokens))[0])
    got = ted.encdec_forward(TCFG, params_from_numpy(tree, device="cpu"),
                             torch.from_numpy(frames),
                             torch.from_numpy(tokens))[0].numpy()
    assert got.shape == (B, S_DEC, JCFG.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def test_prefill_then_decode_match_forward_and_cross_cache(tree):
    """A 6-token prompt through ``encdec_prefill`` and the other 4 tokens
    through ``encdec_decode`` steps, each at the JAX forward's logits of
    the same position; the cross caches equal the JAX prefill's (the
    encoder output's K/V and its positions) and the decode steps leave
    them as they were."""
    frames, tokens = frames_and_tokens()
    want = np.asarray(jed.encdec_forward(JCFG, to_jax(tree),
                                         jnp.asarray(frames),
                                         jnp.asarray(tokens))[0])
    p = params_from_numpy(tree, device="cpu")
    cache = ted.encdec_init_cache(TCFG, B, S_DEC, S_ENC, device="cpu")
    n0 = 6
    logits = ted.encdec_prefill(TCFG, p, torch.from_numpy(frames),
                                torch.from_numpy(tokens[:, :n0]), cache)
    np.testing.assert_allclose(logits.numpy(), want[:, n0 - 1], rtol=0,
                               atol=ATOL)
    jcache = jed.encdec_init_cache(JCFG, B, S_DEC, S_ENC)
    _, jcache = jed.encdec_prefill(JCFG, to_jax(tree), jnp.asarray(frames),
                                   jnp.asarray(tokens[:, :n0]), jcache)
    cross = cache["stack"]["p0"]["xattn"]
    assert sorted(cross) == ["k", "pos", "v"]
    for key in ("k", "v"):
        np.testing.assert_allclose(
            cross[key].numpy(),
            np.asarray(jcache["stack"]["p0"]["xattn"][key]), rtol=0,
            atol=1e-5)
    np.testing.assert_array_equal(
        cross["pos"].numpy(), np.asarray(jcache["stack"]["p0"]["xattn"]["pos"]))
    filled = {k: t.clone() for k, t in cross.items()}
    for t in range(n0, S_DEC):
        pos = torch.full((B, 1), t, dtype=torch.int32)
        logits = ted.encdec_decode(TCFG, p, torch.from_numpy(
            tokens[:, t:t + 1]), cache, pos)
        np.testing.assert_allclose(logits.numpy(), want[:, t], rtol=0,
                                   atol=ATOL)
    for k, t in filled.items():
        assert torch.equal(cross[k], t)


def _batch(seed=3):
    frames, tokens = frames_and_tokens(seed, s_dec=S_DEC + 1)
    return {"frames": frames, "tokens": tokens[:, :-1],
            "labels": tokens[:, 1:]}


def test_encdec_loss_matches_jax(tree):
    batch = _batch()
    batch["mask"] = (np.arange(S_DEC)[None] < np.array([[S_DEC], [7]])
                     ).astype(np.float32)
    want, jm = jed.encdec_loss(JCFG, to_jax(tree),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    got, tm = ted.encdec_loss(TCFG, params_from_numpy(tree, device="cpu"),
                              {k: torch.from_numpy(v)
                               for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]), rtol=1e-6)


def test_train_step_with_encdec_loss_matches_jax(tree):
    """One step of ``make_train_step(loss_fn=encdec_loss)`` on a batch of
    float frames: loss, gradient norm, gradients, params and Adam state
    against the JAX step's (tests/test_torch_train.py's bounds)."""
    lr = 1e-3
    batch = _batch()
    jp = to_jax(tree)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    jstep = jmake_step(JCFG, lr_schedule=jsched.constant(lr),
                       loss_fn=jed.encdec_loss, donate=False)
    jnew, jstate, jm = jstep(jp, jinit_opt(JCFG, jp), jb, jnp.asarray(0),
                             jax.random.PRNGKey(0))
    tp = params_from_numpy(tree, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    tstep = make_train_step(TCFG, lr_schedule=schedules.constant(lr),
                            loss_fn=ted.encdec_loss)
    tnew, tstate, tm = tstep(tp, init_opt_state(TCFG, tp), tb, 0)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-5)
    jgrads = jax.grad(lambda p: jed.encdec_loss(JCFG, p, jb)[0])(jp)
    _, _, tgrads = _grads_of(TCFG, ted.encdec_loss,
                             params_from_numpy(tree, device="cpu"), tb)
    want, got = _flat(jgrads), _flat(tree_map(lambda x: x.numpy(), tgrads))
    assert want.keys() == got.keys()
    for k in want:
        assert np.abs(got[k] - want[k]).max() <= \
            1e-5 * np.abs(want[k]).max() + 1e-30, k
    _assert_step_matches(tnew, tstate, jnew, jstate,
                         jax.tree_util.tree_map(np.asarray, jgrads), lr)


def _packed_pair(tree, act_bits=0):
    """The JAX deploy's W4 g32 tree, as JAX arrays and as the port's."""
    jq = jquant(JCFG, to_jax(tree), bits=4, group_size=32, act_bits=act_bits)
    return jq, params_from_numpy(jax.tree_util.tree_map(np.asarray, jq),
                                 device="cpu")


@pytest.mark.parametrize("act_bits", [0, 8])
def test_deploy_bytes_match_jax(tree, act_bits):
    """``quantize_params_for_serving`` over the whole {"enc", "dec"} tree:
    every linear of both stacks packed (the decoder's cross-attention
    included) byte for byte as the JAX deploy packs it; the decoder's
    token and position tables and its head stay float."""
    _, want = _packed_pair(tree, act_bits)
    got = quantize_params_for_serving(TCFG, params_from_numpy(
        tree, device="cpu"), bits=4, group_size=32, act_bits=act_bits,
        device="cpu")
    packed = []

    def walk(a, b, path=""):
        if isinstance(b, QuantizedTensor):
            assert isinstance(a, QuantizedTensor), path
            assert torch.equal(a.qw, b.qw) and torch.equal(a.scale, b.scale)
            assert a.act_bits == b.act_bits == act_bits
            packed.append(path)
        elif isinstance(b, dict):
            assert a.keys() == b.keys(), path
            for k in b:
                walk(a[k], b[k], f"{path}/{k}")
        else:
            assert torch.equal(a, b), path

    walk(got, want)
    lins = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wi", "mlp/wo")
    assert sorted(packed) == sorted(
        [f"/enc/stack/p0/{p}/w" for p in lins]
        + [f"/dec/stack/p0/{p}/w" for p in lins]
        + [f"/dec/stack/p0/xattn/{p}/w" for p in ("wq", "wk", "wv", "wo")])


def test_packed_forward_matches_jax(tree, monkeypatch):
    """W4 g32 packed by the JAX deploy, carried across, against the JAX
    forward on its kernel path (Pallas interpret: bf16 operands, f32 sums,
    the function the port's kernel and plain version compute)."""
    jq, tq = _packed_pair(tree)
    monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    frames, tokens = frames_and_tokens()
    want = np.asarray(jed.encdec_forward(JCFG, jq, jnp.asarray(frames),
                                         jnp.asarray(tokens))[0])
    got = ted.encdec_forward(TCFG, tq, torch.from_numpy(frames),
                             torch.from_numpy(tokens))[0].numpy()
    # packed linears round their inputs to bf16 on both sides; a last-ulp
    # f32 difference can flip one rounding and cascade
    # (tests/test_torch_model.py's bound for packed logits)
    err = np.abs(got - want)
    assert err.max() <= 2e-2 and err.mean() <= 2e-3


def _greedy_jax(params, frames, prompt, steps):
    cache = jed.encdec_init_cache(JCFG, prompt.shape[0],
                                  prompt.shape[1] + steps, frames.shape[1])
    logits, cache = jed.encdec_prefill(JCFG, params, jnp.asarray(frames),
                                       jnp.asarray(prompt), cache)
    out = []
    for t in range(steps):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)[:, None]
        out.append(np.asarray(tok)[:, 0])
        pos = jnp.full((prompt.shape[0], 1), prompt.shape[1] + t, jnp.int32)
        logits, cache = jed.encdec_decode(JCFG, params, tok, cache, pos)
    return np.stack(out, 1)


def _greedy_port(params, frames, prompt, steps):
    cache = ted.encdec_init_cache(TCFG, prompt.shape[0],
                                  prompt.shape[1] + steps, frames.shape[1],
                                  device="cpu")
    logits = ted.encdec_prefill(TCFG, params, torch.from_numpy(frames),
                                torch.from_numpy(prompt), cache)
    out = []
    for t in range(steps):
        tok = logits.argmax(-1).to(torch.int32)[:, None]
        out.append(tok[:, 0].numpy())
        pos = torch.full((prompt.shape[0], 1), prompt.shape[1] + t,
                         dtype=torch.int32)
        logits = ted.encdec_decode(TCFG, params, tok, cache, pos)
    return np.stack(out, 1)


@pytest.mark.parametrize("packed", [False, True])
def test_greedy_tokens_match_jax(tree, packed, monkeypatch):
    """8 greedy steps after a 4-token prompt on 4 requests, float and W4
    g32 (JAX on its kernel path): identical tokens."""
    frames, tokens = frames_and_tokens(5, b=4)
    prompt = tokens[:, :4]
    if packed:
        jp, tp = _packed_pair(tree)
        monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    else:
        jp, tp = to_jax(tree), params_from_numpy(tree, device="cpu")
    want = _greedy_jax(jp, frames, prompt, 8)
    got = _greedy_port(tp, frames, prompt, 8)
    np.testing.assert_array_equal(got, want)


def test_convert_encdec_tree(tree):
    """An ``init_encdec`` tree, float and W4 g32 packed, to the port and
    back: the same key paths and bytes, encoder and decoder, packed leaves
    as QuantizedTensor with their stacked (L, K, N) shapes."""
    flat = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    back = params_to_numpy(params_from_numpy(tree, device="cpu"))
    flat_back = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat.keys() == flat_back.keys()
    for key, leaf in flat.items():
        np.testing.assert_array_equal(flat_back[key], leaf)
    keys = {jax.tree_util.keystr(k) for k in flat}
    assert "['dec']['stack']['p0']['lnx']['bias']" in keys
    assert "['enc']['final_norm']['scale']" in keys
    _, tq = _packed_pair(tree)
    w = tq["dec"]["stack"]["p0"]["xattn"]["wk"]["w"]
    assert isinstance(w, QuantizedTensor)
    assert w.shape == (JCFG.n_repeats, JCFG.d_model,
                       JCFG.n_kv_heads * JCFG.hd)
    again = params_from_numpy(params_to_numpy(tq), device="cpu")

    def same(a, b):
        if isinstance(b, QuantizedTensor):
            assert (a.shape, a.bits, a.group_size, a.act_bits) == \
                (b.shape, b.bits, b.group_size, b.act_bits)
            assert torch.equal(a.qw, b.qw) and torch.equal(a.scale, b.scale)
        elif isinstance(b, dict):
            assert a.keys() == b.keys()
            for k in b:
                same(a[k], b[k])
        else:
            assert torch.equal(a, b)

    same(again, tq)


def test_paged_cross_cache_and_engine_refused():
    """A page-pool cache for cross-attention layers raises with the JAX
    package's words; the continuous engine and the launcher refuse an
    enc-dec config as the JAX package's do."""
    dcfg = ted.dec_config(TCFG)
    with pytest.raises(NotImplementedError,
                       match="paged serving does not cover enc-dec "
                             "cross-attention"):
        init_cache(dcfg, PageSpec(n_pages=9, page_size=4, max_pages=4), "cpu")
    with pytest.raises(NotImplementedError,
                       match="paged serving covers decoder-only LMs"):
        ContinuousEngine(TCFG, {}, n_slots=2, device="cpu")
    with pytest.raises(SystemExit,
                       match="whisper serving demo lives in "
                             "tests/test_system.py"):
        launcher.main(["--device", "cpu", "--arch", "whisper-medium",
                       "--method", "none"])
