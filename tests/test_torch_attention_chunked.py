"""The port's chunked online-softmax attention core against the JAX package's ``attention_core`` on the same seeded inputs (forward and
gradient), and the norm-tweaking pipeline on TINY with ``attn_block_kv``
16 and 40-token calibration samples, so every block apply and every tweak
step runs the chunked core (three KV blocks, the last one padded), held
against the JAX pipeline to the bars of tests/test_torch_normtweak.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.normtweak import pipeline as jpipe
from repro.models.attention import attention_core as jcore
from repro.models.transformer import _embed as jembed
from repro.models.transformer import block_spec as jblock_spec
from repro.models.transformer import get_block as jget
from repro.models.transformer import init_lm as jinit
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.normtweak import pipeline as tpipe
from repro_torch.core.quant.types import dequantize
from repro_torch.kernels import ops
from repro_torch.models.attention import attention_core

BLOCK_KV = 16
JCFG = jc.TINY.replace(n_repeats=2, attn_block_kv=BLOCK_KV)
TCFG = tc.TINY.replace(n_repeats=2, attn_block_kv=BLOCK_KV)
N_SAMPLES, SEQ = 8, 40
NT_KW = dict(lr0=1e-3, iters=1, sample_batch=4, bits=4, group_size=64)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs: GPTQ's row loop and the
    tweak issue thousands of small ops (see tests/test_torch_gptq.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case(b, sq, skv, h, kvh, hd, seed, pad):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, sq, h, hd)).astype(np.float32)
    k = rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)
    v = rng.normal(size=(b, skv, kvh, hd)).astype(np.float32)
    kv_pos = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    if pad:
        kv_pos[1, :pad] = -1                  # a left-padded row
    q_pos = kv_pos[:, skv - sq:].copy()
    return q, k, v, q_pos, kv_pos


# (sq, skv, window, pad): self-attention over 40 tokens (3 KV blocks of
# 16, the last padded with dead slots), sliding windows (whole KV blocks
# masked for late queries), left padding (query rows with no live key),
# the last 24 queries of 40 keys (a chunked suffix), an odd length, a
# decode query over a 40-slot cache (single-shot past one block) and K
# of one block (single-shot)
CASES = [(40, 40, None, 0), (40, 40, 12, 0), (40, 40, None, 5),
         (40, 40, 12, 21), (40, 40, 8, 0), (40, 40, 8, 5),
         (24, 40, None, 0), (24, 40, 12, 3), (33, 33, 5, 0),
         (1, 40, None, 3), (1, 40, 12, 0), (16, 16, None, 2)]


@pytest.mark.parametrize("sq,skv,window,pad", CASES)
@pytest.mark.parametrize("heads", [(4, 2), (4, 4)])
def test_attention_core_matches_jax(sq, skv, window, pad, heads):
    """Forward and the gradient of sum(o * r) with respect to q, k and v:
    the same online-softmax steps in f32, summed in another order: 2e-6
    absolute on outputs of O(1) (measured 4e-7), 1e-5 of the largest
    gradient entry."""
    h, kvh = heads
    q, k, v, q_pos, kv_pos = _case(2, sq, skv, h, kvh, 16, sq + skv + pad,
                                   pad)
    r = np.random.default_rng(1).normal(size=q.shape).astype(np.float32)
    kw = dict(window=window, block_kv=BLOCK_KV)

    def jloss(qq, kk, vv):
        o = jcore(qq, kk, vv, q_pos=jnp.asarray(q_pos),
                  kv_pos=jnp.asarray(kv_pos), **kw)
        return jnp.sum(o * jnp.asarray(r)), o

    (_, jo), jg = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = attention_core(tq, tk, tv, q_pos=torch.from_numpy(q_pos),
                       kv_pos=torch.from_numpy(kv_pos), **kw)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo), rtol=0,
                               atol=2e-6)
    grads = torch.autograd.grad((o * torch.from_numpy(r)).sum(),
                                (tq, tk, tv))
    for got, want in zip(grads, jg):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())


def test_chunked_core_matches_single_shot_on_live_rows():
    """Where every query row has a live key, the chunked core computes the
    single-shot softmax: 2e-6 absolute (outputs of O(1))."""
    q, k, v, q_pos, kv_pos = _case(2, 40, 40, 4, 2, 16, 3, 0)
    args = [torch.from_numpy(a) for a in (q, k, v)]
    pos = dict(q_pos=torch.from_numpy(q_pos), kv_pos=torch.from_numpy(kv_pos))
    for window in (None, 12):
        one = attention_core(*args, window=window, block_kv=64, **pos)
        chunked = attention_core(*args, window=window, block_kv=BLOCK_KV,
                                 **pos)
        assert float((one - chunked).abs().max()) <= 2e-6


def test_chunked_core_backward_recomputes_scores():
    """Under autograd each KV block is checkpointed: the saved tensors of
    the graph are the carries and inputs, never a block's (B, KVH, G, Sq,
    block_kv) scores."""
    q, k, v, q_pos, kv_pos = _case(1, 40, 40, 4, 2, 8, 5, 0)
    tq = torch.from_numpy(q).requires_grad_(True)
    shapes = []

    def pack(t):
        shapes.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        o = attention_core(tq, torch.from_numpy(k), torch.from_numpy(v),
                           q_pos=torch.from_numpy(q_pos),
                           kv_pos=torch.from_numpy(kv_pos),
                           block_kv=BLOCK_KV)
    scores = (1, 2, 2, 40, BLOCK_KV)
    assert shapes and scores not in shapes
    o.sum().backward()
    assert tq.grad is not None and torch.isfinite(tq.grad).all()


# ------------------------------------------- the pipeline at attn_block_kv 16

def _np(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _jax(tree):
    return jax.tree_util.tree_map(jnp.array, tree)


@pytest.fixture(scope="module")
def setup():
    jp = jinit(JCFG, jax.random.PRNGKey(0))
    tokens = np.random.default_rng(2).integers(0, JCFG.vocab_size,
                                               (N_SAMPLES, SEQ))
    pos = jnp.broadcast_to(jnp.arange(SEQ, dtype=jnp.int32)[None],
                           (N_SAMPLES, SEQ))
    x0 = np.asarray(jembed(JCFG, jp, jnp.asarray(tokens), None, pos))
    nl = JCFG.n_layers
    blocks = [_np(jget(JCFG, jp, i)) for i in range(nl)]
    specs = [jblock_spec(JCFG, i) for i in range(nl)]
    # the JAX package's GPTQ blocks along its own quantized stream
    nt = jpipe.NTConfig(method="gptq", tweak=False, **NT_KW)
    qblocks, _, _ = jpipe.tweak_layers(JCFG, specs, _jax(blocks),
                                       jnp.asarray(x0), nt)
    return dict(x0=x0, blocks=blocks, specs=specs,
                quantized=[_np(b) for b in qblocks])


def _tweak_both(setup, monkeypatch):
    """Both pipelines tweak the JAX package's quantized blocks (handed out
    in layer order in place of ``quantize_block``, so GPTQ code flips do
    not mask the tweak); the port applies its blocks two samples at a time
    (APPLY_TOKENS 80), so the chunked full-batch applies and the joined
    taps run too. Returns per layer and norm (port delta, JAX delta, lr),
    both stats and both final quantized streams."""
    jq = setup["quantized"]
    tq = [params_from_numpy(b, device="cpu") for b in jq]
    jit, tit = iter(_jax(jq)), iter(tq)
    monkeypatch.setattr(jpipe, "quantize_block", lambda *a, **k: next(jit))
    monkeypatch.setattr(tpipe, "quantize_block", lambda *a, **k: next(tit))
    monkeypatch.setattr(tpipe, "APPLY_TOKENS", 2 * SEQ)
    jout, jqx, jstats = jpipe.tweak_layers(
        JCFG, setup["specs"], _jax(setup["blocks"]),
        jnp.asarray(setup["x0"]), jpipe.NTConfig(method="gptq", **NT_KW))
    tout, tqx, tstats = tpipe.tweak_layers(
        TCFG, [params_from_numpy(b, device="cpu") for b in setup["blocks"]],
        torch.from_numpy(setup["x0"].copy()),
        tpipe.NTConfig(method="gptq", **NT_KW))
    assert tstats["layer_lr"] == jstats["layer_lr"]
    deltas = []
    for li, (j0, t0, jb, tb) in enumerate(zip(jq, tq, jout, tout)):
        for norm in ("ln1", "ln2"):
            jd = np.asarray(jb[norm]["scale"]) - j0[norm]["scale"]
            td = (tb[norm]["scale"] - t0[norm]["scale"]).numpy()
            deltas.append((td, jd, tstats["layer_lr"][li]))
            assert np.abs(jd).max() > 0.5 * deltas[-1][2]   # they moved
    return deltas, tstats, jstats, tqx.numpy(), np.asarray(jqx)


def test_pipeline_chunked_matches_jax_on_the_cpu_path_function(setup,
                                                               monkeypatch):
    """With the packed product set to the JAX CPU path's function (f32 x
    times the f32 dequantized weight), the tweak through the chunked core
    matches the JAX pipeline to 1e-3 lr, its losses to 1e-4, and the
    final quantized stream to 1e-4 of its scale. (The JAX package cannot
    differentiate its Pallas kernel, so its tweak runs on this CPU path,
    never under REPRO_DEQUANT_IMPL=pallas.)"""
    monkeypatch.setattr(ops, "dequant_matmul",
                        lambda x, qt: torch.matmul(x, dequantize(qt)))
    deltas, tstats, jstats, tqx, jqx = _tweak_both(setup, monkeypatch)
    np.testing.assert_allclose(tstats["layer_loss"], jstats["layer_loss"],
                               rtol=1e-4)
    for td, jd, lr in deltas:
        assert np.abs(td - jd).max() <= 1e-3 * lr
    np.testing.assert_allclose(tqx, jqx, rtol=0,
                               atol=1e-4 * np.abs(jqx).max())


def test_pipeline_chunked_near_jax_through_the_kernel(setup, monkeypatch):
    """Through the dequant kernel's function (bf16-rounded inputs, the
    port's everywhere): the bars of tests/test_torch_normtweak.py's kernel
    test, mean |port - JAX| within 0.5 lr, the deltas at least 0.5 lr on
    average, the layers' final losses within 5%."""
    deltas, tstats, jstats, _, _ = _tweak_both(setup, monkeypatch)
    np.testing.assert_allclose(tstats["layer_loss"], jstats["layer_loss"],
                               rtol=5e-2)
    for td, jd, lr in deltas:
        assert np.abs(td - jd).mean() <= 0.5 * lr
        assert np.abs(td).mean() >= 0.5 * lr


def test_chunked_apply_joins_taps_like_one_apply(setup, monkeypatch):
    """The full-batch apply in chunks of two samples gives the whole
    batch's taps (wq, wk and wv's shared input joined once) and output,
    within f32 rounding of one apply."""
    seen = []

    def capture(bp, taps, **kw):
        seen.append(dict(taps))
        return bp

    block = params_from_numpy(setup["blocks"][0], device="cpu")
    x0 = torch.from_numpy(setup["x0"].copy())
    nt = tpipe.NTConfig(method="rtn", tweak=False)
    monkeypatch.setattr(tpipe, "quantize_block", capture)
    _, one, _ = tpipe.tweak_layers(TCFG, [block], x0, nt)
    monkeypatch.setattr(tpipe, "APPLY_TOKENS", 2 * SEQ)
    _, chunked, _ = tpipe.tweak_layers(TCFG, [block], x0, nt)
    whole, parts = seen
    assert sorted(whole) == sorted(parts)
    assert parts["attn/wq"] is parts["attn/wk"] is parts["attn/wv"]
    for key in whole:
        assert parts[key].shape == whole[key].shape
        np.testing.assert_allclose(parts[key].numpy(), whole[key].numpy(),
                                   rtol=0, atol=1e-5)
    np.testing.assert_allclose(chunked.numpy(), one.numpy(), rtol=0,
                               atol=1e-5)
