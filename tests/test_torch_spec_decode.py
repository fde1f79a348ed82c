"""The port's self-speculative decoding against the JAX package: a W3
target with a W3 draft (every proposal accepted) with tokens and
``spec_stats`` equal to the JAX engine's, the drafts' packed bytes equal
to the JAX engine's ``draft_params``, the acceptance rules on random
logits (the sampled one on the JAX package's own draws, and by its
distribution), sampled serving's invariants and the refusals. The
serving zoo with W2 and W3 drafts is in tests/test_torch_spec_zoo_w2.py
and tests/test_torch_spec_zoo_w3.py, which use this file's helpers (the
JAX engine's compiles make each zoo case ~15 s on one core)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.models.transformer import init_lm as jinit
from repro.serve import sampling as jsampling
from repro.serve.engine import ContinuousEngine as JaxEngine
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.models.transformer import init_lm
from repro_torch.serve import sampling
from repro_torch.serve.engine import ContinuousEngine

# tests/test_torch_engine.py's shrunken TINY in both packages
SHRINK = dict(n_repeats=2, d_model=64, head_dim=16, d_ff=128)
JCFG = jc.TINY.replace(**SHRINK)
TCFG = tc.TINY.replace(**SHRINK)
ENGINE = dict(n_slots=3, max_len=64, page_size=8, prefill_bucket=8)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the engine's small ops stall on thread-pool
    barriers when several test processes share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reqs(rng):
    return [(rng.integers(0, JCFG.vocab_size, plen), max_new)
            for plen, max_new in [(8, 5), (13, 6), (24, 4)]]


def _drive(eng, reqs):
    for i, (prompt, max_new) in enumerate(reqs):
        eng.submit(prompt, max_new=max_new, arrival=float(i % 2))
    done = eng.run(max_steps=500)
    assert len(done) == len(reqs) and all(r.done for r in done)
    eng.pool.check_invariants()
    assert eng.pool.n_free == eng.spec.n_pages - 1
    return [list(r.tokens) for r in done]


def _both(variant, quant, engine_kw, monkeypatch):
    """(JAX engine, port engine, port params) on the same float weights,
    the JAX side's packed linears on the kernel path when quantized."""
    jcfg, tcfg = JCFG.replace(**variant), TCFG.replace(**variant)
    params = jinit(jcfg, jax.random.PRNGKey(0))
    kw = dict(ENGINE, **engine_kw)
    if quant:
        kw.update(quant_bits=quant[0], quant_group=quant[1])
    # bf16 operands on the JAX side too, as in the port's kernels and
    # their plain versions (the draft is always packed)
    monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    return (JaxEngine(jcfg, params, **kw),
            ContinuousEngine(tcfg, tparams, device="cpu", **kw), tparams,
            kw)


def _check_zoo_case(name, variant, quant, draft_bits, monkeypatch):
    """Greedy spec tokens, spec_stats and target forwards equal to the JAX
    engine's; tokens equal to the port's target-only run. Returns the
    port's spec_stats."""
    spec = dict(spec_decode=True, draft_bits=draft_bits, spec_k=4)
    jeng, teng, tparams, kw = _both(variant, quant, spec, monkeypatch)
    reqs = _reqs(np.random.default_rng(7))
    want = _drive(jeng, reqs)
    got = _drive(teng, reqs)
    assert got == want, f"{name}: tokens differ from the JAX engine"
    assert teng.spec_stats() == jeng.spec_stats()
    assert teng.n_decode_steps == jeng.n_decode_steps
    kw = {k: v for k, v in kw.items() if k not in spec}
    base = _drive(ContinuousEngine(TCFG.replace(**variant), tparams,
                                   device="cpu", **kw), reqs)
    assert got == base, f"{name}: differs from target-only decode"
    st = teng.spec_stats()
    assert st["emitted_tokens"] == sum(map(len, got)) - len(reqs)
    return st


# dense, GQA, sliding window, int8 KV and a W4 g32 target
ZOO = [("dense", {}, None), ("gqa", {"n_kv_heads": 2}, None),
       ("swa", {"attn_window": 12}, None),
       ("int8-kv", {"kv_cache_bits": 8}, None), ("w4-g32", {}, (4, 32))]


def test_spec_full_acceptance_matches_jax(monkeypatch):
    """W3 target and W3 draft: the draft proposes the target's own
    argmaxes, every proposal is accepted and a round emits several
    tokens, all as the JAX engine does."""
    st = _check_zoo_case("w3-full-accept", {}, (3, -1), 3, monkeypatch)
    assert st["acceptance_rate"] == 1.0 and st["mean_accepted_len"] > 1


@pytest.mark.parametrize("draft_bits,group", [(2, 32), (3, -1), (2, 0)])
def test_draft_bytes_match_jax(draft_bits, group, monkeypatch):
    jeng, teng, _, _ = _both({}, (4, 32) if group == 32 else None,
                             dict(spec_decode=True, draft_bits=draft_bits,
                                  quant_group=group), monkeypatch)
    jleaves = jax.tree_util.tree_leaves_with_path(
        jeng.draft_params,
        is_leaf=lambda x: hasattr(x, "qw") and hasattr(x, "bits"))
    n = 0
    for path, leaf in jleaves:
        keys = [p.key for p in path]
        tleaf = teng.draft_params
        for k in keys:
            tleaf = tleaf[k]
        if isinstance(tleaf, QuantizedTensor):
            assert tleaf.bits == leaf.bits == draft_bits
            np.testing.assert_array_equal(tleaf.qw.numpy(),
                                          np.asarray(leaf.qw))
            np.testing.assert_array_equal(tleaf.scale.numpy(),
                                          np.asarray(leaf.scale))
            n += 1
        else:
            np.testing.assert_array_equal(tleaf.numpy(), np.asarray(leaf))
    assert n == 7                  # the stacked linears of the one pattern




def test_spec_sampled_engine_invariants():
    """temperature > 0: budgets respected, pools drain, the counters add
    up (the stream matches the target's distribution, not its bits)."""
    params = init_lm(TCFG, seed=0, device="cpu")
    eng = ContinuousEngine(TCFG, params, spec_decode=True, draft_bits=2,
                           spec_k=4, temperature=0.8, top_k=20,
                           device="cpu", **ENGINE)
    reqs = _reqs(np.random.default_rng(3))
    toks = _drive(eng, reqs)
    assert [len(t) for t in toks] == [m for _, m in reqs]
    st = eng.spec_stats()
    assert st["emitted_tokens"] == sum(map(len, toks)) - len(reqs)
    assert 0.0 <= st["acceptance_rate"] <= 1.0


def test_refusals():
    params = init_lm(TCFG, seed=0, device="cpu")
    with pytest.raises(ValueError, match="draft_bits"):
        ContinuousEngine(TCFG, params, spec_decode=True, draft_bits=8,
                         device="cpu")
    with pytest.raises(ValueError, match="spec_k"):
        ContinuousEngine(TCFG, params, spec_decode=True, spec_k=0,
                         device="cpu")
    with pytest.raises(NotImplementedError, match="prefix_share"):
        ContinuousEngine(TCFG, params, spec_decode=True, prefix_share=True,
                         device="cpu")
    moe = tc.get_smoke_config("mixtral-8x22b")
    with pytest.raises(NotImplementedError, match="MoE"):
        ContinuousEngine(moe, init_lm(moe, seed=0, device="cpu"),
                         spec_decode=True, device="cpu")
    from repro_torch.core.quant.deploy import quantize_params_for_serving
    packed = quantize_params_for_serving(TCFG, params, bits=4,
                                         group_size=32, device="cpu")
    with pytest.raises(ValueError, match="float params"):
        ContinuousEngine(TCFG, packed, spec_decode=True, device="cpu")


# ------------------------------------------------------- acceptance rules

@pytest.mark.parametrize("s,m,v", [(3, 1, 8), (4, 5, 16), (8, 3, 33)])
def test_spec_accept_greedy_matches_jax(s, m, v):
    rng = np.random.default_rng(s * m)
    logits = rng.normal(size=(s, m, v)).astype(np.float32)
    t = logits.argmax(-1)
    # drafts: the argmaxes with random flips, so every run length shows
    drafts = t[:, :-1].copy()
    flip = rng.random(drafts.shape) < 0.3
    drafts[flip] = (drafts[flip] + 1) % v
    want = jsampling.spec_accept_greedy(jnp.asarray(logits),
                                        jnp.asarray(drafts, jnp.int32))
    got = sampling.spec_accept_greedy(torch.from_numpy(logits),
                                      torch.from_numpy(drafts))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))


def _jax_draws(tl, dl, key, temperature, top_k):
    """The reference's draws, rebuilt from its key as
    ``repro.serve.sampling.spec_accept_sample`` splits it."""
    s, m, _ = tl.shape
    if m == 1:
        bonus = jsampling.sample(tl[:, 0], key, temperature=temperature,
                                 top_k=top_k)
        return np.zeros((s, 0), np.float32), np.zeros((s, 0), np.int32), \
            np.asarray(bonus)
    pt = jax.nn.softmax(jsampling._filtered(tl, temperature, top_k), -1)
    pd = jax.nn.softmax(jsampling._filtered(dl, temperature, top_k), -1)
    ku, kr, kb = jax.random.split(key, 3)
    u = jax.random.uniform(ku, (s, m - 1))
    res = jnp.maximum(pt[:, :-1] - pd, 0.0)
    mass = jnp.sum(res, axis=-1, keepdims=True)
    res = jnp.where(mass > 0, res / jnp.maximum(mass, 1e-30), pt[:, :-1])
    res_tok = jax.random.categorical(kr, jnp.log(jnp.maximum(res, 1e-30)),
                                     axis=-1)
    bonus = jsampling.sample(tl[:, -1], kb, temperature=temperature,
                             top_k=top_k)
    return np.asarray(u), np.asarray(res_tok, np.int32), np.asarray(bonus)


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("m,top_k", [(1, 0), (3, 0), (5, 0), (5, 6)])
def test_spec_accept_sample_on_jax_draws(seed, m, top_k):
    """On the reference's own draws the port's rule emits the reference's
    tokens and counts. The draft logits are the target's plus noise, so
    acceptances and rejections both occur."""
    s, v, temp = 6, 12, 0.9
    rng = np.random.default_rng(seed)
    tl = rng.normal(size=(s, m, v)).astype(np.float32) * 2
    dl = (tl[:, :-1] + rng.normal(size=(s, m - 1, v)) * 1.5).astype(
        np.float32)
    drafts = np.stack([[rng.choice(v, p=np.exp(r) / np.exp(r).sum())
                        for r in row] for row in dl.astype(np.float64)
                       / temp]).reshape(s, m - 1).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    want = jsampling.spec_accept_sample(
        jnp.asarray(tl), jnp.asarray(dl), jnp.asarray(drafts), key,
        temperature=temp, top_k=top_k)
    u, res_tok, bonus = _jax_draws(jnp.asarray(tl), jnp.asarray(dl), key,
                                   temp, top_k)
    got = sampling.spec_accept_with_draws(
        torch.from_numpy(tl), torch.from_numpy(dl), torch.from_numpy(drafts),
        torch.from_numpy(u), torch.from_numpy(res_tok),
        torch.from_numpy(bonus), temperature=temp, top_k=top_k)
    assert np.array_equal(got[1].numpy(), np.asarray(want[1]))
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))


def test_spec_accept_sample_distribution():
    """The first emitted token is distributed as the target's first row
    (the residual rule is exact), whatever the draft's distribution; with
    equal distributions every draft is accepted."""
    v, n, temp = 5, 6000, 0.8
    rng = np.random.default_rng(0)
    t_row = torch.tensor(rng.normal(size=v) * 1.5, dtype=torch.float32)
    d_row = torch.tensor(rng.normal(size=v) * 1.5, dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    tl = t_row.repeat(n, 2, 1)                                # (n, 2, v)
    dl = d_row.repeat(n, 1, 1)                                # (n, 1, v)
    drafts = torch.multinomial(torch.softmax(d_row / temp, -1), n,
                               replacement=True, generator=gen)[:, None]
    out, n_emit = sampling.spec_accept_sample(tl, dl, drafts,
                                              temperature=temp,
                                              generator=gen)
    freq = torch.bincount(out[:, 0].long(), minlength=v).float() / n
    want = torch.softmax(t_row / temp, -1)
    # 6000 draws: binomial standard error <= 0.0065
    assert torch.allclose(freq, want, atol=0.03)
    assert set(n_emit.tolist()) <= {1, 2}
    same, n_same = sampling.spec_accept_sample(
        tl, tl[:, :1], drafts, temperature=temp, generator=gen)
    assert torch.all(n_same == 2)
    assert torch.equal(same[:, 0], drafts[:, 0].to(torch.int32))
