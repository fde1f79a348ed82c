"""Preemption with KV spill and restore on the port, against the JAX engine:
tests/test_overload.py's token-identity zoo (a batch request preempted
mid-decode by an interactive one, at a mid-page and at a page-boundary
depth) on the dense, GQA and sliding-window models here, the int8-KV,
GQA+SWA+int8 and W4 g32 ones in tests/test_torch_preempt_zoo_int8.py.
Each case: the victim's and the preemptor's greedy tokens equal the
port's unpreempted runs and the JAX engine's, the event logs, stats and
spilled / restored page counts equal the JAX engine's, and the spilled
payload equals the JAX engine's (f32 within 1e-5, int8 codes exactly).
Also a preemption in the middle of a chunked prefill, which resumes
without prefilling a token twice."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.models.transformer import init_lm as jinit
from repro.serve.engine import ContinuousEngine as JaxEngine
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.serve.engine import ContinuousEngine

# tests/test_overload.py's CFG in both packages
SHRINK = dict(n_repeats=2, d_model=64, head_dim=16, d_ff=128)
JCFG = jc.TINY.replace(**SHRINK)
TCFG = tc.TINY.replace(**SHRINK)
# tests/test_overload.py's _preempt_engine geometry
GEOM = dict(n_slots=1, max_len=40, page_size=8, prefill_bucket=8,
            decode_block=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the engine's small ops stall on thread-pool
    barriers when several test processes share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def both_params(variant):
    """(JAX cfg, port cfg, JAX params, the port's copy of them)."""
    jcfg, tcfg = JCFG.replace(**variant), TCFG.replace(**variant)
    p = jinit(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, p, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


def probe_spills(eng):
    """Record each spill snapshot the engine's preempt hook returns."""
    snaps, orig = [], eng.sched.preempt_hook

    def hook(slot, req, now):
        snap = orig(slot, req, now)
        snaps.append(snap)
        return snap
    eng.sched.preempt_hook = hook
    return snaps


def pool_leaves(host, key=None):
    """(pool leaf name, array) of a spill payload; the JAX cache nests a
    block's pools one level deeper ("attn"), so leaves go by name."""
    if isinstance(host, dict):
        for k in sorted(host):
            yield from pool_leaves(host[k], k)
    elif host is not None:
        yield key, np.asarray(host)


def assert_payloads_equal(tsnaps, jsnaps):
    """The port's spilled pages equal the JAX engine's: f32 leaves within
    1e-5, int8 codes exactly (the JAX payload is padded to a power of two
    of pages with the scratch page; its first len(copied) pages count)."""
    assert len(tsnaps) == len(jsnaps)
    for ts, js in zip(tsnaps, jsnaps):
        assert (ts.kept, ts.copied, ts.n_live) == (js.kept, js.copied,
                                                   js.n_live)
        tl, jl = dict(pool_leaves(ts.host)), dict(pool_leaves(js.host))
        assert tl.keys() == jl.keys() and tl
        n = len(ts.copied)
        for key, t in tl.items():
            j = jl[key][:, :n]
            assert t.shape == j.shape and t.dtype == j.dtype, key
            if t.dtype == np.int8:
                np.testing.assert_array_equal(t, j, err_msg=key)
            else:
                np.testing.assert_allclose(t, j, rtol=0, atol=1e-5,
                                           err_msg=key)


def preempt_case(variant, quant=None, monkeypatch=None):
    """tests/test_overload.py's preempt token-identity case on both
    engines: the interactive arrival at t 4 (mid-page) and t 8 (the
    victim's fill on a page boundary)."""
    jcfg, tcfg, jp, tp = both_params(variant)
    kw = dict(GEOM)
    if quant:
        kw.update(quant_bits=quant[0], quant_group=quant[1])
        # the JAX engine's packed linears on the kernel path (interpret
        # mode): bf16 operands, as in the port
        monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    rng = np.random.default_rng(11)
    batch_p = rng.integers(0, jcfg.vocab_size, 8)    # exactly one page
    inter_p = rng.integers(0, jcfg.vocab_size, 8)
    solo = {}
    for tag, p, mn in (("batch", batch_p, 20), ("inter", inter_p, 4)):
        eng = ContinuousEngine(tcfg, tp, preempt=True, device="cpu", **kw)
        r = eng.submit(p, max_new=mn)
        eng.run(max_steps=500)
        solo[tag] = r.tokens
    boundary = []
    for arrival in (4.0, 8.0):
        out, spills = [], []
        for eng in (JaxEngine(jcfg, jp, preempt=True, **kw),
                    ContinuousEngine(tcfg, tp, preempt=True, device="cpu",
                                     **kw)):
            spills.append(probe_spills(eng))
            victim = eng.submit(batch_p, max_new=20, arrival=0.0, priority=1)
            inter = eng.submit(inter_p, max_new=4, arrival=arrival,
                               priority=0)
            eng.run(max_steps=500)
            eng.pool.check_invariants()
            assert np.all(eng.pool.tables == -1)
            out.append((victim.tokens, inter.tokens, victim.n_preempts,
                        list(eng.sched.events), eng.sched.stats(),
                        eng.n_spilled_pages, eng.n_restored_pages,
                        eng.n_prefill_tokens))
        assert out[1] == out[0], arrival
        v_toks, i_toks, n_pre, _, _, n_spilled, n_restored, _ = out[1]
        assert n_pre == 1 and n_spilled > 0 and n_restored == n_spilled
        assert v_toks == solo["batch"] and i_toks == solo["inter"]
        assert_payloads_equal(spills[1], spills[0])
        boundary += [s.n_live % 8 == 0 for s in spills[1]]
    assert any(boundary)


@pytest.mark.parametrize("name,variant", [
    ("dense", {}),
    ("gqa", {"n_kv_heads": 2}),
    ("swa", {"attn_window": 12}),
])
def test_preempt_restore_matches_jax(name, variant):
    preempt_case(variant)


def test_preempt_mid_prefill_matches_jax():
    """A victim evicted between chunks of its chunked prefill resumes at its
    old progress: 24 + 8 prompt tokens prefilled in all (nothing twice),
    tokens equal to its unpreempted run and to the JAX engine's."""
    jcfg, tcfg, jp, tp = both_params({})
    rng = np.random.default_rng(5)
    long_p = rng.integers(0, jcfg.vocab_size, 24)    # 3 chunks of 8
    inter_p = rng.integers(0, jcfg.vocab_size, 8)
    base_eng = ContinuousEngine(tcfg, tp, chunked_prefill=8, device="cpu",
                                **GEOM)
    base = base_eng.submit(long_p, max_new=6)
    base_eng.run(max_steps=500)
    out = []
    for eng in (JaxEngine(jcfg, jp, preempt=True, chunked_prefill=8,
                          **GEOM),
                ContinuousEngine(tcfg, tp, preempt=True, chunked_prefill=8,
                                 device="cpu", **GEOM)):
        victim = eng.submit(long_p, max_new=6, arrival=0.0, priority=1)
        inter = eng.submit(inter_p, max_new=4, arrival=1.0, priority=0)
        eng.run(max_steps=500)
        eng.pool.check_invariants()
        out.append((victim.tokens, inter.tokens, victim.n_preempts,
                    victim.prefill_done, eng.n_prefill_tokens,
                    list(eng.sched.events), eng.sched.stats()))
    assert out[1] == out[0]
    assert out[1][0] == base.tokens
    assert out[1][2:5] == (1, False, 32)


def test_preempt_refuses_spec_decode():
    _, tcfg, _, tp = both_params({})
    with pytest.raises(NotImplementedError, match="spec_decode"):
        ContinuousEngine(tcfg, tp, n_slots=2, max_len=64, page_size=8,
                         preempt=True, spec_decode=True, device="cpu")
