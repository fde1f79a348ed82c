"""Fault tolerance on the port, against the JAX engine: FaultPlan draws,
engine snapshot / restore (in memory, through the disk, across packages:
a snapshot file written by either package decodes in the other), the
fingerprint refusal, each fault kind's case of tests/test_faults.py,
deadlines, the debug check, and the seeded chaos matrix.

Greedy tokens, event logs, ``sched.stats()`` and ``fault_stats()`` equal
the JAX engine's on the same weights and plans, but for one deliberate
difference: the JAX engine answers a ``kernel_fault`` by retrying on its
gather read (``n_kernel_fallbacks``, ``paged_attn_impl``), the port has no
second read and crashes (``FaultInjected``); under ``run_resilient`` the
crash is recovered from the last snapshot. So each kernel_fault that
fired is one more crash on the port, and one fewer in
``n_faults_applied`` (the recovered history never applied it)."""
import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.checkpoint import store as jstore
from repro.models.transformer import init_lm as jinit
from repro.serve import faults as jfaults
from repro.serve import traffic as jtraffic
from repro.serve.engine import ContinuousEngine as JaxEngine
import repro_torch.configs as tc
from repro_torch.checkpoint import store as tstore
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.serve import faults as tfaults
from repro_torch.serve import traffic
from repro_torch.serve.engine import ContinuousEngine

# tests/test_faults.py's CFG and ZOO in both packages
SHRINK = dict(n_repeats=2, d_model=64, head_dim=16, d_ff=128)
JCFG = jc.TINY.replace(**SHRINK)
TCFG = tc.TINY.replace(**SHRINK)
ZOO = [("dense", {}), ("gqa", {"n_kv_heads": 2}),
       ("swa", {"attn_window": 12}), ("int8-kv", {"kv_cache_bits": 8}),
       ("gqa-swa-int8", {"n_kv_heads": 2, "attn_window": 12,
                         "kv_cache_bits": 8})]
# the JAX package's fault_stats keys the port has no counterpart of
JAX_ONLY = ("n_kernel_fallbacks", "paged_attn_impl")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the engine's small ops stall on thread-pool
    barriers when several test processes share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _params(variant):
    jcfg, tcfg = JCFG.replace(**variant), TCFG.replace(**variant)
    p = jinit(jcfg, jax.random.PRNGKey(0))
    return jcfg, tcfg, p, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, p), device="cpu")


@pytest.fixture(scope="module")
def lm():
    return _params({})


def _geom(kw):
    kw = dict(kw)
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 48)
    kw.setdefault("page_size", 8)
    kw.setdefault("prefill_bucket", 8)
    kw.setdefault("decode_block", 2)
    return kw


def _engines(lm, faults=None, debug=False, **kw):
    """tests/test_faults.py's _engine geometry in both packages: (JAX
    engine, port engine), each with its own package's FaultPlan."""
    jcfg, tcfg, jp, tp = lm
    kw = _geom(kw)
    jeng = JaxEngine(jcfg, jp, faults=_plan(jfaults, faults), **kw)
    jeng.debug = debug
    teng = ContinuousEngine(tcfg, tp, faults=_plan(tfaults, faults),
                            debug=debug, device="cpu", **kw)
    return jeng, teng


def _plan(mod, faults):
    """A list of Fault field tuples as ``mod``'s FaultPlan (None: none)."""
    if faults is None:
        return None
    return mod.FaultPlan([mod.Fault(*f) for f in faults])


def _submit_mixed(eng, vocab, *, seed=7):
    """tests/test_faults.py's four requests: a long batch victim, two
    interactive arrivals that evict it, a late batch."""
    rng = np.random.default_rng(seed)
    spec = [(16, 0.0, 1), (4, 3.0, 0), (5, 5.0, 0), (6, 7.0, 1)]
    return [eng.submit(rng.integers(0, vocab, 8), max_new=mn, arrival=t,
                       priority=p) for mn, t, p in spec]


def _tokens(done):
    return {r.rid: tuple(r.tokens) for r in done}


def _flags(done):
    return {r.rid: (r.rejected, r.shed, r.cancelled, r.error, r.n_preempts)
            for r in done}


def _step_n(eng, n):
    steps = 0
    while not eng.sched.all_done() and steps < n:
        eng.step(float(eng.t))
        eng.t += 1
        steps += 1


def _assert_drained(eng):
    eng.pool.check_invariants()
    assert np.all(eng.pool.tables == -1), "pages mapped after drain"
    held = sum(len(h[1]) for h in eng._fault_holds)
    assert eng.pool.n_free == eng.spec.n_pages - 1 - held, "leaked pages"


def _fault_view(stats, kernel_crashes=0):
    """The JAX engine's fault_stats as the port reports them: without the
    kernel-fallback keys, and with each kernel_fault that crashed the port
    taken out of n_faults_applied."""
    out = {k: v for k, v in stats.items() if k not in JAX_ONLY}
    out["n_faults_applied"] -= kernel_crashes
    return out


def _outcome(eng, done):
    return (_tokens(done), _flags(done), list(eng.sched.events),
            eng.sched.stats(), eng.n_spilled_pages, eng.n_restored_pages)


# --------------------------------------------------------- FaultPlan

@pytest.mark.parametrize("kw", [
    dict(seed=42, n_steps=32, n_slots=4, n_faults=8, crashes=2),
    dict(seed=0, n_steps=15, n_slots=2, n_faults=4, crashes=1),
    dict(seed=7, n_steps=64, n_slots=8, n_faults=12,
         kinds=("nan_logits", "kernel_fault"), crashes=0),
])
def test_fault_plan_seeded_matches_jax(kw):
    seed = kw.pop("seed")
    want = jfaults.FaultPlan.seeded(seed, **kw)
    got = tfaults.FaultPlan.seeded(seed, **kw)
    assert [tuple(vars(f).values()) for f in got] == \
        [tuple(vars(f).values()) for f in want]
    for s in {f.step for f in got}:
        assert [vars(f) for f in got.at(s)] == [vars(f) for f in
                                                 want.at(s)]


def test_fault_plan_drop_and_kinds():
    f = tfaults.Fault(step=3, kind="step_exception")
    plan = tfaults.FaultPlan([f, f, tfaults.Fault(step=1,
                                                  kind="nan_logits")])
    assert len(plan.drop(f)) == 2 and len(plan.drop(f).drop(f)) == 1
    assert [x.step for x in plan] == [1, 3, 3]
    with pytest.raises(ValueError):
        tfaults.Fault(step=0, kind="not_a_fault")
    assert tfaults.FAULT_KINDS == jfaults.FAULT_KINDS


# ------------------------------------------------ snapshot / restore

@pytest.mark.parametrize("name,variant", ZOO)
def test_snapshot_restore_matches_jax(name, variant, tmp_path):
    """Kill the engine mid-trace at steps 2 and 5 (one slot, so at step 5
    the batch request's spill is in flight), restore the snapshot into a
    freshly built engine and finish: tokens, events and stats equal the
    JAX engine's uninterrupted run. The dense case at step 5 goes through
    the disk."""
    lm_ = _params(variant)
    kw = dict(preempt=True, age_promote=64.0, n_slots=1)
    jeng = _engines(lm_, **kw)[0]
    _submit_mixed(jeng, lm_[0].vocab_size)
    want = _outcome(jeng, jeng.run(max_steps=2000))
    for cut in (2, 5):
        eng = _engines(lm_, **kw)[1]
        _submit_mixed(eng, lm_[0].vocab_size)
        _step_n(eng, cut)
        snap = eng.snapshot()
        assert (cut == 5) == any(r.spill is not None
                                 for r in eng.sched.queue)
        if name == "dense" and cut == 5:
            path = str(tmp_path / "snap")
            tstore.save_snapshot(path, snap)
            snap = tstore.load_snapshot(path)
        fresh = _engines(lm_, **kw)[1]
        fresh.restore(snap)
        got = _outcome(fresh, fresh.run(max_steps=2000))
        assert got == want, f"{name}: restore at step {cut}"
        _assert_drained(fresh)


def _deep_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _deep_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _deep_equal(x, y)
    elif isinstance(a, (np.ndarray, torch.Tensor)):
        x = (a.float().numpy() if isinstance(a, torch.Tensor)
             else np.asarray(a, np.float64 if a.dtype == ml_dtypes.bfloat16
                             else a.dtype))
        y = (b.float().numpy() if isinstance(b, torch.Tensor)
             else np.asarray(b, np.float64 if b.dtype == ml_dtypes.bfloat16
                             else b.dtype))
        np.testing.assert_array_equal(x, y)
    else:
        assert a == b and type(a) is type(b)


def test_snapshot_files_cross_packages(lm, tmp_path):
    """A snapshot file written by the port (mid-trace, a preempted request
    holding a spill payload) decodes with the JAX package's load_snapshot
    to the same structure, key types and tuples included, and the port's
    own load restores it; a JAX engine's snapshot file decodes with the
    port's load_snapshot. bf16 arrays cross both ways."""
    kw = dict(preempt=True, age_promote=64.0, n_slots=1)
    jeng, teng = _engines(lm, **kw)
    for eng in (jeng, teng):
        _submit_mixed(eng, lm[0].vocab_size)
        _step_n(eng, 5)
    snap = teng.snapshot()
    assert any(r["spill"] is not None
               for r in snap["sched"]["requests"].values())
    snap["extra"] = {"bf16": torch.tensor([1.5, -2.25, 3e-3],
                                          dtype=torch.bfloat16)}
    path = str(tmp_path / "port")
    tstore.save_snapshot(path, snap)
    _deep_equal(snap, jstore.load_snapshot(path))
    _deep_equal(snap, tstore.load_snapshot(path))
    back = tstore.load_snapshot(path)
    assert back["extra"]["bf16"].dtype == torch.bfloat16
    del back["extra"]
    fresh = _engines(lm, **kw)[1]
    fresh.restore(back)
    assert _tokens(fresh.run(max_steps=2000)) == _tokens(
        teng.run(max_steps=2000))

    jsnap = jeng.snapshot()
    jsnap["extra"] = {"bf16": np.asarray([1.5, -2.25, 3e-3],
                                         ml_dtypes.bfloat16)}
    jpath = str(tmp_path / "jax")
    jstore.save_snapshot(jpath, jsnap)
    got = tstore.load_snapshot(jpath)
    assert got["extra"]["bf16"].dtype == torch.bfloat16
    _deep_equal(jstore.load_snapshot(jpath), got)


def test_snapshot_fingerprint_mismatch_raises(lm):
    eng = _engines(lm)[1]
    snap = eng.snapshot()
    for kw in ({"n_slots": 3}, {"decode_block": 4}, {"page_size": 16},
               {"preempt": True}):
        other = _engines(lm, **kw)[1]
        with pytest.raises(ValueError, match="fingerprint"):
            other.restore(snap)
    gqa = _engines(_params({"n_kv_heads": 2}))[1]
    with pytest.raises(ValueError, match="fingerprint"):
        gqa.restore(snap)


def test_snapshot_preserves_free_list_order(lm):
    eng = _engines(lm)[1]
    _submit_mixed(eng, TCFG.vocab_size)
    _step_n(eng, 3)
    fresh = _engines(lm)[1]
    fresh.restore(eng.snapshot())
    assert list(fresh.pool._free) == list(eng.pool._free)
    assert np.array_equal(fresh.pool.tables, eng.pool.tables)
    assert _tokens(fresh.run(max_steps=2000)) == _tokens(
        eng.run(max_steps=2000))


# ------------------------------------------------------- fault kinds

def test_nan_quarantine_matches_jax(lm):
    """A NaN-poisoned slot is quarantined by the sentinel, its co-batched
    slot's tokens equal a run alone, all as in the JAX engine."""
    rng = np.random.default_rng(3)
    p0 = rng.integers(0, TCFG.vocab_size, 8)
    p1 = rng.integers(0, TCFG.vocab_size, 8)
    solo_eng = _engines(lm)[1]
    solo = solo_eng.submit(p0, max_new=10)
    solo_eng.run(max_steps=500)
    out = []
    for eng in _engines(lm, faults=[(2, "nan_logits", 1)]):
        survivor = eng.submit(p0, max_new=10)
        victim = eng.submit(p1, max_new=10)
        done = eng.run(max_steps=500)
        assert victim.error == "nonfinite_logits" and survivor.error is None
        _assert_drained(eng)
        out.append((_outcome(eng, done), _fault_view(eng.fault_stats())))
    assert out[1] == out[0]
    assert out[1][0][0][0] == tuple(solo.tokens)
    assert out[1][1]["n_nonfinite"] == out[1][1]["n_quarantined"] == 1


def test_pool_exhaust_matches_jax(lm):
    """Held pages delay the second admission; the hold releases on
    schedule; tokens equal the fault-free run; as in the JAX engine."""
    rng = np.random.default_rng(4)
    p0 = rng.integers(0, TCFG.vocab_size, 8)
    p1 = rng.integers(0, TCFG.vocab_size, 8)
    runs = {}
    for faults in (None, [(1, "pool_exhaust", -1, 6, 4)]):
        out = []
        for eng in _engines(lm, faults=faults, debug=True, n_pages=8):
            eng.submit(p0, max_new=12, arrival=0.0)
            eng.submit(p1, max_new=4, arrival=2.0)
            done = eng.run(max_steps=500)
            _assert_drained(eng)
            out.append((_outcome(eng, done), _fault_view(eng.fault_stats())))
        assert out[1] == out[0]
        runs[faults is None] = out[1]
    admit = {faulty: {e[2]: e[1] for e in runs[faulty][0][2]
                      if e[0] == "admit"} for faulty in (True, False)}
    assert admit[False][1] > admit[True][1]
    assert runs[False][0][0] == runs[True][0][0]
    assert runs[False][1]["held_pages"] == 0


def _uniform_trace(mod, **kw):
    return mod.make_trace(kind="uniform", n=6, rate=1.0, seed=5,
                          vocab_size=TCFG.vocab_size, prompt_len=(6, 10),
                          max_new=(4, 8), **kw)


def test_step_exception_resilient_matches_jax(lm, tmp_path):
    """run_resilient rebuilds the engine from the last snapshot after each
    injected crash: tokens equal the fault-free run, and crashes,
    snapshots, events and stats equal the JAX driver's, with snapshots in
    memory and through the disk."""
    jcfg, tcfg, jp, tp = lm
    plan = [(4, "step_exception"), (9, "step_exception")]
    base = traffic.replay(_engines(lm, preempt=True, age_promote=64.0)[1],
                          _uniform_trace(traffic), max_steps=2000)
    for store_dir in (None, str(tmp_path / "snap")):
        jres = jfaults.run_resilient(
            lambda: JaxEngine(jcfg, jp, preempt=True, age_promote=64.0,
                              **_geom({})),
            _uniform_trace(jtraffic), faults=_plan(jfaults, plan),
            snapshot_every=3, store_dir=store_dir, max_steps=2000)
        tres = tfaults.run_resilient(
            lambda: ContinuousEngine(tcfg, tp, preempt=True,
                                     age_promote=64.0, device="cpu",
                                     **_geom({})),
            _uniform_trace(traffic), faults=_plan(tfaults, plan),
            snapshot_every=3, store_dir=store_dir, max_steps=2000)
        assert tres["n_crashes"] == jres["n_crashes"] == 2
        assert tres["n_snapshots"] == jres["n_snapshots"] > 0
        assert _outcome(tres["engine"], tres["requests"]) == _outcome(
            jres["engine"], jres["requests"])
        assert tres["report"]["faults"] == _fault_view(
            jres["report"]["faults"])
        assert _tokens(tres["requests"]) == _tokens(base["requests"])
        _assert_drained(tres["engine"])


def test_spill_corruption_matches_jax(lm):
    """A spill payload corrupted in host RAM fails its checksum at restore:
    the victim is quarantined, the preemptor's tokens are untouched, no
    page leaks; as in the JAX engine."""
    rng = np.random.default_rng(11)
    batch_p = rng.integers(0, TCFG.vocab_size, 8)
    inter_p = rng.integers(0, TCFG.vocab_size, 8)
    kw = dict(n_slots=1, max_len=40, decode_block=1, preempt=True)
    out = []
    for eng in _engines(lm, faults=[(1, "spill_corrupt")], **kw):
        victim = eng.submit(batch_p, max_new=20, arrival=0.0, priority=1)
        eng.submit(inter_p, max_new=4, arrival=4.0, priority=0)
        done = eng.run(max_steps=500)
        assert victim.n_preempts == 1 and victim.error == "spill_corrupt"
        _assert_drained(eng)
        out.append((_outcome(eng, done), _fault_view(eng.fault_stats())))
    assert out[1] == out[0]
    st = out[1][1]
    assert (st["n_spill_corruptions"], st["n_spill_checksum_fails"],
            st["n_quarantined"]) == (1, 1, 1)


def test_kernel_fault_is_a_crash(lm):
    """A kernel_fault fails the next decode dispatch: under run() it raises
    FaultInjected (no fallback); under run_resilient it is one crash,
    recovered from the last snapshot, with tokens equal to the fault-free
    run and to the JAX engine's (which retried on its gather read); the
    recovered history never applied the fault."""
    jcfg, tcfg, jp, tp = lm
    plan = [(3, "kernel_fault")]
    eng = _engines(lm, faults=plan)[1]
    _submit_mixed(eng, TCFG.vocab_size)
    with pytest.raises(tfaults.FaultInjected, match="kernel_fault"):
        eng.run(max_steps=2000)
    trace = _uniform_trace(traffic)
    free = traffic.replay(_engines(lm)[1], trace, max_steps=2000)
    jres = jfaults.run_resilient(
        lambda: JaxEngine(jcfg, jp, **_geom({})), _uniform_trace(jtraffic),
        faults=_plan(jfaults, plan), snapshot_every=2, max_steps=2000)
    tres = tfaults.run_resilient(
        lambda: ContinuousEngine(tcfg, tp, device="cpu", **_geom({})),
        trace, faults=_plan(tfaults, plan), snapshot_every=2,
        max_steps=2000)
    assert jres["engine"].fault_stats()["n_kernel_fallbacks"] == 1
    assert jres["n_crashes"] == 0 and tres["n_crashes"] == 1
    assert [f.kind for f in tres["crashes"]] == ["kernel_fault"]
    assert _tokens(tres["requests"]) == _tokens(free["requests"])
    assert _outcome(tres["engine"], tres["requests"]) == _outcome(
        jres["engine"], jres["requests"])
    assert tres["engine"].fault_stats() == _fault_view(
        jres["engine"].fault_stats(), kernel_crashes=1)
    _assert_drained(tres["engine"])


# ------------------------------------------------- deadlines / shedding

def test_deadline_shed_cancel_matches_jax(lm):
    """Deadlines split the trace into shed, cancelled and completed
    populations, disjoint, with counters that agree with the flags; events
    equal the JAX engine's."""
    kw = dict(kind="bursty", n=8, rate=1.0, seed=3,
              vocab_size=TCFG.vocab_size, prompt_len=(6, 10),
              max_new=(4, 16), burst_len=0.4, idle_len=6.0,
              burst_rate_mult=8.0, deadline=8.0)
    out = []
    for eng, mod in zip(_engines(lm, n_slots=1, decode_block=1),
                        (jtraffic, traffic)):
        report = mod.replay(eng, mod.make_trace(**kw), max_steps=2000)
        reqs = report["requests"]
        shed = {r.rid for r in reqs if r.shed}
        cancelled = {r.rid for r in reqs if r.cancelled}
        completed = {r.rid for r in reqs
                     if not (r.shed or r.cancelled or r.rejected
                             or r.error)}
        assert shed and cancelled and completed
        assert shed | cancelled | completed == {r.rid for r in reqs}
        assert len(shed) + len(cancelled) + len(completed) == len(reqs)
        assert all(not r.tokens for r in reqs if r.shed)
        assert report["overall"]["n_shed"] == len(shed)
        _assert_drained(eng)
        out.append((_outcome(eng, reqs), _fault_view(eng.fault_stats())))
    assert out[1] == out[0]


# -------------------------------------------------- debug mode / leaks

def test_debug_check_passes_clean_and_catches_corruption(lm):
    """debug=True checks every step: a clean preempting trace passes, and
    a slot mirror corrupted by hand fails the very next step."""
    eng = _engines(lm, debug=True, preempt=True, age_promote=64.0)[1]
    assert eng.debug
    _submit_mixed(eng, TCFG.vocab_size)
    eng.run(max_steps=2000)
    _assert_drained(eng)
    eng = _engines(lm, debug=True)[1]
    eng.submit(np.arange(8, dtype=np.int32), max_new=8)
    _step_n(eng, 2)
    eng.cur_len[0] += 1
    with pytest.raises(AssertionError, match="disagrees|exceeds"):
        eng.step(float(eng.t))


def test_mixed_trace_leak_audit_matches_jax(lm):
    """Every early exit at once (preemption, deadline shed / cancel, NaN
    quarantine, corrupt-spill quarantine, a pool hold, a latency spike):
    the pool drains whole with the per-step check on, and everything
    equals the JAX engine's run."""
    plan = [(1, "spill_corrupt"), (6, "nan_logits", 0),
            (9, "pool_exhaust", -1, 4, 3), (12, "latency_spike", -1, 0, 4)]
    kw = dict(kind="bursty", n=10, rate=1.0, seed=9,
              vocab_size=TCFG.vocab_size, prompt_len=(6, 12),
              max_new=(4, 14), burst_len=0.5, idle_len=5.0,
              burst_rate_mult=8.0, deadline=20.0)
    out = []
    for eng, mod in zip(_engines(lm, faults=plan, debug=True, preempt=True,
                                 age_promote=32.0), (jtraffic, traffic)):
        report = mod.replay(eng, mod.make_trace(**kw), max_steps=2000)
        assert eng.fault_stats()["n_faults_applied"] == len(plan)
        _assert_drained(eng)
        assert eng._fault_holds == []
        out.append((_outcome(eng, report["requests"]),
                    _fault_view(eng.fault_stats())))
    assert out[1] == out[0]


# --------------------------------------------------- seeded chaos matrix

@pytest.mark.parametrize("seed", range(3))
def test_chaos_matrix_matches_jax(lm, seed):
    """tests/test_faults.py's seeded chaos plans (one crash each) through
    both packages' run_resilient, with the per-step check on: events,
    tokens, stats and spill counts equal the JAX run's, and fault_stats
    too but for the stated kernel_fault difference, worked out from the
    plan: every kernel_fault scheduled before the run's last step fired,
    each one a crash of the port's; the JAX engine fell back once if any
    fired. Two port runs are equal, and the pool drains whole."""
    jcfg, tcfg, jp, tp = lm
    kw = dict(kind="bursty", n=8, rate=1.0, seed=13,
              vocab_size=TCFG.vocab_size, prompt_len=(6, 10),
              max_new=(4, 10), burst_len=0.5, idle_len=6.0,
              burst_rate_mult=8.0)
    plan_kw = dict(n_steps=15, n_slots=2, n_faults=4, crashes=1)

    def jbuild():
        eng = JaxEngine(jcfg, jp, preempt=True, age_promote=64.0,
                        **_geom({}))
        eng.debug = True
        return eng

    def tbuild():
        return ContinuousEngine(tcfg, tp, preempt=True, age_promote=64.0,
                                debug=True, device="cpu", **_geom({}))

    jres = jfaults.run_resilient(
        jbuild, jtraffic.make_trace(**kw),
        faults=jfaults.FaultPlan.seeded(seed, **plan_kw),
        snapshot_every=4, max_steps=4000)
    runs = []
    for _ in range(2):
        tres = tfaults.run_resilient(
            tbuild, traffic.make_trace(**kw),
            faults=tfaults.FaultPlan.seeded(seed, **plan_kw),
            snapshot_every=4, max_steps=4000)
        _assert_drained(tres["engine"])
        runs.append((tres["n_crashes"], [vars(f) for f in tres["crashes"]],
                     _outcome(tres["engine"], tres["requests"]),
                     tres["engine"].fault_stats()))
    assert runs[0] == runs[1]
    n_crashes, crashes, outcome, stats = runs[0]
    plan = tfaults.FaultPlan.seeded(seed, **plan_kw)
    n_steps = jres["engine"].fault_stats()["n_steps"]
    fired = [f for f in plan if f.kind == "kernel_fault"
             and f.step < n_steps]
    assert sorted((c["step"], c["kind"]) for c in crashes
                  if c["kind"] == "kernel_fault") == \
        sorted((f.step, f.kind) for f in fired)
    assert n_crashes == jres["n_crashes"] + len(fired)
    assert jres["engine"].fault_stats()["n_kernel_fallbacks"] == \
        min(1, len(fired))
    assert outcome == _outcome(jres["engine"], jres["requests"])
    assert stats == _fault_view(jres["engine"].fault_stats(),
                                kernel_crashes=len(fired))
