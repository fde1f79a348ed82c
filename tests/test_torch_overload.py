"""The port's overload discipline against the JAX package: class-ordered
admission on the engine (the same admissions and events as the JAX
engine), the page pool's spill / restore / hold / discard state equal to
the JAX pool's after every operation of a seeded sequence, the scheduler
cases of tests/test_overload.py run on both schedulers with equal events,
stats and state, a lockstep fuzz of both schedulers, and the JAX
package's pinned event sequence of a seeded bursty trace on the port's
preempting engine."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
import repro.serve.kvcache as jkv
import repro.serve.scheduler as jsched
from repro.models.transformer import init_lm as jinit
from repro.serve.engine import ContinuousEngine as JaxEngine
import repro_torch.configs as tc
import repro_torch.serve.kvcache as tkv
import repro_torch.serve.scheduler as tsched
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.serve import traffic
from repro_torch.serve.engine import ContinuousEngine

# tests/test_overload.py's CFG in both packages
SHRINK = dict(n_repeats=2, d_model=64, head_dim=16, d_ff=128)
JCFG = jc.TINY.replace(**SHRINK)
TCFG = tc.TINY.replace(**SHRINK)
PKGS = {"jax": (jkv, jsched), "torch": (tkv, tsched)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the engine's small ops stall on thread-pool
    barriers when several test processes share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def params():
    """(JAX params, the same weights as the port's tree on the CPU)."""
    p = jinit(JCFG, jax.random.PRNGKey(0))
    return p, params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                                device="cpu")


# ------------------------------------------------ the admission repair

def test_admission_is_class_ordered_like_jax(params):
    """Without preemption the port admits by class as the JAX engine does:
    a later interactive request goes ahead of an earlier batch one. One
    slot; batch rid 0 at t 0 and rid 1 at t 1, interactive rid 2 at t 2:
    both engines admit rid 2 at t 3 and rid 1 at t 5 (FIFO admission gave
    rid 1 t 3)."""
    kw = dict(n_slots=1, max_len=48, page_size=8, prefill_bucket=8,
              decode_block=2)
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, JCFG.vocab_size, 8), mn, t, prio)
            for mn, t, prio in ((6, 0.0, 1), (4, 1.0, 1), (4, 2.0, 0))]
    engines = (JaxEngine(JCFG, params[0], **kw),
               ContinuousEngine(TCFG, params[1], device="cpu", **kw))
    done = []
    for eng in engines:
        for prompt, mn, t, prio in reqs:
            eng.submit(prompt, max_new=mn, arrival=t, priority=prio)
        done.append(eng.run(max_steps=200))
    admitted = [{r.rid: r.admitted_at for r in d} for d in done]
    assert admitted[1] == admitted[0] == {0: 0.0, 1: 5.0, 2: 3.0}
    assert [r.tokens for r in done[1]] == [r.tokens for r in done[0]]
    assert engines[1].sched.events == engines[0].sched.events
    assert engines[1].sched.stats() == engines[0].sched.stats()


# ------------------------------------------------- the pool, op by op

def _pool_state(pool):
    st = pool.state_dict()
    return {k: (v.tolist() if isinstance(v, np.ndarray) else v)
            for k, v in st.items()}


def _snap_fields(snap):
    return (snap.n_pages, snap.n_live, list(snap.kept), list(snap.copied),
            snap.restored)


@pytest.mark.parametrize("seed", range(6))
def test_pool_spill_matches_jax_op_by_op(seed):
    """A seeded sequence of alloc (with prefix hits), register, release,
    spill, restore (also into a dry pool, which both refuse), discard,
    hold, release_hold and clear on both pools: after every operation the
    two state_dicts are equal (tables, refcounts, spill and hold
    references, free-list order, the index), the snapshots agree field by
    field and copy_out sees the same pages, and both pools' invariants
    hold."""
    rng = np.random.default_rng(seed)
    spec = dict(n_pages=14, page_size=4, max_pages=4)
    n_slots = 3
    jpool = jkv.PagePool(jkv.PageSpec(**spec), n_slots, prefix_cache=True)
    tpool = tkv.PagePool(tkv.PageSpec(**spec), n_slots, prefix_cache=True)
    families = [np.arange(12, dtype=np.int32),
                np.arange(12, dtype=np.int32) + 1]
    live: dict = {}                    # slot -> (prompt, n_tokens)
    snaps: list = []                   # (JAX snapshot, port snapshot)
    holds: list = []                   # held page lists (equal in both)
    seen = set()
    for _ in range(200):
        op = str(rng.choice(["alloc", "register", "release", "spill",
                             "restore", "discard", "hold", "unhold",
                             "clear"],
                            p=[.22, .1, .12, .16, .14, .06, .08, .07, .05]))
        free_slots = [s for s in range(n_slots) if s not in live]
        if op == "alloc" and free_slots:
            n_tok = int(rng.integers(1, 17))
            prompt = families[int(rng.integers(0, 2))]
            shared = []
            if rng.integers(0, 2):
                shared = jpool.lookup_prefix(prompt)
                assert tpool.lookup_prefix(prompt) == shared
            shared = shared[:jpool.spec.pages_for(n_tok)]
            fits = jpool.can_alloc(n_tok, shared_pages=shared)
            assert tpool.can_alloc(n_tok, shared_pages=shared) == fits
            if not fits:
                continue
            slot = free_slots[0]
            jpool.alloc(slot, n_tok, shared_pages=shared)
            tpool.alloc(slot, n_tok, shared_pages=shared)
            live[slot] = (prompt, n_tok)
        elif op == "register" and live:
            slot = sorted(live)[int(rng.integers(0, len(live)))]
            prompt, n_tok = live[slot]
            if n_tok < 12 and rng.integers(0, 2):
                continue
            assert (tpool.register_prefix(prompt[:n_tok], slot)
                    == jpool.register_prefix(prompt[:n_tok], slot))
        elif op == "release" and live:
            slot = sorted(live)[int(rng.integers(0, len(live)))]
            jpool.release(slot)
            tpool.release(slot)
            del live[slot]
        elif op == "spill" and live:
            slot = sorted(live)[int(rng.integers(0, len(live)))]
            n_live = int(rng.integers(1, live[slot][1] + 1))
            assert tpool.slot_owned_pages(slot) == \
                jpool.slot_owned_pages(slot)
            seen_j, seen_t = [], []
            js = jpool.spill(slot, n_live, lambda p: seen_j.extend(p) or p)
            ts = tpool.spill(slot, n_live, lambda p: seen_t.extend(p) or p)
            assert seen_t == seen_j and ts.host == js.host
            assert _snap_fields(ts) == _snap_fields(js)
            snaps.append((js, ts))
            del live[slot]
        elif op == "restore" and snaps and free_slots:
            js, ts = snaps[int(rng.integers(0, len(snaps)))]
            fits = jpool.can_restore(js)
            assert tpool.can_restore(ts) == fits
            slot = free_slots[0]
            if not fits:
                with pytest.raises(RuntimeError):
                    jpool.restore(slot, js)
                with pytest.raises(RuntimeError):
                    tpool.restore(slot, ts)
                op = "restore_dry"
            else:
                assert tpool.restore(slot, ts) == jpool.restore(slot, js)
                assert _snap_fields(ts) == _snap_fields(js)
                snaps.remove((js, ts))
                live[slot] = (families[0], js.n_live)
        elif op == "discard" and snaps:
            js, ts = snaps.pop(int(rng.integers(0, len(snaps))))
            jpool.discard_spill(js)
            tpool.discard_spill(ts)
            assert ts.kept == js.kept == []
        elif op == "hold":
            n = int(rng.integers(1, 5))
            pages = jpool.hold(n)
            assert tpool.hold(n) == pages
            holds.append(pages)
        elif op == "unhold" and holds:
            pages = holds.pop(int(rng.integers(0, len(holds))))
            jpool.release_hold(pages)
            tpool.release_hold(pages)
        elif op == "clear":
            assert tpool.clear_prefix_cache() == jpool.clear_prefix_cache()
        else:
            continue
        seen.add(op)
        assert _pool_state(tpool) == _pool_state(jpool), op
        tpool.check_invariants()
        jpool.check_invariants()
    # a state_dict round trip reproduces the pool exactly
    copy = tkv.PagePool(tkv.PageSpec(**spec), n_slots, prefix_cache=True)
    copy.load_state_dict(tpool.state_dict())
    assert _pool_state(copy) == _pool_state(tpool)
    assert {"alloc", "spill", "restore", "hold", "unhold"} <= seen


def test_check_invariants_sees_spill_and_hold_refs():
    """A spill or hold reference that goes missing is reported."""
    pool = tkv.PagePool(tkv.PageSpec(n_pages=9, page_size=4, max_pages=4),
                        2, prefix_cache=True)
    pool.alloc(0, 12)
    pool.register_prefix(np.arange(12, dtype=np.int32), 0)
    snap = pool.spill(0, 12, lambda p: p)
    assert snap.kept and not snap.copied
    pool.hold(2)
    pool.check_invariants()
    pool._spill_refs[snap.kept[0][1]] -= 1
    with pytest.raises(AssertionError, match="refcounts"):
        pool.check_invariants()


# ------------------------------------------- the scheduler, both packages

def _req(m, rid, *, plen=4, max_new=4, arrival=0.0, priority=0,
         deadline=None):
    return m.Request(rid=rid, prompt=np.zeros(plen, np.int32),
                     max_new=max_new, arrival=arrival, priority=priority,
                     deadline=deadline)


def _pool(kv, n_pages=17, page_size=4, max_pages=4, n_slots=2, **kw):
    return kv.PagePool(kv.PageSpec(n_pages=n_pages, page_size=page_size,
                                   max_pages=max_pages), n_slots=n_slots,
                       **kw)


def _fake_spill_hook(pool):
    """The engine hook's bookkeeping without data movement."""
    def hook(slot, req, now):
        return pool.spill(slot, req.n_prompt, lambda pages: None)
    return hook


def _summary(sched):
    st = sched.state_dict()
    st["requests"] = {rid: {k: (v.tolist() if isinstance(v, np.ndarray)
                                else v) for k, v in r.items()}
                      for rid, r in st["requests"].items()}
    st["pool"] = _pool_state(sched.pool)
    return st


def case_interactive_head_first(kv, m):
    sched = m.Scheduler(2, _pool(kv))
    sched.submit(_req(m, 0, arrival=0.0, priority=m.BATCH))
    sched.submit(_req(m, 1, arrival=1.0, priority=m.INTERACTIVE))
    # class outranks arrival: the fresher interactive request goes first
    assert [r.rid for _, r in sched.admit(1.0)] == [1, 0]
    return sched


def case_bad_class_refused(kv, m):
    sched = m.Scheduler(1, _pool(kv, n_slots=1))
    with pytest.raises(ValueError):
        sched.submit(_req(m, 0, priority=7))
    return sched


def case_aging_starvation_freedom(kv, m):
    def drive(age_promote):
        sched = m.Scheduler(1, _pool(kv, n_slots=1, n_pages=9),
                            age_promote=age_promote)
        sched.submit(_req(m, 0, arrival=0.0, priority=m.BATCH))
        for i in range(1, 6):
            sched.submit(_req(m, i, arrival=float(i - 1),
                              priority=m.INTERACTIVE))
        order = []
        for t in range(12):
            order += [r.rid for _, r in sched.admit(float(t))]
            if sched.active_slots():
                sched.retire(0, float(t) + 0.5)
        return sched, order
    _, starved = drive(None)
    sched, aged = drive(3.0)
    assert starved.index(0) == len(starved) - 1
    assert aged.index(0) < len(aged) - 1
    assert sorted(starved) == sorted(aged)
    return sched


def case_victim_latest_lower_class(kv, m):
    pool = _pool(kv)
    sched = m.Scheduler(2, pool, preempt_hook=_fake_spill_hook(pool))
    sched.submit(_req(m, 0, arrival=0.0, priority=m.BATCH))
    sched.submit(_req(m, 1, arrival=1.0, priority=m.BATCH))
    assert len(sched.admit(1.0)) == 2
    sched.submit(_req(m, 2, arrival=2.0, priority=m.INTERACTIVE))
    assert [r.rid for _, r in sched.admit(2.0)] == [2]
    assert ("preempt", 2.0, 1, 1) in sched.events
    victim = sched.queues[m.BATCH][0]
    assert victim.rid == 1 and victim.spill is not None
    assert victim.n_preempts == 1
    pool.check_invariants()
    return sched


def case_aged_batch_never_preempts(kv, m):
    pool = _pool(kv, n_slots=1, n_pages=9)
    sched = m.Scheduler(1, pool, age_promote=2.0,
                        preempt_hook=_fake_spill_hook(pool))
    sched.submit(_req(m, 0, arrival=0.0, priority=m.BATCH))
    sched.submit(_req(m, 1, arrival=1.0, priority=m.BATCH))
    assert [r.rid for _, r in sched.admit(1.0)] == [0]
    assert sched.admit(50.0) == []
    assert sched.n_preemptions == 0
    sched.submit(_req(m, 2, arrival=51.0, priority=m.INTERACTIVE))
    sched.retire(0, 51.0)
    assert [r.rid for _, r in sched.admit(51.0)] == [1]
    assert sched.n_preemptions == 0
    assert [r.rid for _, r in sched.admit(52.0)] == [2]
    assert sched.n_preemptions == 1
    return sched


def case_shared_only_victim_skipped(kv, m):
    pool = _pool(kv, n_slots=2, n_pages=5, max_pages=2, prefix_cache=True)
    sched = m.Scheduler(2, pool, prefix_share=True,
                        preempt_hook=_fake_spill_hook(pool))
    prompt = np.arange(8, dtype=np.int32)
    sched.submit(m.Request(rid=0, prompt=prompt, max_new=0,
                           priority=m.BATCH))
    assert len(sched.admit(0.0)) == 1
    pool.register_prefix(prompt, 0)
    assert pool.slot_owned_pages(0) == 0
    sched.submit(_req(m, 1, arrival=1.0, plen=5, max_new=3,
                      priority=m.BATCH))
    assert len(sched.admit(1.0)) == 1
    sched.submit(_req(m, 2, arrival=2.0, plen=5, max_new=3,
                      priority=m.INTERACTIVE))
    sched.retire(1, 2.0)
    pool.alloc(1, 8)
    assert sched.admit(2.0) == []
    assert sched.n_preemptions == 0
    pool.release(1)
    pool.check_invariants()
    return sched


def case_rejected_vs_preempted(kv, m):
    pool = _pool(kv)
    sched = m.Scheduler(2, pool, preempt_hook=_fake_spill_hook(pool))
    sched.submit(_req(m, 9, plen=20, max_new=20))
    sched.submit(_req(m, 0, arrival=0.0, priority=m.BATCH))
    sched.submit(_req(m, 1, arrival=1.0, priority=m.BATCH))
    assert len(sched.admit(1.0)) == 2
    sched.submit(_req(m, 2, arrival=2.0, priority=m.INTERACTIVE))
    assert [r.rid for _, r in sched.admit(2.0)] == [2]
    sched.retire(0, 3.0)
    readmitted = sched.admit(3.0)
    assert [r.rid for _, r in readmitted] == [1]
    assert readmitted[0][1].spill is not None
    assert [e[0] for e in sched.events] == \
        ["reject", "admit", "admit", "preempt", "admit", "restore"]
    sched.retire(readmitted[0][0], 4.0)
    sched.retire(sched.slots.index(
        next(r for r in sched.slots if r and r.rid == 2)), 4.0)
    assert sched.stats() == {"n_preemptions": 1, "n_restored": 1,
                             "n_rejected": 1, "n_finished_ok": 3,
                             "n_finished_preempted": 1, "n_shed": 0,
                             "n_cancelled": 0, "n_quarantined": 0}
    assert {r.rid for r in sched.finished} == {9, 0, 1, 2}
    pool.check_invariants()
    assert np.all(pool.tables == -1)
    return sched


def case_preempted_queue_wait(kv, m):
    pool = _pool(kv, n_slots=1, n_pages=9)
    sched = m.Scheduler(1, pool, preempt_hook=_fake_spill_hook(pool))
    r0 = _req(m, 0, arrival=0.0, priority=m.BATCH)
    sched.submit(r0)
    sched.submit(_req(m, 1, arrival=3.0, priority=m.INTERACTIVE))
    assert len(sched.admit(0.0)) == 1
    sched.admit(3.0)
    sched.retire(0, 7.0)
    sched.admit(7.0)
    assert r0.queue_wait == 4.0 and r0.admitted_at == 0.0
    return sched


def case_shed_cancel_quarantine(kv, m):
    """Deadlines and error exits: a queued request past its deadline is
    shed (a preempted one discards its snapshot), and cancel / quarantine
    free the slot's pages; each counts in exactly one population."""
    pool = _pool(kv, n_slots=2, prefix_cache=True)
    sched = m.Scheduler(2, pool, prefix_share=True,
                        preempt_hook=_fake_spill_hook(pool))
    shared = np.arange(9, dtype=np.int32)
    sched.submit(m.Request(rid=0, prompt=shared, max_new=3, arrival=0.0,
                           priority=m.BATCH, deadline=6.0))
    sched.submit(_req(m, 1, arrival=0.0, priority=m.BATCH, deadline=30.0))
    assert len(sched.admit(0.0)) == 2
    pool.register_prefix(shared, 0)
    sched.submit(_req(m, 2, arrival=1.0, priority=m.INTERACTIVE,
                      deadline=1.5))
    sched.submit(_req(m, 3, arrival=1.0, priority=m.INTERACTIVE))
    assert [r.rid for _, r in sched.admit(1.0)] == [2, 3]   # 2 preempts
    assert sched.n_preemptions == 2
    sched.quarantine(sched.slots.index(
        next(r for r in sched.slots if r and r.rid == 3)), 2.0, "test")
    sched.cancel(sched.slots.index(
        next(r for r in sched.slots if r and r.rid == 2)), 2.0)
    sched.admit(7.0)                  # rid 0 is past 6.0: shed
    pool.check_invariants()
    st = sched.stats()
    assert (st["n_shed"], st["n_cancelled"], st["n_quarantined"]) == \
        (1, 1, 1)
    return sched


SCHED_CASES = [case_interactive_head_first, case_bad_class_refused,
               case_aging_starvation_freedom, case_victim_latest_lower_class,
               case_aged_batch_never_preempts,
               case_shared_only_victim_skipped, case_rejected_vs_preempted,
               case_preempted_queue_wait, case_shed_cancel_quarantine]


@pytest.mark.parametrize("case", SCHED_CASES, ids=lambda c: c.__name__[5:])
def test_scheduler_case_on_both(case):
    """Each scheduler case of tests/test_overload.py (and one for deadlines
    and error exits) holds on the JAX scheduler and the port's, with equal
    events, stats, requests and pool state."""
    out = {name: _summary(case(kv, m)) for name, (kv, m) in PKGS.items()}
    assert out["torch"] == out["jax"]


@pytest.mark.parametrize("seed", range(4))
def test_scheduler_lockstep_fuzz(seed):
    """Seeded submit / admit / retire / cancel / quarantine traffic on both
    schedulers (preemption, aging, deadlines, prefix sharing on): the two
    state_dicts are equal after every operation."""
    rng = np.random.default_rng(seed)
    scheds = {}
    for name, (kv, m) in PKGS.items():
        pool = _pool(kv, n_pages=13, n_slots=3, prefix_cache=True)
        scheds[name] = (m, m.Scheduler(3, pool, prefix_share=True,
                                       age_promote=6.0,
                                       preempt_hook=_fake_spill_hook(pool)))
    rid, now = 0, 0.0
    for _ in range(150):
        op = int(rng.choice(5, p=[.35, .35, .14, .08, .08]))
        now += float(rng.integers(0, 2))
        if op == 0:
            plen = int(rng.integers(2, 12))
            kw = dict(max_new=int(rng.integers(1, 8)),
                      arrival=now + float(rng.integers(0, 3)),
                      priority=int(rng.integers(0, 2)),
                      deadline=(now + float(rng.integers(2, 20))
                                if rng.integers(0, 3) == 0 else None))
            prompt = np.arange(plen, dtype=np.int32) % 5
            for m, sched in scheds.values():
                sched.submit(m.Request(rid=rid, prompt=prompt, **kw))
            rid += 1
        elif op == 1:
            got = {name: [(s, r.rid) for s, r in sched.admit(now)]
                   for name, (m, sched) in scheds.items()}
            assert got["torch"] == got["jax"]
        else:
            act = scheds["jax"][1].active_slots()
            if not act:
                continue
            slot = act[int(rng.integers(0, len(act)))]
            for m, sched in scheds.values():
                if op == 2:
                    sched.retire(slot, now)
                elif op == 3:
                    sched.cancel(slot, now)
                else:
                    sched.quarantine(slot, now, "fuzz")
        assert _summary(scheds["torch"][1]) == _summary(scheds["jax"][1])
        scheds["torch"][1].pool.check_invariants()
    st = scheds["torch"][1].stats()
    assert st["n_preemptions"] and st["n_finished_ok"]


# ------------------------------------- the JAX package's pinned trace

def test_trace_replay_pinned_events(params):
    """tests/test_overload.py's seeded bursty trace through the port's
    preempting engine: the JAX package's pinned admission / preemption
    sequence, stats and completion order, twice over."""
    trace = traffic.make_trace(kind="bursty", n=8, rate=1.0, seed=3,
                               vocab_size=TCFG.vocab_size,
                               prompt_len=(6, 12), max_new=(3, 6),
                               batch_frac=0.5, burst_len=0.4, idle_len=10.0,
                               burst_rate_mult=8.0)
    for it in trace:
        if it.priority == 1:
            it.max_new = 24
    runs = []
    for _ in range(2):
        eng = ContinuousEngine(TCFG, params[1], n_slots=2, max_len=48,
                               page_size=8, prefill_bucket=8, n_pages=10,
                               decode_block=2, preempt=True,
                               age_promote=64.0, device="cpu")
        report = traffic.replay(eng, trace, max_steps=5000)
        done = [r for r in report["requests"] if not r.rejected]
        by_cls = {c: [r.rid for r in sorted(done, key=lambda r: (
            r.finished_at, r.rid)) if r.priority == c] for c in (0, 1)}
        runs.append(([(e[0], e[2]) for e in eng.sched.events],
                     eng.sched.stats(), by_cls,
                     {r.rid: r.tokens for r in done}))
        eng.pool.check_invariants()
        assert np.all(eng.pool.tables == -1)
        assert report["spill"]["spilled_pages"] == \
            report["spill"]["restored_pages"] > 0
    assert runs[0] == runs[1]
    events, stats, by_cls, _ = runs[0]
    assert events == [
        ("admit", 0), ("admit", 2), ("admit", 1), ("admit", 3),
        ("preempt", 3), ("admit", 4), ("preempt", 1), ("admit", 6),
        ("restore", 1), ("restore", 3), ("admit", 5), ("admit", 7)]
    assert stats == {"n_preemptions": 2, "n_restored": 2, "n_rejected": 0,
                     "n_finished_ok": 8, "n_finished_preempted": 2,
                     "n_shed": 0, "n_cancelled": 0, "n_quarantined": 0}
    assert by_cls == {0: [0, 2, 6, 4], 1: [1, 3, 5, 7]}
