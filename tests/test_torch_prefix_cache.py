"""The port's prefix cache and chunked prefill against the JAX package: the
page pool's state equal to the reference's after every operation of a
seeded sequence (tables, refcounts, free-list order, index keys and
order), the reference's pool rules on the port's pool, and the serving
zoo with ``prefix_share`` and ``chunked_prefill``: greedy tokens and
counters equal to the JAX engine's, tokens equal to the port's own run
without sharing."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.models.transformer import init_lm as jinit
from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.kvcache import PagePool as JaxPool
from repro.serve.kvcache import PageSpec as JaxSpec
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.kvcache import PagePool, PageSpec
from repro_torch.serve.scheduler import Request, Scheduler

# tests/test_torch_engine.py's shrunken TINY in both packages
SHRINK = dict(n_repeats=2, d_model=64, head_dim=16, d_ff=128)
JCFG = jc.TINY.replace(**SHRINK)
TCFG = tc.TINY.replace(**SHRINK)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the engine's small ops stall on thread-pool
    barriers when several test processes share the machine."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------ pool state

def _state(pool):
    return dict(tables=pool.tables.tolist(),
                refcount=pool.refcount.tolist(), free=list(pool._free),
                index=[(k.hex(), int(p)) for k, p in
                       pool._prefix_index.items()],
                parent={k.hex(): (p.hex() if p is not None else None)
                        for k, p in pool._parent.items()},
                children={k.hex(): n for k, n in pool._children.items()},
                generation=pool.generation, n_cached=pool.n_cached)


def _evictable(pool):
    return any(pool.refcount[p] == 1 for p in pool._prefix_index.values())


@pytest.mark.parametrize("seed", range(6))
def test_pool_matches_jax_op_by_op(seed):
    """A seeded sequence of lookup, alloc (with the lookup's shared pages),
    register, release, evict and clear on both pools: after every
    operation the two states are equal and the port's invariants hold.
    Prompts draw from 2 symbols so prefixes collide often."""
    rng = np.random.default_rng(seed)
    ps, n_slots = 4, 3
    spec = dict(n_pages=14, page_size=ps, max_pages=5)
    jpool = JaxPool(JaxSpec(**spec), n_slots, prefix_cache=True)
    tpool = PagePool(PageSpec(**spec), n_slots, prefix_cache=True)
    prompts = {}                       # slot -> its prompt, while mapped
    ops_seen = set()
    for _ in range(160):
        op = rng.choice(["alloc", "register", "release", "evict",
                         "lookup", "clear"], p=[.3, .2, .25, .1, .1, .05])
        if op == "alloc":
            free_slots = [s for s in range(n_slots) if s not in prompts]
            if not free_slots:
                continue
            slot = int(rng.choice(free_slots))
            prompt = rng.integers(0, 2, int(rng.integers(2, 17)))
            budget = len(prompt) + int(rng.integers(0, 4))
            shared = jpool.lookup_prefix(prompt)
            assert tpool.lookup_prefix(prompt) == shared
            fits = jpool.can_alloc(budget, shared_pages=shared)
            assert tpool.can_alloc(budget, shared_pages=shared) == fits
            if not fits:
                continue
            jpool.alloc(slot, budget, shared_pages=shared)
            tpool.alloc(slot, budget, shared_pages=shared)
            prompts[slot] = prompt
        elif op == "register":
            if not prompts:
                continue
            slot = int(rng.choice(sorted(prompts)))
            assert (tpool.register_prefix(prompts[slot], slot)
                    == jpool.register_prefix(prompts[slot], slot))
        elif op == "release":
            if not prompts:
                continue
            slot = int(rng.choice(sorted(prompts)))
            jpool.release(slot)
            tpool.release(slot)
            del prompts[slot]
        elif op == "evict":
            assert _evictable(tpool) == _evictable(jpool)
            if not _evictable(jpool):
                continue
            jpool._evict_one()
            tpool._evict_one()
        elif op == "lookup":
            prompt = rng.integers(0, 2, int(rng.integers(1, 17)))
            assert tpool.lookup_prefix(prompt) == jpool.lookup_prefix(prompt)
        else:
            assert tpool.clear_prefix_cache() == jpool.clear_prefix_cache()
        ops_seen.add(str(op))
        assert _state(tpool) == _state(jpool), op
        assert tpool.n_free == jpool.n_free
        tpool.check_invariants()
        jpool.check_invariants()
    assert {"alloc", "register", "release", "evict"} <= ops_seen


def test_lookup_is_strict_prefix():
    """A lookup never covers the whole prompt and never matches when an
    earlier token differs (tests/test_prefix_cache.py on the port)."""
    pool = PagePool(PageSpec(n_pages=13, page_size=4, max_pages=6), 2,
                    prefix_cache=True)
    prompt = np.arange(8, dtype=np.int32)            # exactly 2 pages
    pool.alloc(0, 8)
    assert pool.register_prefix(prompt, 0) == 2
    assert len(pool.lookup_prefix(prompt)) == 1
    assert len(pool.lookup_prefix(np.arange(12, dtype=np.int32))) == 2
    other = np.concatenate([np.full(4, 99, np.int32),
                            np.arange(4, 8, dtype=np.int32), [1]])
    assert pool.lookup_prefix(other) == []
    # without the cache nothing is indexed or found
    plain = PagePool(PageSpec(n_pages=13, page_size=4, max_pages=6), 1)
    plain.alloc(0, 8)
    assert plain.register_prefix(prompt, 0) == 0
    assert plain.lookup_prefix(np.arange(12, dtype=np.int32)) == []


def test_eviction_takes_chain_leaves_first():
    pool = PagePool(PageSpec(n_pages=4, page_size=4, max_pages=3), 1,
                    prefix_cache=True)
    pool.alloc(0, 12)
    pool.register_prefix(np.arange(12, dtype=np.int32), 0)
    longer = np.arange(16, dtype=np.int32)
    chain = pool.lookup_prefix(longer)
    assert len(chain) == 3
    pool.release(0)                                  # index-only pages
    pool._evict_one()
    pool.check_invariants()
    assert pool.lookup_prefix(longer) == chain[:2]
    pool._evict_one()
    assert pool.lookup_prefix(longer) == chain[:1]
    pool.check_invariants()
    assert pool.clear_prefix_cache() == 1
    assert pool.n_free == 3 and pool.n_cached == 0


def test_shared_pages_are_referenced_and_outlive_holders():
    pool = PagePool(PageSpec(n_pages=13, page_size=4, max_pages=6), 3,
                    prefix_cache=True)
    prompt = np.arange(9, dtype=np.int32)            # 2 full pages + 1
    pool.alloc(0, 12)
    pool.register_prefix(prompt, 0)
    shared = pool.lookup_prefix(prompt)
    assert pool.refcount[shared].tolist() == [2, 2]  # slot + index
    assert pool.can_alloc(12, shared_pages=shared)
    pool.alloc(1, 12, shared_pages=shared)
    assert pool.tables[1][:2].tolist() == shared
    assert pool.refcount[shared].tolist() == [3, 3]
    pool.release(0)
    pool.release(1)
    assert pool.refcount[shared].tolist() == [1, 1]  # cached, not free
    assert not set(shared) & set(pool._free)
    pool.check_invariants()
    assert pool.n_free + pool.n_cached == 12
    assert pool.lookup_prefix(prompt) == shared


def test_blocked_head_reuses_its_lookup_until_the_index_changes(
        monkeypatch):
    """A queue head blocked on pages looks its prefix up once per index
    generation, not once per tick."""
    spec = PageSpec(n_pages=7, page_size=4, max_pages=6)
    pool = PagePool(spec, 2, prefix_cache=True)
    sched = Scheduler(2, pool, prefix_share=True)
    first = Request(rid=0, prompt=np.arange(12, dtype=np.int32), max_new=8)
    sched.submit(first)
    assert [s for s, _ in sched.admit(0.0)] == [0]
    pool.register_prefix(first.prompt, 0)
    calls = []
    real = pool.lookup_prefix
    monkeypatch.setattr(pool, "lookup_prefix",
                        lambda t: calls.append(1) or real(t))
    # 5 pages: 3 shared, 2 fresh of the 1 free -> blocked
    blocked = Request(rid=1, prompt=np.arange(16, dtype=np.int32),
                      max_new=4)
    sched.submit(blocked)
    for t in range(3):
        assert sched.admit(float(t)) == []
    assert len(calls) == 1
    sched.retire(0)
    assert [r.rid for _, r in sched.admit(4.0)] == [1]
    assert len(calls) == 1          # retire changed no index entry
    assert blocked.n_shared == 12
    pool.check_invariants()


# ------------------------------------------------------------ engine zoo

def _shared_prefix_requests(rng, n_shared=32, tails=((8, 5), (13, 4),
                                                     (24, 6), (5, 5))):
    system = rng.integers(0, JCFG.vocab_size, n_shared)
    return [(np.concatenate([system, rng.integers(0, JCFG.vocab_size, t)]),
             m) for t, m in tails]


def _counters(eng):
    return (eng.n_shared_tokens, eng.n_prefill_tokens, eng.n_prefills,
            eng.n_decode_steps)


def _drive(eng, reqs):
    for i, (prompt, max_new) in enumerate(reqs):
        eng.submit(prompt, max_new=max_new, arrival=float(i))
    done = eng.run(max_steps=2000)
    assert len(done) == len(reqs) and all(r.done for r in done)
    eng.pool.check_invariants()
    assert np.all(eng.pool.tables == -1)
    assert eng.pool.n_free + eng.pool.n_cached == eng.spec.n_pages - 1
    return [list(r.tokens) for r in done]


# dense, GQA, sliding window, int8 KV, W4 g32 packed weights
@pytest.mark.parametrize("name,variant,quant", [
    ("dense", {}, None),
    ("gqa", {"n_kv_heads": 2}, None),
    ("swa", {"attn_window": 12}, None),
    ("int8-kv", {"kv_cache_bits": 8}, None),
    ("w4-g32", {}, (4, 32)),
])
def test_prefix_chunked_zoo_matches_jax(name, variant, quant, monkeypatch):
    jcfg, tcfg = JCFG.replace(**variant), TCFG.replace(**variant)
    params = jinit(jcfg, jax.random.PRNGKey(0))
    kw = dict(n_slots=3, max_len=128, page_size=16, prefill_bucket=8)
    if quant:
        kw.update(quant_bits=quant[0], quant_group=quant[1])
        # the JAX engine's packed linears on the kernel path (interpret
        # mode): bf16 operands as in the port's kernel and plain version
        monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    reqs = _shared_prefix_requests(np.random.default_rng(7))
    share = dict(prefix_share=True, chunked_prefill=16)
    jeng = JaxEngine(jcfg, params, **kw, **share)
    want = _drive(jeng, reqs)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    teng = ContinuousEngine(tcfg, tparams, device="cpu", **kw, **share)
    got = _drive(teng, reqs)
    assert got == want, f"{name} diverged from the JAX engine"
    assert _counters(teng) == _counters(jeng)
    # whole pages of the 32-token system prompt
    assert teng.n_shared_tokens > 0 and teng.n_shared_tokens % 16 == 0
    base = _drive(ContinuousEngine(tcfg, tparams, device="cpu", **kw), reqs)
    assert got == base, f"{name}: sharing changed the tokens"


def test_chunked_prefill_interleaves_decode():
    """A long prompt in chunks does not stall decode: a short request
    admitted beside it finishes before the long one's first token, and
    the long prompt decodes what it does in one call."""
    params = init_lm(TCFG, seed=0, device="cpu")
    rng = np.random.default_rng(2)
    long_p = rng.integers(0, TCFG.vocab_size, 96)    # 6 chunks of 16
    short_p = rng.integers(0, TCFG.vocab_size, 8)
    eng = ContinuousEngine(TCFG, params, n_slots=2, max_len=128,
                           page_size=16, prefill_bucket=8, decode_block=1,
                           chunked_prefill=16, device="cpu")
    long_r = eng.submit(long_p, max_new=4, arrival=0.0)
    short_r = eng.submit(short_p, max_new=4, arrival=0.0)
    eng.run(max_steps=500)
    assert short_r.finished_at < long_r.first_token_at
    assert eng.n_prefills >= 6 + 1
    mono = ContinuousEngine(TCFG, params, n_slots=2, max_len=128,
                            page_size=16, prefill_bucket=8, device="cpu")
    assert _drive(mono, [(long_p, 4)]) == [long_r.tokens]


def test_eviction_under_pressure_and_fuzzed_invariants():
    """A pool too small to cache every prefix evicts index-only pages to
    admit new work; with colliding prefixes and chunks of one page the
    invariants hold after every step."""
    params = init_lm(TCFG, seed=0, device="cpu")
    rng = np.random.default_rng(4)
    eng = ContinuousEngine(TCFG, params, n_slots=2, max_len=48,
                           page_size=16, n_pages=12, prefill_bucket=8,
                           prefix_share=True, device="cpu")
    for i in range(6):
        eng.submit(rng.integers(0, TCFG.vocab_size, 32 + (i % 2)),
                   max_new=8, arrival=float(i))
    done = eng.run(max_steps=2000)
    assert len(done) == 6 and not any(r.rejected for r in done)
    eng.pool.check_invariants()
    assert eng.pool.n_free + eng.pool.n_cached == eng.spec.n_pages - 1
    eng = ContinuousEngine(TCFG, params, n_slots=3, max_len=64, page_size=8,
                           n_pages=20, prefill_bucket=8, prefix_share=True,
                           chunked_prefill=8, device="cpu")
    rng = np.random.default_rng(9)
    for _ in range(12):
        eng.submit(rng.integers(0, 3, int(rng.integers(4, 40))),
                   max_new=int(rng.integers(1, 6)),
                   arrival=float(rng.integers(0, 6)))
    steps = 0
    while not eng.sched.all_done():
        eng.step(float(steps))
        eng.pool.check_invariants()
        steps += 1
        assert steps < 1000
    done = eng.sched.finished
    assert len(done) == 12
    assert eng.n_shared_tokens == sum(r.n_shared for r in done)
