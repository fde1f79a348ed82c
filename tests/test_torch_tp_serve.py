"""Tensor-parallel serving in the port (``ContinuousEngine(tp=N)``, one
process a rank under ``gloo``) against the JAX package's engine at tp=1:
the cases of tests/test_tp_serve.py. The JAX package's TP needs four
devices and skips in the tier-1 run, and its own tests hold TP=k equal
to TP=1 there, so the JAX engine at tp=1, in this process, is the
reference. Greedy tokens are compared exactly, on every rank: the ranks'
streams must also equal each other.

This file: the first four cases of tests/test_tp_serve.py's ``ZOO``, the
prefix-cache hit, the placement report, the width, misaligned-group,
MoE/SSM, preempt and spec refusals, the scheduler's TP invariance, the
int32 host state, the W8A8 activation grid under TP and the launcher's
``--tp``. tests/test_torch_tp_serve_zoo.py runs the other zoo cases with
this file's helpers, and the fused-vs-gather case on its int8-KV one.

All the rank jobs of one file run in one spawn of four ``gloo`` ranks, in
one test (a module fixture would run once on every xdist worker): a
FileStore under the test's tmp dir, each rank one thread, the spawn with a
time limit of its own; a tp-4 case on the ("model",) mesh of four, a tp-2
case on a (2, 2) ("data", "model") mesh, two TP groups serving alike. Packed
JAX linears run on the kernel path (``REPRO_DEQUANT_IMPL=pallas``, bf16
operands as in the port).

The JAX package is imported inside the functions that run it, not at the
top: the ranks import this module to find their functions, and each would
otherwise spend seconds importing JAX it never uses.
"""
import concurrent.futures
import functools

import numpy as np
import pytest
import torch

import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.distributed import partitioning as P
from repro_torch.launch.mesh import Mesh, make_mesh
from repro_torch.launch.spawn import run_ranks
from repro_torch.models.config import LayerSpec, MLAConfig, MoEConfig
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.kvcache import POOL_KEYS, PagePool, PageSpec, \
    pool_head_dim
from repro_torch.serve.scheduler import Request, Scheduler

# tests/test_tp_serve.py's configs in both packages
SHRINK = dict(n_repeats=2, d_model=64, head_dim=16, d_ff=128)
GQA_KW = dict(n_heads=8, n_kv_heads=4, head_dim=8)
MLA_KW = dict(attention="mla", n_heads=4, n_kv_heads=4)
MLA_DIMS = dict(kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8,
                v_head_dim=16)
BASE = tc.TINY.replace(**SHRINK)
GQA = BASE.replace(**GQA_KW)
MLA = BASE.replace(mla=MLAConfig(**MLA_DIMS), **MLA_KW)
PORT = {"base": BASE, "gqa": GQA, "mla": MLA}
# four shapes, one ragged (9) prompt
WORKLOAD = [(8, 6), (16, 4), (24, 5), (9, 4)]
ENGINE = dict(n_slots=4, max_len=64, page_size=16, prefill_bucket=8)
# (name, base, config changes, tp, engine kwargs): tests/test_tp_serve.py's
# ZOO
ZOO = [
    ("dense-w4", "base", {}, 4, dict(quant_bits=4, quant_group=-1)),
    ("gqa-w4-grouped", "gqa", {}, 4, dict(quant_bits=4, quant_group=8)),
    ("gqa-w4-grouped-tp2", "gqa", {}, 2, dict(quant_bits=4, quant_group=8)),
    ("gqa-swa", "gqa", {"attn_window": 16}, 2, {}),
    ("gqa-int8kv-w4", "gqa", {"kv_cache_bits": 8}, 4,
     dict(quant_bits=4, quant_group=-1)),
    ("dense-w8a8", "base", {}, 2,
     dict(quant_bits=8, quant_group=-1, act_bits=8)),
    # W3A8: 3 is a kernel width, so the true A8 path (kernel 3) with the
    # activation amax all-reduced under TP
    ("dense-w3a8", "base", {}, 2,
     dict(quant_bits=3, quant_group=-1, act_bits=8)),
    ("mla-float", "mla", {}, 2, {}),
    # quantized MLA: wq/wukv/wo split, wdkv whole by design (a per-token
    # latent) and not reported as replicated
    ("mla-w4", "mla", {}, 2, dict(quant_bits=4, quant_group=-1)),
]
ZOO_HERE = ZOO[:4]


def jax_cfg(base):
    """The JAX package's counterpart of PORT[base]."""
    import repro.configs as jc
    from repro.models.config import MLAConfig as JMLA

    jbase = jc.TINY.replace(**SHRINK)
    return {"base": jbase, "gqa": jbase.replace(**GQA_KW),
            "mla": jbase.replace(mla=JMLA(**MLA_DIMS), **MLA_KW)}[base]


def pair(base, changes):
    return PORT[base].replace(**changes), jax_cfg(base).replace(**changes)


def prompts(vocab, workload=WORKLOAD, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, plen), mn) for plen, mn in workload]


def jax_params(jcfg):
    """The JAX package's init_lm params, and the same as numpy."""
    import jax
    from repro.models.transformer import init_lm as jinit

    params = jinit(jcfg, jax.random.PRNGKey(0))
    return params, jax.tree_util.tree_map(np.asarray, params)


def jax_tokens(jcfg, params, kw, reqs, **engine):
    """The JAX engine's greedy tokens at tp=1 (packed linears on the
    kernel path)."""
    from repro.serve.engine import ContinuousEngine as JaxEngine

    with pytest.MonkeyPatch.context() as mp:
        if kw.get("quant_bits"):
            mp.setenv("REPRO_DEQUANT_IMPL", "pallas")
        eng = JaxEngine(jcfg, params, **dict(ENGINE, **engine), **kw)
        hs = [eng.submit(p, max_new=mn) for p, mn in reqs]
        eng.run(max_steps=500)
        assert eng.pool.n_free == eng.spec.n_pages - 1
    return [list(h.tokens) for h in hs]


# ------------------------------------------------------------ rank side

def _mesh(world, tp):
    """tp 4: the ("model",) mesh of all four ranks; tp 2: (2, 2) over
    ("data", "model"), two TP groups side by side."""
    return make_mesh((world // tp, tp), ("data", "model"))


def _serve(cfg, params, tp, mesh, kw, reqs, engine=None, waves=None):
    eng = ContinuousEngine(cfg, params_from_numpy(params, device="cpu"),
                           tp=tp, mesh=mesh, device="cpu",
                           **dict(ENGINE, **(engine or {})), **kw)
    hs = []
    for wave in (waves or [reqs]):
        hs += [eng.submit(p, max_new=mn) for p, mn in wave]
        eng.run(max_steps=500)
    eng.pool.check_invariants()
    n_shared = eng.n_shared_tokens
    eng.pool.clear_prefix_cache()
    assert eng.pool.n_free == eng.spec.n_pages - 1   # pages all returned
    return eng, [list(h.tokens) for h in hs], n_shared


def _rank_jobs(rank, world, jobs):
    """Every job on this rank: its tokens, and per kind its extras."""
    out = {}
    meshes = {tp: _mesh(world, tp) for tp in sorted({j["tp"] for j in jobs})}
    for job in jobs:
        eng, toks, shared = _serve(job["cfg"], job["params"], job["tp"],
                                   meshes[job["tp"]], job["kw"],
                                   job.get("reqs"), job.get("engine"),
                                   job.get("waves"))
        res = {"tokens": toks, "shared": shared,
               "report": eng.tp_placement_report(),
               "pools": [(k, tuple(v.shape)) for k, v in eng._cache_leaves()
                         if k in POOL_KEYS],
               "whole_pools": [(k, tuple(v.shape)) for k, v in
                               eng._cache_leaves(eng._global_cache)
                               if k in POOL_KEYS],
               "cur_len": str(eng.cur_len.dtype),
               "last_tok": str(eng.last_tok.dtype)}
        out[job["name"]] = res
    return out


def run_jobs(jobs, store_dir):
    return run_ranks(_rank_jobs, 4, backend="gloo", args=(jobs,),
                     timeout=240, store_dir=store_dir)


def zoo_jobs(cases):
    """(rank jobs, the JAX engine's tokens by name, each a call to make)
    of zoo cases."""
    jobs, refs = [], {}
    for name, base, changes, tp, kw in cases:
        tcfg, jcfg = pair(base, changes)
        params, np_params = jax_params(jcfg)
        reqs = prompts(tcfg.vocab_size)
        refs[name] = functools.partial(jax_tokens, jcfg, params, kw, reqs)
        jobs.append(dict(name=name, cfg=tcfg, params=np_params, tp=tp,
                         kw=kw, reqs=reqs))
    return jobs, refs


def run_beside(jobs, refs, store_dir):
    """The ranks' results of ``jobs``, and the value of each of ``refs``'
    calls by name: the JAX engine runs in this process while the ranks
    serve (they need only the jobs' params and prompts)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_jobs, jobs, store_dir)
        want = {name: ref() for name, ref in refs.items()}
        return ranks.result(), want


def assert_zoo_case(name, got, want):
    """Every rank served the JAX engine's tokens, so the ranks agree."""
    for rank, res in enumerate(got):
        for rid, (a, b) in enumerate(zip(res[name]["tokens"], want[name])):
            assert a == b, (f"{name}: rank {rank} request {rid} diverged "
                            f"from the JAX engine at tp=1")


# -------------------------------------------------------- this file's run

# the prefix-cache hit: a second wave sharing a 16-token (full-page)
# system prompt reuses its page (tests/test_tp_serve.py's
# test_tp_prefix_cache_hit)
PREFIX_ENGINE = dict(prefix_share=True, chunked_prefill=16)


def prefix_waves(vocab):
    rng = np.random.default_rng(3)
    system = rng.integers(0, vocab, 16)
    w1 = [(np.concatenate([system, rng.integers(0, vocab, 8)]), 4)]
    w2 = [(np.concatenate([system, rng.integers(0, vocab, 8 + 4 * i)]), 4)
          for i in range(3)]
    return [w1, w2]


def jax_prefix_tokens(jcfg, params, waves):
    from repro.serve.engine import ContinuousEngine as JaxEngine

    eng = JaxEngine(jcfg, params, **ENGINE, **PREFIX_ENGINE)
    hs = []
    for wave in waves:
        hs += [eng.submit(p, max_new=mn) for p, mn in wave]
        eng.run(max_steps=500)
    return [list(h.tokens) for h in hs], eng.n_shared_tokens


def served_here(store_dir):
    """Every rank job of this file in one spawn of four ranks, and the
    JAX engine's tokens for each."""
    jobs, refs = zoo_jobs(ZOO_HERE)
    # the prefix hit at tp 4
    jbase = jax_cfg("base")
    params, np_params = jax_params(jbase)
    waves = prefix_waves(BASE.vocab_size)
    refs["prefix"] = functools.partial(jax_prefix_tokens, jbase, params,
                                       waves)
    jobs.append(dict(name="prefix", cfg=BASE, params=np_params, tp=4,
                     kw={}, engine=PREFIX_ENGINE, waves=waves))
    # placement: MLA W4 at tp 2 (the GQA W4 g8 tp-4 case is a zoo case)
    params, np_params = jax_params(jax_cfg("mla"))
    jobs.append(dict(name="mla-placement", cfg=MLA, params=np_params, tp=2,
                     kw=dict(quant_bits=4, quant_group=-1),
                     reqs=prompts(MLA.vocab_size)))
    return run_beside(jobs, refs, store_dir)


def test_tp_serving_matches_jax(tmp_path):
    """One spawn of four ranks serves every case below (one test, so the
    spawn and the JAX engine's compiles run once, on one worker):

      * token identity: each of ZOO_HERE's TP=N greedy streams equals the
        JAX engine's at tp=1 on every rank;
      * the prefix-cache hit: the second wave reuses the 16-token system
        page on every rank (48 shared tokens) and matches token for token;
      * placement: no replicated qw / scale / pool leaf on the W4 g8 GQA
        config at tp 4, each pool leaf a quarter of the whole pool's kv
        heads with every page, a quarter of the KV bytes; quantized MLA at
        tp 2 reports no violation (wdkv whole by design) and keeps its
        KVH-1 latent pools whole;
      * the host mirrors stay int32 under TP."""
    got, want = served_here(str(tmp_path))
    for name, *_ in ZOO_HERE:
        assert_zoo_case(name, got, want)
    toks, shared = want["prefix"]
    assert shared == 3 * 16
    for res in got:
        assert res["prefix"]["tokens"] == toks
        assert res["prefix"]["shared"] == shared
        rep = res["gqa-w4-grouped"]["report"]
        assert rep["replicated_quant_leaves"] == []
        assert rep["replicated_pool_leaves"] == []
        assert rep["params"]["per_device_bytes"] < \
            rep["params"]["global_bytes"]
        assert rep["kv"]["per_device_bytes"] * 4 == rep["kv"]["global_bytes"]
        pools = res["gqa-w4-grouped"]["pools"]
        whole = res["gqa-w4-grouped"]["whole_pools"]
        assert pools and len(pools) == len(whole)
        for (key, shard), (_, full) in zip(pools, whole):
            hdim = pool_head_dim(key, len(full))
            assert shard[hdim] * 4 == full[hdim]
            assert shard[:hdim] == full[:hdim]
        rep = res["mla-placement"]["report"]
        assert rep["replicated_quant_leaves"] == []
        assert rep["replicated_pool_leaves"] == []
        assert res["mla-placement"]["pools"] == \
            res["mla-placement"]["whole_pools"]
        for job in res.values():
            assert job["cur_len"] == job["last_tok"] == "int32"


# ------------------------------------------------------- refusals (no ranks)

def _mesh_of(tp):
    """Rank 0's view of a ("model",) mesh of ``tp`` ranks; the refusals
    below come before any collective."""
    return Mesh((tp,), ("model",), rank=0, groups={})


def test_tp_grouped_scale_misalignment_raises():
    """A group that leaves partial scale groups on a rank fails at
    placement, before anything is packed: d_ff 128 at tp 4 leaves 32 rows
    of mlp/wo a rank, and groups of 64 straddle ranks."""
    params = init_lm(BASE, seed=0, device="cpu")
    with pytest.raises(ValueError, match="scale groups"):
        ContinuousEngine(BASE, params, n_slots=4, max_len=64, page_size=16,
                         tp=4, mesh=_mesh_of(4), quant_bits=4,
                         quant_group=64, device="cpu")


def test_tp_width_legality_gqa_alignment():
    """Legal widths divide the kv heads (GQA groups stay whole) and the MLP
    hidden dim; MLA is held by its query heads alone; the JAX package's
    answers."""
    assert P.serve_tp_widths(GQA) == [1, 2, 4]
    assert P.serve_tp_widths(GQA.replace(n_kv_heads=1)) == [1]   # MQA
    assert P.serve_tp_widths(MLA) == [1, 2, 4]
    assert 8 in P.serve_tp_widths(GQA.replace(n_kv_heads=8, d_ff=128))


def test_tp_illegal_width_raises():
    params = init_lm(GQA, seed=0, device="cpu")
    with pytest.raises(ValueError, match="legal widths"):
        ContinuousEngine(GQA, params, n_slots=4, max_len=64, tp=3,
                         device="cpu")


def test_tp_without_its_ranks_raises():
    """tp 4 in a process with no process group: no mesh can be built."""
    params = init_lm(GQA, seed=0, device="cpu")
    with pytest.raises(ValueError, match="needs 4 ranks"):
        ContinuousEngine(GQA, params, n_slots=4, max_len=64, tp=4,
                         device="cpu")


@pytest.mark.parametrize("spec", [LayerSpec(kind="attn", mlp="moe"),
                                  LayerSpec(kind="mamba", mlp="none")])
def test_tp_moe_and_ssm_gated(spec):
    """The JAX engine's refusal, word for word, for MoE and SSM blocks."""
    from repro_torch.models.config import Mamba2Config
    cfg = BASE.replace(pattern=(spec,),
                       moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
                       mamba=Mamba2Config(d_state=16, head_dim=16))
    with pytest.raises(NotImplementedError, match="dense attention "
                       "decoders \\(no MoE, no SSM blocks\\)"):
        ContinuousEngine(cfg, init_lm(cfg, seed=0, device="cpu"),
                         n_slots=4, max_len=64, tp=4, mesh=_mesh_of(4),
                         device="cpu")


@pytest.mark.parametrize("kw,msg", [
    (dict(preempt=True), "preempt \\+ tensor-parallel serving is an open "
     "item"),
    (dict(spec_decode=True), "spec_decode is single-device and unshared "
     "for now \\(no tp>1, no prefix_share\\)")])
def test_tp_refuses_preempt_and_spec(kw, msg):
    params = init_lm(GQA, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match=msg):
        ContinuousEngine(GQA, params, n_slots=4, max_len=64, tp=2,
                         mesh=_mesh_of(2), device="cpu", **kw)


# --------------------------------------------------- scheduler TP invariance

def _trace(mod_sched, mod_req, pool, tp):
    sched = mod_sched(3, pool, tp=tp)
    for i, budget in enumerate([16, 16, 24, 8, 40]):
        sched.submit(mod_req(rid=i, prompt=np.zeros(8, np.int32),
                             max_new=budget - 8, arrival=float(i)))
    events = []
    for t in range(10):
        admitted = sched.admit(float(t))
        events.append([(s, r.rid) for s, r in admitted])
        if t == 2 and sched.slots[0] is not None:
            sched.retire(0, float(t))
            events.append(("retire", 0))
    return events


def test_scheduler_page_budget_tp_invariant():
    """The same pool geometry and requests give the same admission trace
    at tp 1 and 4 (the page budget counts tokens; pools split along kv
    heads only), and the JAX scheduler's trace."""
    from repro.serve.kvcache import PagePool as JPagePool
    from repro.serve.kvcache import PageSpec as JPageSpec
    from repro.serve.scheduler import Request as JRequest
    from repro.serve.scheduler import Scheduler as JScheduler

    def port(tp):
        return _trace(Scheduler, Request,
                      PagePool(PageSpec(n_pages=9, page_size=8,
                                        max_pages=4), 3), tp)

    want = _trace(JScheduler, JRequest,
                  JPagePool(JPageSpec(n_pages=9, page_size=8, max_pages=4),
                            3), 1)
    assert port(1) == port(4) == want


def test_engine_host_state_int32_end_to_end():
    """cur_len / last_tok stay int32 through admit, prefill, decode and
    retire (tests/test_tp_serve.py's regression)."""
    eng = ContinuousEngine(BASE, init_lm(BASE, seed=0, device="cpu"),
                           n_slots=2, max_len=64, page_size=16,
                           prefill_bucket=8, device="cpu")
    assert eng.cur_len.dtype == np.int32 and eng.last_tok.dtype == np.int32
    eng.submit(np.arange(8), max_new=4)
    eng.run(max_steps=100)
    assert eng.cur_len.dtype == np.int32 and eng.last_tok.dtype == np.int32


# ------------------------------------ the W8A8 grid and the launcher's --tp

def _amax_rank(rank, world, x):
    """Each rank's per-token activation scale of its column slice, with
    the amax all-reduced over "model", and without."""
    from repro_torch.core.quant.types import quantize_activation
    from repro_torch.distributed.sharding import sharding_ctx

    mesh = make_mesh((world,), ("model",))
    cols = x.shape[1] // world
    xl = torch.from_numpy(x[:, rank * cols:(rank + 1) * cols])
    with sharding_ctx(mesh):
        _, s_tp = quantize_activation(xl, 8, axis_name="model")
    _, s_local = quantize_activation(xl, 8)
    return s_tp.numpy(), s_local.numpy()


def _mesh_rank(rank, world):
    """(tests/test_torch_sharding.py) A (2, 2) ("data", "model") mesh:
    this rank's coordinates, and each axis's collectives of rank + 1."""
    from repro_torch.distributed import collectives as coll
    from repro_torch.distributed.sharding import sharding_ctx

    mesh = make_mesh((2, 2), ("data", "model"))
    with sharding_ctx(mesh):
        x = torch.tensor([float(rank + 1)])
        sums = {a: float(coll.all_reduce(x, a)[0]) for a in mesh.shape}
        idx = {a: coll.axis_index(a) for a in mesh.shape}
        gathered = coll.all_gather(x, "model").tolist()
        a2a = coll.all_to_all(torch.tensor([10. * rank, 10. * rank + 1]),
                              "data").tolist()
    return mesh.coords, idx, sums, gathered, a2a


def _fail_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("planted")
    return rank


def test_w8a8_activation_grid_global_under_tp(tmp_path):
    """A row-parallel W8A8 linear quantizes its activations on the one-
    device grid: the per-token amax is all-reduced over the TP axis, so
    every rank's scale equals the whole row's (exactly). A rank-local amax
    would give another grid (checked: it differs here)."""
    from repro_torch.core.quant.types import quantize_activation

    x = np.random.default_rng(0).standard_normal((4, 64)).astype(np.float32)
    _, want = quantize_activation(torch.from_numpy(x), 8)
    out = run_ranks(_amax_rank, 2, backend="gloo", args=(x,), timeout=120,
                    store_dir=str(tmp_path))
    for s_tp, s_local in out:
        np.testing.assert_array_equal(s_tp, want.numpy())
    assert any(not np.array_equal(s_local, want.numpy())
               for _, s_local in out)


def test_launcher_tp_tokens_match_tp1(tmp_path):
    """``launch.serve --tp 2 --device cpu`` on two gloo ranks (the rank
    function ``main`` spawns, run here under the test's own time limit):
    each rank serves the tp=1 launcher's tokens on the virtual clock, and
    the backend for the CPU is gloo."""
    from repro_torch.launch import serve as launcher
    from repro_torch.launch.spawn import default_backend

    argv = ["--device", "cpu", "--arch", "tiny", "--method", "none",
            "--requests", "4", "--max-new-max", "8", "--virtual-clock"]
    _, report, _ = launcher.main(argv)
    want = [list(r.tokens) for r in report["requests"]]
    assert default_backend("cpu") == "gloo"
    ranks = run_ranks(launcher._rank_main, 2, backend="gloo",
                      args=(argv + ["--tp", "2"],), timeout=240,
                      store_dir=str(tmp_path))
    assert ranks == [want, want]


def test_launcher_refuses_tp_with_the_static_engine():
    from repro_torch.launch import serve as launcher

    with pytest.raises(SystemExit, match="continuous engine only"):
        launcher.parse_args(["--tp", "2", "--engine", "static"])
