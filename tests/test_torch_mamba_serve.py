"""mamba2-2.7b's SMOKE config served by the port (device="cpu") against the
JAX package: greedy tokens and counters of the ContinuousEngine, float
and W4 g32 packed by each engine's deploy, with ``prefill_batch`` 2 so a
prefill call carries two prompts whose final states land in their slots'
rows (``paged["slots"]``); the static ServeEngine on the contiguous
cache; the four features the JAX engine refuses on SSM blocks refused
with its messages (engine and launcher); ``snapshot()`` -> ``restore()``
into a fresh engine, the SSM state rows carried; the launcher."""
import numpy as np
import pytest
import torch

from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeEngine as JaxServe
from repro_torch.checkpoint import store as tstore
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from test_torch_dense_variants import smoke_pair, to_jax
from test_torch_mamba import perturbed_mamba_numpy

ARCH = "mamba2-2.7b"
TCFG, JCFG = smoke_pair(ARCH)
ENGINE = dict(n_slots=3, max_len=80, page_size=8, prefill_bucket=8,
              prefill_batch=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (see tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return perturbed_mamba_numpy(JCFG)


def requests(vocab):
    """Six requests at staggered arrivals, two pairs arriving together (so
    a prefill call batches two left-padded prompts of one bucket), prompt
    lengths of several remainders mod the chunk (16) and the bucket."""
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, t), m, a) for t, m, a in
            ((8, 5, 0.0), (13, 4, 1.0), (11, 6, 1.0), (23, 6, 2.0),
             (5, 5, 3.0), (18, 4, 3.0))]


def drive(eng, reqs):
    for prompt, max_new, arrival in reqs:
        eng.submit(prompt, max_new=max_new, arrival=arrival)
    done = eng.run(max_steps=2000)
    assert len(done) == len(reqs) and all(r.done for r in done)
    eng.pool.check_invariants()
    return [list(r.tokens) for r in done], (eng.n_prefill_tokens,
                                            eng.n_prefills,
                                            eng.n_decode_steps)


@pytest.mark.parametrize("quant", [{}, dict(quant_bits=4, quant_group=32)])
def test_engine_tokens_match_jax(tree, quant, monkeypatch):
    """Slot-prefill of co-batched prompts into their rows, then decode
    stepping every slot's state: the same tokens and counters; a prefill
    call carried two prompts; the cache holds no page pool."""
    if quant:
        # the JAX engine's packed linears on the kernel path (interpret
        # mode): bf16 operands, as in the port
        monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    reqs = requests(JCFG.vocab_size)
    want, jcount = drive(JaxEngine(JCFG, to_jax(tree), **ENGINE, **quant),
                         reqs)
    eng = ContinuousEngine(TCFG, params_from_numpy(tree, device="cpu"),
                           device="cpu", **ENGINE, **quant)
    assert sorted(eng.cache["stack"]["p0"]) == ["conv", "len", "state"]
    got, tcount = drive(eng, reqs)
    assert got == want, f"{quant} diverged"
    assert tcount == jcount and tcount[1] < len(reqs)


def test_static_engine_matches_jax(tree):
    """The static ServeEngine: a contiguous-cache prefill that replaces the
    batch's state, then lockstep decode; greedy tokens equal."""
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, JCFG.vocab_size, (3, 19)).astype(np.int32)
    want = JaxServe(JCFG, to_jax(tree)).generate(prompts, max_new=7)
    got = ServeEngine(TCFG, params_from_numpy(tree, device="cpu"),
                      device="cpu").generate(prompts, max_new=7)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


@pytest.mark.parametrize("kw", [dict(preempt=True), dict(prefix_share=True),
                                dict(chunked_prefill=16),
                                dict(spec_decode=True)])
def test_ssm_refusals_match_jax(tree, kw):
    """What the JAX engine refuses on SSM blocks (tests/test_overload.py's
    and tests/test_prefix_cache.py's gates, and speculative decoding), the
    port's engine refuses with the same message, and its launcher exits
    with it before building any params: no quiet fallback to unchunked
    prefill or plain decode."""
    geo = dict(n_slots=2, max_len=64, page_size=8)
    with pytest.raises(NotImplementedError) as jerr:
        JaxEngine(JCFG, to_jax(tree), **geo, **kw)
    with pytest.raises(NotImplementedError) as terr:
        ContinuousEngine(TCFG, params_from_numpy(tree, device="cpu"),
                         device="cpu", **geo, **kw)
    assert str(terr.value) == str(jerr.value)
    assert "no SSM blocks" in str(terr.value) or "SSM recurrence" in str(
        terr.value)
    flag = {"preempt": ["--preempt"], "prefix_share": ["--prefix-share"],
            "chunked_prefill": ["--chunked-prefill", "16"],
            "spec_decode": ["--spec-decode", "--method", "none"]}[
                next(iter(kw))]
    with pytest.raises(SystemExit, match="no SSM blocks|SSM recurrence"):
        launcher.main(["--device", "cpu", "--arch", ARCH, "--smoke"] + flag)


@pytest.mark.parametrize("cut", [3, 6])
def test_snapshot_restore_resumes_the_same_tokens(tree, cut, tmp_path):
    """Snapshot mid-trace (after ``cut`` steps: slots mid-decode, one
    request still queued), restore into a freshly built engine — through
    the disk at the later cut — and finish: the tokens of the
    uninterrupted run. The snapshot carries every SSM leaf (state, conv,
    len) of every slot row."""
    params = params_from_numpy(tree, device="cpu")
    reqs = requests(TCFG.vocab_size)
    ref = ContinuousEngine(TCFG, params, device="cpu", **ENGINE)
    want, _ = drive(ref, reqs)
    eng = ContinuousEngine(TCFG, params, device="cpu", **ENGINE)
    for prompt, max_new, arrival in reqs:
        eng.submit(prompt, max_new=max_new, arrival=arrival)
    for _ in range(cut):
        eng.step(float(eng.t))
        eng.t += 1
    snap = eng.snapshot()
    leaves = snap["cache"]["stack"]["p0"]
    assert sorted(leaves) == ["conv", "len", "state"]
    np.testing.assert_array_equal(
        leaves["state"], eng.cache["stack"]["p0"]["state"].numpy())
    assert np.abs(leaves["state"]).max() > 0
    if cut == 6:
        path = str(tmp_path / "snap")
        tstore.save_snapshot(path, snap)
        snap = tstore.load_snapshot(path)
    fresh = ContinuousEngine(TCFG, params, device="cpu", **ENGINE)
    fresh.restore(snap)
    done = fresh.run(max_steps=2000)
    assert [list(r.tokens) for r in done] == want


def test_launcher_serves_mamba2_on_cpu():
    """``--arch mamba2-2.7b --smoke --method rtn --engine both``: the
    pipeline packs every in_proj / out_proj, both engines serve every
    request."""
    eng, report, stats = launcher.main(
        ["--device", "cpu", "--arch", ARCH, "--smoke", "--method", "rtn",
         "--group-size", "32", "--requests", "4", "--prompt-len-max", "20",
         "--max-new-min", "2", "--max-new-max", "6", "--virtual-clock",
         "--engine", "both"])
    done = report["requests"]
    assert len(done) == 4 and all(len(r.tokens) == r.max_new for r in done)
    assert report["static"]["requests"] == 4
    assert len(stats["layer_loss"]) == TCFG.n_layers
    assert eng.params["stack"]["p0"]["mamba"]["in_proj"]["w"].bits == 4
