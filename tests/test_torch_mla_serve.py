"""deepseek-v2-lite-16b's SMOKE config served by the port (device="cpu")
against the JAX package: greedy tokens of the ContinuousEngine, float and
W4 g32 packed by each engine's deploy, with the same ``prefill_bucket``
and ``prefill_batch`` (an MoE's capacity counts a prefill's padded tokens,
so both must pad and batch alike); the static ServeEngine's; the four
features the JAX engine refuses on MLA refused alike (engine and
launcher); and the launcher's MLA serving run."""
import jax
import numpy as np
import pytest
import torch

from repro.models.transformer import init_lm as jinit
from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeEngine as JaxServe
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from test_torch_dense_variants import perturbed_numpy, smoke_pair, to_jax

ARCH = "deepseek-v2-lite-16b"
TCFG, JCFG = smoke_pair(ARCH)
ENGINE = dict(n_slots=3, max_len=80, page_size=8, prefill_bucket=8,
              prefill_batch=2)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the engine's decode loop issues many small ops;
    see tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return perturbed_numpy(JCFG)


def _requests(vocab):
    """Five requests at staggered arrivals, two arriving together (so a
    prefill call batches two prompts of one bucket)."""
    rng = np.random.default_rng(7)
    return [(rng.integers(0, vocab, t), m, a) for t, m, a in
            ((8, 5, 0.0), (13, 4, 1.0), (11, 6, 1.0), (24, 6, 2.0),
             (5, 5, 3.0))]


def _drive(eng, reqs):
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
    """Paged prefill (non-absorbed, self-attending) and absorbed decode
    over the gathered latent pages, every layer's pools, the prefix
    block's included: the same tokens and counters."""
    if quant:
        # the JAX engine's packed linears on the kernel path (interpret
        # mode): bf16 operands, as in the port
        monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    reqs = _requests(JCFG.vocab_size)
    want, jcount = _drive(JaxEngine(JCFG, to_jax(tree), **ENGINE, **quant),
                          reqs)
    eng = ContinuousEngine(TCFG, params_from_numpy(tree, device="cpu"),
                           device="cpu", **ENGINE, **quant)
    assert sorted(eng.cache) == ["prefix", "stack"]
    got, tcount = _drive(eng, reqs)
    assert got == want, f"{quant} diverged"
    assert tcount == jcount and tcount[1] < len(reqs)


def test_static_engine_matches_jax(tree):
    """The static ServeEngine: a contiguous-cache prefill (non-absorbed)
    then lockstep absorbed decode; greedy tokens equal."""
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, JCFG.vocab_size, (3, 11)).astype(np.int32)
    want = JaxServe(JCFG, to_jax(tree)).generate(prompts, max_new=7)
    got = ServeEngine(TCFG, params_from_numpy(tree, device="cpu"),
                      device="cpu").generate(prompts, max_new=7)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


@pytest.mark.parametrize("kw", [dict(preempt=True), dict(prefix_share=True),
                                dict(chunked_prefill=16),
                                dict(spec_decode=True)])
def test_mla_refusals_match_jax(kw):
    """What the JAX engine refuses on MLA (tests/test_overload.py's and
    tests/test_prefix_cache.py's gates, and speculative decoding), the
    port's engine refuses with the same message, and its launcher exits
    with it before building any params."""
    jp = jinit(JCFG, jax.random.PRNGKey(1))
    geo = dict(n_slots=2, max_len=64, page_size=8)
    with pytest.raises(NotImplementedError) as jerr:
        JaxEngine(JCFG, jp, **geo, **kw)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp),
                           device="cpu")
    with pytest.raises(NotImplementedError) as terr:
        ContinuousEngine(TCFG, tp, device="cpu", **geo, **kw)
    assert str(terr.value) == str(jerr.value)
    flag = {"preempt": ["--preempt"], "prefix_share": ["--prefix-share"],
            "chunked_prefill": ["--chunked-prefill", "16"],
            "spec_decode": ["--spec-decode", "--method", "none"]}[
                next(iter(kw))]
    with pytest.raises(SystemExit, match="no MLA|MLA latent prefill"):
        launcher.main(["--device", "cpu", "--arch", ARCH, "--smoke"] + flag)


def test_launcher_serves_mla_on_cpu():
    """``--arch deepseek-v2-lite-16b --smoke --method none --engine both``:
    both engines serve every request."""
    eng, report, _ = launcher.main(
        ["--device", "cpu", "--arch", ARCH, "--smoke", "--method", "none",
         "--requests", "4", "--prompt-len-max", "20", "--max-new-min", "2",
         "--max-new-max", "6", "--virtual-clock", "--engine", "both"])
    done = report["requests"]
    assert len(done) == 4 and all(len(r.tokens) == r.max_new for r in done)
    assert report["static"]["requests"] == 4
    assert "prefix" in eng.cache
