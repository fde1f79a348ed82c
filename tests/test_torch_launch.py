"""The port's traffic harness and serving launcher: traces identical to the
JAX package's, the launcher's pipeline end to end on the CPU, its prefix
sharing, chunked prefill and speculative serving on the CPU, refusals of
later slices' flags, and greedy W4A8 serving equal to the JAX engine's on
the same norm-tweaked weights."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.models.transformer import init_lm as jinit
from repro.serve import traffic as jtraffic
from repro.serve.engine import ContinuousEngine as JaxEngine
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.quant.blockquant import iter_linears
from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.launch import serve as launcher
from repro_torch.serve import traffic
from repro_torch.serve.engine import ContinuousEngine


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread while this file runs. GPTQ's row loop (and the
    engine's decode loop) issues thousands of small ops; when several test
    processes share the machine, each op's thread-pool barrier waits on
    descheduled threads (the launcher's TINY GPTQ pipeline on an 8-core
    CPU: 3.6 s alone; 915 s each for six processes at the default thread
    count, 2 s each with one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["poisson", "bursty", "uniform"])
def test_traces_match_jax(kind, seed):
    kw = dict(kind=kind, n=24, rate=3.0, seed=seed, vocab_size=512,
              prompt_len=(4, 40), max_new=(2, 30), batch_frac=0.25,
              shared_prefix=5 if seed else 0,
              deadline=7.5 if seed else None)
    want = jtraffic.make_trace(**kw)
    got = traffic.make_trace(**kw)
    assert len(got) == len(want) == 24
    for a, b in zip(got, want):
        assert (a.arrival, a.max_new, a.priority, a.deadline) == (
            b.arrival, b.max_new, b.priority, b.deadline)
        np.testing.assert_array_equal(a.prompt, b.prompt)


LAUNCH = ["--device", "cpu", "--arch", "tiny", "--requests", "5",
          "--prompt-len-max", "20", "--max-new-min", "2", "--max-new-max", "6",
          "--virtual-clock"]


@pytest.mark.parametrize("method", ["gptq", "smoothquant"])
def test_launcher_runs_the_pipeline_on_cpu(method, capsys):
    eng, report, stats = launcher.main(LAUNCH + ["--method", method])
    act_bits = 8 if method == "smoothquant" else 0
    linears = list(iter_linears(eng.params["stack"]["p0"]))
    assert linears == []           # every linear is packed (not a tensor)
    for sub in ("attn", "mlp"):
        for lin in eng.params["stack"]["p0"][sub].values():
            w = lin["w"]
            assert isinstance(w, QuantizedTensor)
            assert w.act_bits == act_bits and w.shape[0] == 8
    assert len(stats["layer_loss"]) == 8
    assert all(np.isfinite(stats["layer_loss"]))
    done = report["requests"]
    assert len(done) == 5 and all(r.done and not r.rejected for r in done)
    assert all(len(r.tokens) == r.max_new for r in done)
    out = capsys.readouterr().out
    assert "layer 8/8 done (tweaked)" in out and "overall" in out


@pytest.mark.parametrize("method", ["gptq", "smoothquant"])
def test_launcher_runs_mixtral_on_cpu(method):
    """``--arch mixtral-8x22b --smoke``: the pipeline reaches the expert
    stacks (packed, with the method's act_bits, for both layers) and the
    engine serves every request; routers stay float."""
    eng, report, stats = launcher.main(
        ["--device", "cpu", "--arch", "mixtral-8x22b", "--smoke",
         "--requests", "4", "--prompt-len-max", "20", "--max-new-min", "2",
         "--max-new-max", "6", "--virtual-clock", "--method", method])
    act_bits = 8 if method == "smoothquant" else 0
    moe = eng.params["stack"]["p0"]["moe"]
    for name in ("wi", "wg", "wo"):
        w = moe["experts"][name]["w"]
        assert isinstance(w, QuantizedTensor) and w.act_bits == act_bits
        assert w.qw.shape[:2] == (2, 4) and w.shape[:2] == (2, 4)
    assert not isinstance(moe["router"]["w"], QuantizedTensor)
    assert len(stats["layer_loss"]) == 2
    assert all(np.isfinite(stats["layer_loss"]))
    done = report["requests"]
    assert len(done) == 4 and all(len(r.tokens) == r.max_new for r in done)


@pytest.mark.parametrize("flags,slice_name", [
    # --tp is ported (tests/test_torch_tp_serve.py); what stays refused is
    # what the JAX launcher refuses: TP with the static engine
    (["--tp", "2", "--engine", "static"], "continuous engine only"),
    (["--tp", "2", "--engine", "both"], "continuous engine only"),
])
def test_launcher_refuses_later_slices(flags, slice_name):
    with pytest.raises(SystemExit, match=slice_name):
        launcher.parse_args(LAUNCH + flags)


# bursts of about two requests, 6 steps apart, 2 slots: a batch request
# still decodes when the next burst's interactive one arrives
OVERLOAD = ["--device", "cpu", "--arch", "tiny", "--method", "none",
            "--requests", "8", "--prompt-len-max", "20", "--max-new-min",
            "8", "--max-new-max", "16", "--slots", "2", "--trace", "bursty",
            "--rate", "1.0", "--burst-len", "0.3", "--idle-len", "6.0",
            "--virtual-clock"]


@pytest.mark.parametrize("flags,line", [
    (["--preempt", "--age-promote", "16"], "overload"),
    (["--deadline", "6"], "shd/cxl"),
    (["--faults", "3"], "resilient: "),
    (["--snapshot-every", "4"], "resilient: 0 crash(es)"),
])
def test_launcher_accepts_overload_and_fault_flags(flags, line, capsys):
    """Each flag of the overload and faults slice reaches the engine and
    the report: preemption and aging, deadlines, a seeded fault plan with
    its crash recovered, periodic snapshots."""
    eng, report, _ = launcher.main(OVERLOAD + flags)
    out = capsys.readouterr().out
    assert line in out
    done = report["requests"]
    assert len(done) == 8 and all(r.done for r in done)
    eng.pool.check_invariants()
    if "--preempt" in flags:
        assert eng.preempt and eng.sched.age_promote == 16.0
        assert report["scheduler"]["n_preemptions"] >= 1
        assert all(len(r.tokens) == r.max_new for r in done)
    if "--deadline" in flags:
        assert all(r.deadline == r.arrival + 6.0 for r in done)
        assert report["overall"]["n_shed"] + \
            report["overall"]["n_cancelled"] >= 1
    if "--faults" in flags:
        assert report["faults"]["n_faults_applied"] >= 1
        assert "crash(es) recovered" in out and "fault plan" in out


def test_launcher_serves_with_prefix_sharing_and_chunks(capsys):
    """``--prefix-share --chunked-prefill 16 --shared-prefix 16``: after the
    two-wave warm-up the index is cleared, and with arrivals spread over
    the virtual clock every request after the first reuses the 16-token
    system prompt's page and prefills only the rest."""
    eng, report, _ = launcher.main(
        LAUNCH + ["--method", "none", "--prefix-share", "--chunked-prefill",
                  "16", "--shared-prefix", "16", "--rate", "0.5",
                  "--trace", "uniform"])
    done = report["requests"]
    assert len(done) == 5 and all(len(r.tokens) == r.max_new for r in done)
    assert eng.prefix_share and eng.chunk_tokens == 16
    assert [r.n_shared for r in done] == [0] + [16] * 4
    assert eng.n_shared_tokens == 16 * 4
    assert eng.n_prefill_tokens + eng.n_shared_tokens == sum(
        r.n_prompt for r in done)
    eng.pool.check_invariants()
    out = capsys.readouterr().out
    assert "(2 waves)" in out
    assert "64 reused from the prefix cache" in out


def test_launcher_serves_speculatively(capsys):
    """``--spec-decode --method none``: the engine packs a W3 draft of the
    float params and the report gives the acceptance counters."""
    eng, report, stats = launcher.main(
        LAUNCH + ["--method", "none", "--spec-decode", "--draft-bits", "3",
                  "--spec-k", "2"])
    assert stats is None and eng.spec_decode and eng.spec_k == 2
    assert all(isinstance(lin["w"], QuantizedTensor) and lin["w"].bits == 3
               for sub in ("attn", "mlp")
               for lin in eng.draft_params["stack"]["p0"][sub].values())
    done = report["requests"]
    assert all(len(r.tokens) == r.max_new for r in done)
    st = eng.spec_stats()
    assert st["emitted_tokens"] == sum(len(r.tokens) for r in done) - 5
    out = capsys.readouterr().out
    assert "draft tokens proposed" in out and "accepted len" in out


def test_launcher_refuses_spec_on_a_pipeline():
    """The pipeline hands back packed weights, and the draft is packed from
    the float params: --spec-decode needs --method none."""
    with pytest.raises(SystemExit, match="--method none"):
        launcher.parse_args(LAUNCH + ["--spec-decode", "--method", "gptq"])
    with pytest.raises(SystemExit):
        launcher.parse_args(LAUNCH + ["--spec-decode", "--method", "none",
                                      "--draft-bits", "4"])


# tests/test_torch_engine.py's shrunken TINY in both packages
SHRINK = dict(n_repeats=2, d_model=64, head_dim=16, d_ff=128)


def test_convert_carries_act_bits_and_pipeline_stacking():
    """The JAX pipeline restacks per-layer packed leaves with each layer's
    (K, N) as the static shape; the port's leaf gets its layer dim from the
    codes, and act_bits comes across."""
    from repro.core.quant.types import quantize as jquantize
    from repro.utils.tree import tree_stack as jtree_stack

    w = np.random.default_rng(0).normal(size=(2, 64, 32)).astype(np.float32)
    stacked = jtree_stack([{"w": jquantize(jnp.asarray(wi), 4, 16,
                                           act_bits=8)} for wi in w])
    assert stacked["w"].shape == (64, 32)
    got = params_from_numpy(jax.tree_util.tree_map(np.asarray, stacked),
                            device="cpu")["w"]
    assert got.shape == (2, 64, 32) and got.act_bits == 8
    assert got[1].shape == (64, 32) and got[1].act_bits == 8
    np.testing.assert_array_equal(got.qw.numpy(),
                                  np.asarray(stacked["w"].qw))


def test_convert_carries_pipeline_stacked_experts():
    """A JAX pipeline's restacked packed experts: per layer an (E, K, N)
    static shape, codes (L, E, packed_rows(K), N); the port's leaf is
    (L, E, K, N) and a layer of it is the block's expert stack."""
    from repro.core.quant.types import quantize_stacked as jquantize
    from repro.utils.tree import tree_stack as jtree_stack

    w = np.random.default_rng(0).normal(size=(2, 4, 64, 32)).astype(
        np.float32)
    stacked = jtree_stack([{"w": jquantize(jnp.asarray(wi), 4, 32)}
                           for wi in w])
    got = params_from_numpy(jax.tree_util.tree_map(np.asarray, stacked),
                            device="cpu")["w"]
    assert got.shape == (2, 4, 64, 32) and got.qw.shape == (2, 4, 32, 32)
    assert got[1].shape == (4, 64, 32)
    np.testing.assert_array_equal(got.qw.numpy(),
                                  np.asarray(stacked["w"].qw))


def test_w4a8_engine_matches_jax():
    """W4A8 weights packed by the JAX package, carried across: the port's
    ContinuousEngine (plain versions) serves the same greedy tokens as the
    JAX engine (its CPU path: the same per-token int8 quantization and
    exact integer products)."""
    jcfg = jc.TINY.replace(**SHRINK)
    tcfg = tc.TINY.replace(**SHRINK)
    kw = dict(n_slots=4, max_len=64, page_size=8, prefill_bucket=8)
    jeng = JaxEngine(jcfg, jinit(jcfg, jax.random.PRNGKey(0)), quant_bits=4,
                     quant_group=32, act_bits=8, **kw)
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                       jeng.params),
                                device="cpu")
    assert tparams["stack"]["p0"]["mlp"]["wo"]["w"].act_bits == 8
    rng = np.random.default_rng(1)
    reqs = [(rng.integers(0, jcfg.vocab_size, int(rng.integers(5, 17))),
             int(rng.integers(3, 10))) for _ in range(8)]
    out = []
    for eng in (jeng, ContinuousEngine(tcfg, tparams, device="cpu", **kw)):
        for prompt, max_new in reqs:
            eng.submit(prompt, max_new=max_new)
        done = eng.run(max_steps=2000)
        assert len(done) == len(reqs)
        out.append([list(r.tokens) for r in done])
    assert out[1] == out[0]
