"""The port's compile-count sanitizer (``repro_torch.analysis.sanitize``):
the three cases of ``tests/test_sanitize.py`` on the port (the counters'
gate and budget, and the seeded bursty trace replayed twice adding zero
events), each compile-like site counting once per key, the CLI on the
CPU, and the engine's debug default from the flags."""
import numpy as np
import pytest
import torch

from repro_torch.analysis import sanitize
from repro_torch.configs import TINY
from repro_torch.kernels import autotune, build
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.traffic import make_trace, replay

CFG = TINY.replace(**sanitize.CLI_MODEL)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the engine's decode loop issues many small ops,
    which several test processes' thread pools would contend for (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for k in ("RTORCH_SANITIZE", "RTORCH_DEBUG", "RTORCH_AUTOTUNE",
              "RTORCH_AUTOTUNE_CACHE"):
        monkeypatch.delenv(k, raising=False)
    sanitize.reset_trace_counts()
    yield
    sanitize.reset_trace_counts()


@pytest.fixture(scope="module")
def tiny_lm():
    return init_lm(CFG, seed=0, device="cpu")


def test_note_trace_is_gated_by_env(monkeypatch):
    sanitize.note_trace("op", bucket=16)
    assert sanitize.trace_counts() == {}
    monkeypatch.setenv("RTORCH_SANITIZE", "1")
    sanitize.note_trace("op", bucket=16)
    sanitize.note_trace("op", bucket=16)
    sanitize.note_trace("op", bucket=32)
    counts = sanitize.trace_counts()
    assert counts[("op", (("bucket", 16),))] == 2
    assert counts[("op", (("bucket", 32),))] == 1


def test_new_traces_and_budget(monkeypatch):
    monkeypatch.setenv("RTORCH_SANITIZE", "1")
    sanitize.note_trace("op", bucket=16)
    base = sanitize.trace_counts()
    assert sanitize.new_traces(base) == {}
    sanitize.note_trace("op", bucket=16)
    assert sanitize.new_traces(base) == {("op", (("bucket", 16),)): 1}
    assert sanitize.budget_violations(max_per_key=1) == {
        ("op", (("bucket", 16),)): 2}
    assert sanitize.budget_violations(max_per_key=2) == {}


def test_seeded_replay_twice_adds_zero_events(monkeypatch, tiny_lm):
    """The seeded bursty trace through a fresh engine twice: the second
    replay adds no engine variant, no key is over its budget, and the two
    replays agree token for token."""
    monkeypatch.setenv("RTORCH_SANITIZE", "1")
    trace = make_trace(kind="bursty", n=16, seed=0,
                       vocab_size=CFG.vocab_size)
    eng = ContinuousEngine(CFG, tiny_lm, n_slots=4, device="cpu")
    rep1 = replay(eng, trace)
    baseline = sanitize.trace_counts()
    eng2 = ContinuousEngine(CFG, tiny_lm, n_slots=4, device="cpu")
    rep2 = replay(eng2, trace)
    assert sanitize.new_traces(baseline) == {}, \
        sanitize.format_report(baseline)
    assert sanitize.budget_violations(max_per_key=1) == {}, \
        sanitize.format_report()
    for a, b in zip(rep1["requests"], rep2["requests"]):
        np.testing.assert_array_equal(np.asarray(a.tokens),
                                      np.asarray(b.tokens))


def test_engine_variants_count_once_per_process(monkeypatch, tiny_lm):
    """A variant counts the first time any engine runs it, as a JAX jit
    compiles once per process: reset counts, replay again, nothing new;
    a new shape bucket (more slots) is a new variant."""
    monkeypatch.setenv("RTORCH_SANITIZE", "1")
    trace = make_trace(kind="bursty", n=6, seed=1,
                       vocab_size=CFG.vocab_size)
    replay(ContinuousEngine(CFG, tiny_lm, n_slots=4, device="cpu"), trace)
    sanitize.reset_trace_counts()
    replay(ContinuousEngine(CFG, tiny_lm, n_slots=4, device="cpu"), trace)
    assert sanitize.trace_counts() == {}
    replay(ContinuousEngine(CFG, tiny_lm, n_slots=3, device="cpu"), trace)
    names = {name for name, _ in sanitize.trace_counts()}
    assert "paged_decode_scan" in names
    assert all(dict(key).get("slots", 3) == 3
               for name, key in sanitize.trace_counts()
               if name == "paged_decode_scan")


def test_planner_misses_and_kernel_loads_count_once(monkeypatch):
    """A planner cache miss is one event per shape; ``autotune.reset``
    clears the cache, so the same shape again goes over its budget. A
    kernel library loads once a process."""
    monkeypatch.setenv("RTORCH_SANITIZE", "1")
    autotune.reset()
    for _ in range(3):
        autotune.dense_plan("dequant_matmul", 8, 2048, 2048, 4, 16)
        autotune.paged_split(8, 8, 20, 16, 4, 64, 64, "f32")
    counts = sanitize.trace_counts()
    assert sorted(counts.values()) == [1, 1]
    assert {dict(k)["kernel"] for _, k in counts} == {"dequant_matmul",
                                                      "paged_attention"}
    autotune.reset()
    autotune.dense_plan("dequant_matmul", 8, 2048, 2048, 4, 16)
    assert list(sanitize.budget_violations().values()) == [2]
    autotune.reset()

    sanitize.reset_trace_counts()
    monkeypatch.setattr(build, "_loaded", {})
    monkeypatch.setattr(build, "build", lambda names: [])
    monkeypatch.setattr(build, "_open", lambda name, path: object())
    for _ in range(2):
        build.load("paged_attention")
    assert sanitize.trace_counts() == {
        ("kernel_load", (("library", "paged_attention"),)): 1}


def test_cli_on_the_cpu(capsys, monkeypatch):
    monkeypatch.setenv("RTORCH_SANITIZE", "1")   # main's own default
    assert sanitize.main(["--device", "cpu", "--requests", "8"]) == 0
    out = capsys.readouterr().out
    assert "sanitize: OK" in out and "paged_prefill" in out


def test_engine_debug_defaults_to_the_flag(monkeypatch, tiny_lm):
    assert ContinuousEngine(CFG, tiny_lm, device="cpu").debug is False
    monkeypatch.setenv("RTORCH_DEBUG", "1")
    assert ContinuousEngine(CFG, tiny_lm, device="cpu").debug is True
    assert ContinuousEngine(CFG, tiny_lm, device="cpu",
                            debug=False).debug is False
