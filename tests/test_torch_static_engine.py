"""The port's static-batch ServeEngine against the JAX package's: greedy
tokens of ``generate`` equal (float and W4 g32 weights, plain and
sliding-window attention, with and without an EOS), ``score`` within
1e-4, and the launcher's ``--engine both`` and ``--engine static`` on the
CPU."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.models.transformer import init_lm as jinit
from repro.serve.engine import ServeEngine as JaxServe
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.serve.engine import ContinuousEngine, ServeEngine

SHRINK = dict(n_repeats=2, d_model=64, head_dim=16, d_ff=128)
JCFG = jc.TINY.replace(**SHRINK)
TCFG = tc.TINY.replace(**SHRINK)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (several test processes share the machine)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(variant, quant=None, monkeypatch=None, eos_id=-1):
    jcfg, tcfg = JCFG.replace(**variant), TCFG.replace(**variant)
    p = jinit(jcfg, jax.random.PRNGKey(0))
    kw = dict(eos_id=eos_id)
    if quant:
        kw.update(quant_bits=quant[0], quant_group=quant[1])
        # the JAX engine's packed linears on the kernel path (interpret
        # mode): bf16 operands, as in the port
        monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, p),
                           device="cpu")
    return (JaxServe(jcfg, p, **kw),
            ServeEngine(tcfg, tp, device="cpu", **kw), tcfg, tp)


@pytest.mark.parametrize("name,variant,quant", [
    ("float", {}, None),
    ("swa", {"attn_window": 12}, None),
    ("w4-g32", {}, (4, 32)),
])
def test_generate_matches_jax(name, variant, quant, monkeypatch):
    jeng, teng, _, _ = _both(variant, quant, monkeypatch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, JCFG.vocab_size, (3, 11)).astype(np.int32)
    want = jeng.generate(prompts, max_new=9)
    got = teng.generate(prompts, max_new=9)
    assert got.tokens.shape == (3, 9) and got.n_prompt == 11
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


def test_generate_eos_and_continuous_agree():
    """With an EOS id, a row that emits it emits it from then on (as in
    the JAX engine); without one, the static engine's greedy tokens equal
    the continuous engine's (prefill bucket 1: no padding)."""
    _, teng, tcfg, tp = _both({})
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, JCFG.vocab_size, (4, 8)).astype(np.int32)
    free = teng.generate(prompts, max_new=8).tokens
    eos = int(free[0, 2])
    jeng_eos, teng_eos, _, _ = _both({}, eos_id=eos)
    got = teng_eos.generate(prompts, max_new=8).tokens
    np.testing.assert_array_equal(
        got, np.asarray(jeng_eos.generate(prompts, max_new=8).tokens))
    assert np.all(got[0, 2:] == eos)
    cont = ContinuousEngine(tcfg, tp, n_slots=4, max_len=32, page_size=8,
                            prefill_bucket=1, device="cpu")
    for p in prompts:
        cont.submit(p, max_new=8)
    done = cont.run(max_steps=200)
    np.testing.assert_array_equal(np.asarray([r.tokens for r in done]),
                                  free)


@pytest.mark.parametrize("quant", [None, (4, 32)])
def test_score_matches_jax(quant, monkeypatch):
    jeng, teng, _, _ = _both({}, quant, monkeypatch)
    rng = np.random.default_rng(2)
    toks = rng.integers(0, JCFG.vocab_size, (2, 17)).astype(np.int32)
    want = np.asarray(jeng.score(toks))
    got = teng.score(toks)
    assert got.shape == (2, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


LAUNCH = ["--device", "cpu", "--arch", "tiny", "--requests", "5",
          "--prompt-len-max", "20", "--max-new-min", "2", "--max-new-max", "6",
          "--virtual-clock", "--method", "none"]


def test_launcher_engine_both_on_cpu(capsys):
    eng, report, _ = launcher.main(LAUNCH + ["--engine", "both"])
    assert isinstance(eng, ContinuousEngine)
    assert report["static"]["requests"] == 5
    assert report["static"]["tokens"] == sum(
        r.max_new for r in report["requests"])
    out = capsys.readouterr().out
    assert "continuous: 5 requests" in out and "static: 5 requests" in out


def test_launcher_engine_static_on_cpu(capsys):
    eng, report, _ = launcher.main(LAUNCH + ["--engine", "static"])
    assert isinstance(eng, ServeEngine) and report["requests"] == 5
    assert "continuous:" not in capsys.readouterr().out
