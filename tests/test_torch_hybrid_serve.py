"""jamba-1.5-large-398b's SMOKE config (one period of eight layers: mamba
and attention blocks, dense MLPs and a 4-expert MoE on every other
layer) served by the port (device="cpu") against the JAX package. The
engine's cache holds the attention layer's page pools and every mamba
layer's slot rows in one tree. Greedy tokens of the ContinuousEngine at
the JAX package's own hybrid case (tests/test_continuous_batching.py:
``prefill_bucket=1, prefill_batch=1``), float and W4 g32, and with
co-batched prefills; the static ServeEngine; the refusals; the
launcher."""
import numpy as np
import pytest
import torch

from repro.serve.engine import ContinuousEngine as JaxEngine
from repro.serve.engine import ServeEngine as JaxServe
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.launch import serve as launcher
from repro_torch.serve.engine import ContinuousEngine, ServeEngine
from test_torch_dense_variants import smoke_pair, to_jax
from test_torch_mamba import perturbed_mamba_numpy
from test_torch_mamba_serve import drive, requests

ARCH = "jamba-1.5-large-398b"
TCFG, JCFG = smoke_pair(ARCH)
GEO = dict(n_slots=3, max_len=64, page_size=8)


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


@pytest.mark.parametrize("case", [
    dict(prefill_bucket=1, prefill_batch=1),
    dict(prefill_bucket=1, prefill_batch=1, quant_bits=4, quant_group=32),
    dict(prefill_bucket=8, prefill_batch=2),
], ids=["reference_case", "reference_case_w4", "cobatched"])
def test_engine_tokens_match_jax(tree, case, monkeypatch):
    """The same tokens and counters as the JAX engine: the reference's
    case (one prompt a prefill call, no pads), packed W4 g32, and
    left-padded prompts batched two a call (the MoE's capacity counts
    the call's tokens alike in both packages)."""
    if "quant_bits" in case:
        monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    reqs = requests(JCFG.vocab_size)
    want, jcount = drive(JaxEngine(JCFG, to_jax(tree), **GEO, **case), reqs)
    eng = ContinuousEngine(TCFG, params_from_numpy(tree, device="cpu"),
                           device="cpu", **GEO, **case)
    kinds = {j: sp.kind for j, sp in enumerate(TCFG.pattern)}
    for j, kind in kinds.items():
        leaves = eng.cache["stack"][f"p{j}"]
        assert ("state" in leaves) == (kind == "mamba")
        assert ("k_pool" in leaves) == (kind == "attn")
    got, tcount = drive(eng, reqs)
    assert got == want, f"{case} diverged"
    assert tcount == jcount


def test_static_engine_matches_jax(tree):
    """The static ServeEngine on the contiguous caches (KV for the
    attention layer, state rows for the mamba layers): greedy tokens
    equal."""
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, JCFG.vocab_size, (2, 13)).astype(np.int32)
    want = JaxServe(JCFG, to_jax(tree)).generate(prompts, max_new=6)
    got = ServeEngine(TCFG, params_from_numpy(tree, device="cpu"),
                      device="cpu").generate(prompts, max_new=6)
    np.testing.assert_array_equal(got.tokens, np.asarray(want.tokens))


@pytest.mark.parametrize("kw", [dict(preempt=True), dict(prefix_share=True),
                                dict(chunked_prefill=16),
                                dict(spec_decode=True)])
def test_hybrid_refusals_match_jax(tree, kw):
    """The hybrid has one attention layer, and still every feature that
    would resume from pages or rewind is refused, with the JAX engine's
    message (spec_decode: the SSM message before the MoE one)."""
    with pytest.raises(NotImplementedError) as jerr:
        JaxEngine(JCFG, to_jax(tree), **GEO, **kw)
    with pytest.raises(NotImplementedError) as terr:
        ContinuousEngine(TCFG, params_from_numpy(tree, device="cpu"),
                         device="cpu", **GEO, **kw)
    assert str(terr.value) == str(jerr.value)


def test_launcher_serves_jamba_on_cpu():
    """``--arch jamba-1.5-large-398b --smoke --method gptq`` (group 32): the
    pipeline tweaks all eight layers, the engine serves every request."""
    eng, report, stats = launcher.main(
        ["--device", "cpu", "--arch", ARCH, "--smoke", "--method", "gptq",
         "--group-size", "32", "--requests", "4", "--prompt-len-max", "20",
         "--max-new-min", "2", "--max-new-max", "6", "--virtual-clock",
         "--prefill-bucket", "1"])
    done = report["requests"]
    assert len(done) == 4 and all(len(r.tokens) == r.max_new for r in done)
    assert len(stats["layer_loss"]) == TCFG.n_layers == 8
