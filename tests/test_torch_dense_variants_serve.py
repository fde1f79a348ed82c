"""Greedy tokens of the port's ContinuousEngine (device="cpu") on the dense
variants' SMOKE configs — qwen2-0.5b, chatglm3-6b, granite-20b — equal the
JAX package's ContinuousEngine on the same weights (biases, LayerNorm
biases and norm scales set from a numpy seed) and requests, token for
token: W4 g32 packed by each engine's deploy with f32 KV pools; granite
also with int8 KV pools, and with prefix sharing plus chunked prefill
(later chunks and suffixes read their context, at non-zero position
offsets, through the paged multi-row read)."""
import jax
import numpy as np
import pytest
import torch

from repro.serve.engine import ContinuousEngine as JaxEngine
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.serve.engine import ContinuousEngine
from test_torch_dense_variants import perturbed_numpy, smoke_pair, to_jax

ENGINE = dict(n_slots=3, max_len=80, page_size=8, prefill_bucket=8,
              quant_bits=4, quant_group=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread (the engine's decode loop issues many small ops;
    see tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(vocab, shared):
    """Four requests at staggered arrivals; with ``shared`` each starts
    with the same 32-token system prompt (4 whole pages)."""
    rng = np.random.default_rng(7)
    system = rng.integers(0, vocab, 32 if shared else 0)
    return [(np.concatenate([system, rng.integers(0, vocab, t)]), m, float(i))
            for i, (t, m) in enumerate(((8, 5), (13, 4), (24, 6), (5, 5)))]


def _drive(eng, reqs):
    for prompt, max_new, arrival in reqs:
        eng.submit(prompt, max_new=max_new, arrival=arrival)
    done = eng.run(max_steps=2000)
    assert len(done) == len(reqs) and all(r.done for r in done)
    eng.pool.check_invariants()
    return [list(r.tokens) for r in done], (eng.n_shared_tokens,
                                            eng.n_prefill_tokens,
                                            eng.n_prefills,
                                            eng.n_decode_steps)


@pytest.mark.parametrize("name,variant,extra", [
    ("qwen2-0.5b", {}, {}),
    ("chatglm3-6b", {}, {}),
    ("granite-20b", {}, {}),
    ("granite-20b", {"kv_cache_bits": 8}, {}),
    ("granite-20b", {}, dict(prefix_share=True, chunked_prefill=16)),
])
def test_engine_tokens_match_jax(name, variant, extra, monkeypatch):
    tcfg, jcfg = smoke_pair(name)
    tcfg, jcfg = tcfg.replace(**variant), jcfg.replace(**variant)
    tree = perturbed_numpy(jcfg)
    # the JAX engine's packed linears on the kernel path (interpret mode):
    # bf16 operands as in the port's kernel and plain version
    monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    reqs = _requests(jcfg.vocab_size, shared=bool(extra))
    want, jcount = _drive(JaxEngine(jcfg, to_jax(tree), **ENGINE, **extra),
                          reqs)
    got, tcount = _drive(ContinuousEngine(
        tcfg, params_from_numpy(tree, device="cpu"), device="cpu",
        **ENGINE, **extra), reqs)
    assert got == want, f"{name} {variant} {extra} diverged"
    assert tcount == jcount
    if extra:
        # the system prompt's pages were shared, and prompts of 37-56
        # tokens took more than one 16-token chunk
        assert tcount[0] > 0 and tcount[2] > len(reqs)
