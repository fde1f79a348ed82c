"""Greedy tokens of the port's ContinuousEngine (device="cpu") equal the JAX
package's ContinuousEngine on the same weights and requests, token for
token, and the page pool is whole again after every run."""
import jax
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.models.transformer import init_lm as jinit
from repro.serve.engine import ContinuousEngine as JaxEngine
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.models.transformer import init_lm
from repro_torch.serve.engine import ContinuousEngine
from repro_torch.serve.sampling import sample

# tests/test_continuous_batching.py's CFG in both packages
SHRINK = dict(n_repeats=2, d_model=64, head_dim=16, d_ff=128)
JCFG = jc.TINY.replace(**SHRINK)
TCFG = tc.TINY.replace(**SHRINK)

# 16 requests / 8 slots, prompts 8-64, staggered arrivals (the JAX package's
# continuous-batching workload)
WORKLOAD = [(8, 6), (16, 4), (32, 8), (64, 5)] * 4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: the engine's decode loop issues many small ops,
    which several test processes' thread pools would contend for (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _serve_both(variant, reqs, engine_kw, quant=None, monkeypatch=None,
                base=(JCFG, TCFG)):
    jcfg = base[0].replace(**variant)
    tcfg = base[1].replace(**variant)
    params = jinit(jcfg, jax.random.PRNGKey(0))
    kw = dict(engine_kw)
    if quant:
        kw.update(quant_bits=quant[0], quant_group=quant[1])
        if len(quant) > 2:
            kw.update(act_bits=quant[2])
        # the JAX engine's packed linears on the kernel path (interpret
        # mode): bf16 operands as in the port's kernel and plain version
        monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    jeng = JaxEngine(jcfg, params, **kw)
    teng = ContinuousEngine(tcfg, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, params), device="cpu"),
        device="cpu", **kw)
    out = []
    for eng in (jeng, teng):
        for prompt, max_new, arrival in reqs:
            eng.submit(prompt, max_new=max_new, arrival=arrival)
        done = eng.run(max_steps=2000)
        assert len(done) == len(reqs) and all(r.done for r in done)
        assert eng.pool.n_free == eng.spec.n_pages - 1
        eng.pool.check_invariants()
        out.append([list(r.tokens) for r in done])
    return out


def test_staggered_workload_matches_jax():
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, JCFG.vocab_size, plen), max_new, float(i % 5))
            for i, (plen, max_new) in enumerate(WORKLOAD)]
    want, got = _serve_both({}, reqs, dict(n_slots=8, max_len=128,
                                           page_size=16, prefill_bucket=8))
    assert got == want


# the dense, GQA (group 2), sliding-window and int8-KV variants of the JAX
# package's fused paged-attention token-equivalence test, plus W4 g32
# packed weights
@pytest.mark.parametrize("name,variant,quant", [
    ("dense", {}, None),
    ("gqa", {"n_kv_heads": 2}, None),
    ("swa", {"attn_window": 12}, None),
    ("int8-kv", {"kv_cache_bits": 8}, None),
    ("w4-g32", {}, (4, 32)),
])
def test_fused_paged_variants_match_jax(name, variant, quant, monkeypatch):
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, JCFG.vocab_size, plen), max_new, float(i % 2))
            for i, (plen, max_new) in enumerate([(8, 5), (13, 6), (24, 4)])]
    want, got = _serve_both(variant, reqs,
                            dict(n_slots=3, max_len=64, page_size=8,
                                 prefill_bucket=8),
                            quant=quant, monkeypatch=monkeypatch)
    assert got == want, f"{name} diverged"


def _moe_bases():
    """(name, (JAX cfg, port cfg)): Mixtral SMOKE, and the W4 MoE of the
    JAX package's quantized-MoE serving test (tests/test_continuous_
    batching.py: the shrunk TINY with 4 experts top-2 at capacity factor
    1.0)."""
    from repro.models.config import LayerSpec as JSpec
    from repro.models.config import MoEConfig as JMoE
    from repro_torch.models.config import LayerSpec as TSpec
    from repro_torch.models.config import MoEConfig as TMoE

    moe = dict(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=1.0)
    return {"mixtral": (jc.get_smoke_config("mixtral-8x22b"),
                        tc.get_smoke_config("mixtral-8x22b")),
            "tiny-moe": (JCFG.replace(pattern=(JSpec(mlp="moe"),),
                                      moe=JMoE(**moe)),
                         TCFG.replace(pattern=(TSpec(mlp="moe"),),
                                      moe=TMoE(**moe)))}


# MoE serving: Mixtral SMOKE float (prompts co-batched in prefill, so the
# bucket-padded batch decides capacity on both sides), the JAX package's
# W4 g32 MoE (one prompt a prefill), int8 KV, and RTN W4A8 through
# act_bits=8 (the expert W8A8 path). The port's engine is held against
# the JAX ContinuousEngine with the same bucket and prefill batch: MoE
# capacity counts the padded tokens of a prefill batch, so an engine that
# pads differently (the static ServeEngine) may drop other tokens
@pytest.mark.parametrize("name,base,variant,quant,prefill_batch", [
    ("mixtral-float", "mixtral", {}, None, 8),
    ("tiny-moe-w4-g32", "tiny-moe", {}, (4, 32), 1),
    ("mixtral-int8-kv", "mixtral", {"kv_cache_bits": 8}, None, 1),
    ("mixtral-w4a8", "mixtral", {}, (4, 32, 8), 1),
])
def test_moe_serving_matches_jax(name, base, variant, quant, prefill_batch,
                                 monkeypatch):
    jcfg, tcfg = _moe_bases()[base]
    rng = np.random.default_rng(3)
    reqs = [(rng.integers(0, jcfg.vocab_size, plen), max_new, float(i % 2))
            for i, (plen, max_new) in enumerate([(8, 4), (12, 5), (16, 3),
                                                 (9, 4)])]
    want, got = _serve_both(variant, reqs,
                            dict(n_slots=3, max_len=64, page_size=8,
                                 prefill_bucket=8,
                                 prefill_batch=prefill_batch),
                            quant=quant, monkeypatch=monkeypatch,
                            base=(jcfg, tcfg))
    assert got == want, f"{name} diverged"


def test_admission_blocks_when_pool_exhausted():
    """More slots than pages: FIFO admission waits for pages (the JAX
    package's test of the same name, on the port)."""
    params = init_lm(TCFG, seed=0, device="cpu")
    # two concurrent budgets of 16 tokens = 2 pages of 8, plus scratch
    n_pages = 1 + 2 * 2
    eng = ContinuousEngine(TCFG, params, n_slots=4, max_len=16, page_size=8,
                           n_pages=n_pages, prefill_bucket=8,
                           decode_block=1, device="cpu")
    rng = np.random.default_rng(1)
    for _ in range(5):
        eng.submit(rng.integers(0, TCFG.vocab_size, 8), max_new=8)
    max_concurrent, steps = 0, 0
    while not eng.sched.all_done():
        eng.step(float(steps))
        max_concurrent = max(max_concurrent, len(eng.sched.active_slots()))
        eng.pool.check_invariants()
        steps += 1
        assert steps < 500
    assert max_concurrent == 2
    assert len(eng.sched.finished) == 5
    assert eng.pool.n_free == n_pages - 1


def test_sampling_temperature_top_k():
    """temperature/top-k draw only among the k largest logits, with
    frequencies near the softmax of logits / temperature."""
    logits = torch.tensor([[2.0, 1.0, 0.5, -1.0, -3.0]]).repeat(4000, 1)
    gen = torch.Generator().manual_seed(0)
    toks = sample(logits, temperature=0.7, top_k=3, generator=gen)
    assert toks.dtype == torch.int32 and set(toks.tolist()) <= {0, 1, 2}
    want = torch.softmax(logits[0, :3] / 0.7, dim=-1)
    freq = torch.bincount(toks.long(), minlength=3)[:3].float() / 4000
    # 4000 draws: binomial standard error <= 0.008
    assert torch.allclose(freq, want, atol=0.04)
    assert torch.equal(sample(logits[:2], temperature=0.0),
                       torch.zeros(2, dtype=torch.int32))
