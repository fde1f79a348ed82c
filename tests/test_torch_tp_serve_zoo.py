"""The rest of tests/test_tp_serve.py's ``ZOO`` through the port's
tensor-parallel engine (int8 KV, W8A8, W3A8 and MLA float and W4), every
rank's greedy tokens equal to the JAX engine's at tp=1, in one spawn of
four ``gloo`` ranks, and its fused-vs-gather case. Helpers and the first
four cases: tests/test_torch_tp_serve.py (pytest's default import mode
puts tests/ on the path)."""
import functools

from test_torch_tp_serve import (ZOO, assert_zoo_case, jax_params,
                                 jax_tokens, pair, prompts, run_beside,
                                 zoo_jobs)

ZOO_REST = ZOO[4:]


def test_tp_zoo_matches_jax(tmp_path):
    """int8 KV W4 at tp 4; W8A8 and W3A8 at tp 2 (kernel 3's plain
    version, the activation amax all-reduced over the TP axis); MLA float
    and W4 at tp 2 (wq / wukv / wo split, wdkv and the latent pools
    whole): every rank's tokens equal the JAX engine's at tp=1. The
    int8-KV case is tests/test_tp_serve.py's fused-vs-gather config too:
    the port has one read (the fused kernel's plain version) on head-split
    int8 pools, and its tokens also equal the JAX engine's gather read's
    (the JAX engine's default read is the fused one)."""
    jobs, refs = zoo_jobs(ZOO_REST)
    name, base, changes, _, kw = ZOO_REST[0]
    assert name == "gqa-int8kv-w4"
    tcfg, jcfg = pair(base, changes)
    params, _ = jax_params(jcfg)
    refs["gather"] = functools.partial(
        jax_tokens, jcfg, params, kw, prompts(tcfg.vocab_size),
        paged_attn="gather")
    got, want = run_beside(jobs, refs, str(tmp_path))
    assert want["gather"] == want[name]
    for name, *_ in ZOO_REST:
        assert_zoo_case(name, got, want)
    for res in got:
        rep = res["mla-w4"]["report"]
        assert rep["replicated_quant_leaves"] == []
        assert rep["replicated_pool_leaves"] == []
