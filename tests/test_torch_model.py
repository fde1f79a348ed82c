"""Port's LM forward against the JAX package's on the same weights: seeded
JAX params carried across with ``params_from_numpy``, float and packed
(W4/W3/W2), on TINY and on the llama3.2-1b SMOKE config (GQA 4/2, hd 16).
Plus the port's own paged prefill + decode against its forward."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jc
from repro.core.quant.deploy import quantize_params_for_serving as jquant
from repro.models.transformer import init_lm as jinit
from repro.models.transformer import lm_forward as jforward
import repro_torch.configs as tc
from repro_torch.checkpoint.convert import params_from_numpy
from repro_torch.core.quant.deploy import quantize_params_for_serving
from repro_torch.core.quant.types import QuantizedTensor
from repro_torch.models.transformer import (init_cache, init_lm, lm_decode,
                                            lm_forward, lm_prefill)
from repro_torch.serve.kvcache import PageSpec

ARCHS = {"tiny": (tc.TINY, jc.TINY),
         "llama3.2-1b-smoke": (tc.get_smoke_config("llama3.2-1b"),
                               jc.get_smoke_config("llama3.2-1b"))}
# (bits, group): 128 falls back to per-channel on both models (K = 192 /
# 576 on TINY, 64 / 160 on SMOKE are not multiples of 128)
QUANTS = [(0, 0), (4, 128), (4, 32), (3, 32), (2, 32)]


@pytest.fixture(scope="module")
def jax_params():
    return {name: jinit(jcfg, jax.random.PRNGKey(0))
            for name, (_, jcfg) in ARCHS.items()}


@pytest.mark.parametrize("bits,group", QUANTS)
@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_forward_matches_jax(arch, bits, group, jax_params, monkeypatch):
    tcfg, jcfg = ARCHS[arch]
    params = jax_params[arch]
    if bits:
        params = jquant(jcfg, params, bits=bits, group_size=group)
        # the JAX package's quantized linears on the kernel path (the
        # Pallas kernel in interpret mode): bf16 operands, f32 sums — the
        # function the port's kernel and its plain version compute
        monkeypatch.setenv("REPRO_DEQUANT_IMPL", "pallas")
    tokens = np.random.default_rng(1).integers(0, jcfg.vocab_size, (2, 24))
    want, _ = jforward(jcfg, params, jnp.asarray(tokens, jnp.int32))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                                device="cpu")
    got = lm_forward(tcfg, tparams, torch.from_numpy(tokens)).numpy()
    err = np.abs(got - np.asarray(want))
    if not bits:
        # f32 on both sides, sums in another order: ~2e-6 measured on
        # logits of rms ~0.3
        assert err.max() <= 1e-5
    else:
        # packed linears round their inputs to bf16. A last-ulp f32
        # difference (the norm's sum order) flips one input's rounding,
        # moving that term by 2^-8 relative; the changed hidden state then
        # flips more roundings downstream, so differences cascade with
        # depth: measured up to 7.8e-3 (mean 1.0e-3) on TINY at W2, 2e-7
        # on SMOKE. Each linear alone agrees to 1e-5 of its terms on equal
        # inputs (tests/test_torch_kernels.py)
        assert err.max() <= 2e-2 and err.mean() <= 2e-3


@pytest.mark.parametrize("arch", list(ARCHS))
def test_port_packing_runs_in_jax_and_back(arch, jax_params):
    """The port packs the same bytes the JAX package does for every linear,
    so trees packed by either package serve in the other."""
    tcfg, jcfg = ARCHS[arch]
    jq = jquant(jcfg, jax_params[arch], bits=4, group_size=32)
    tq = quantize_params_for_serving(
        tcfg, params_from_numpy(jax.tree_util.tree_map(
            np.asarray, jax_params[arch]), device="cpu"),
        bits=4, group_size=32, device="cpu")
    from_jax = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq),
                                 device="cpu")
    for name in ("wq", "wk", "wv", "wo"):
        a = tq["stack"]["p0"]["attn"][name]["w"]
        b = from_jax["stack"]["p0"]["attn"][name]["w"]
        assert isinstance(a, QuantizedTensor) and a.shape == b.shape
        assert torch.equal(a.qw, b.qw) and torch.equal(a.scale, b.scale)
    for name in ("wi", "wg", "wo"):
        a = tq["stack"]["p0"]["mlp"][name]["w"]
        b = from_jax["stack"]["p0"]["mlp"][name]["w"]
        assert torch.equal(a.qw, b.qw) and torch.equal(a.scale, b.scale)
    assert torch.equal(tq["embed"]["w"], from_jax["embed"]["w"])


@pytest.mark.parametrize("bits", [0, 4])
@pytest.mark.parametrize("kv_bits", [0, 8])
def test_prefill_decode_matches_forward(bits, kv_bits):
    """Paged prefill of a left-padded prompt then one paged decode step give
    the forward's logits at the same positions."""
    cfg = tc.get_smoke_config("llama3.2-1b").replace(kv_cache_bits=kv_bits)
    params = init_lm(cfg, seed=0, device="cpu")
    if bits:
        params = quantize_params_for_serving(cfg, params, bits=bits,
                                             group_size=32, device="cpu")
    b, s, pad = 2, 21, 3
    tokens = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (b, s)))
    logits = lm_forward(cfg, params, tokens)
    spec = PageSpec(n_pages=9, page_size=8, max_pages=4)
    cache = init_cache(cfg, spec, "cpu")
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    ptoks = torch.cat([torch.zeros((b, pad), dtype=tokens.dtype),
                       tokens[:, :s - 1]], dim=1)
    pos = torch.cat([torch.full((b, pad), -1, dtype=torch.int32),
                     torch.arange(s - 1, dtype=torch.int32).expand(b, -1)],
                    dim=1)
    lg_pre = lm_prefill(cfg, params, ptoks, cache, pos, {"bt_rows": bt})
    clen = torch.full((b,), s - 1, dtype=torch.int32)
    paged = {"block_table": bt, "write_page": bt[:, (s - 1) // 8],
             "write_off": clen % 8, "kv_len": clen + 1}
    lg_dec = lm_decode(cfg, params, tokens[:, s - 1:], cache, clen[:, None],
                       paged)
    # prefill attends to the unquantized prompt K/V, so it matches the
    # forward to f32 rounding; the decode step reads the cache, which int8
    # pools hold to ~0.4% per element
    torch.testing.assert_close(lg_pre, logits[:, s - 2], rtol=0, atol=2e-4)
    atol = 2e-2 if kv_bits else 2e-4
    torch.testing.assert_close(lg_dec, logits[:, s - 1], rtol=0, atol=atol)
