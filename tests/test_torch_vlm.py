"""InternVL2-2B's backbone with its stub vision frontend in the port against
the JAX package on the SMOKE config (2 layers, d 64, GQA 4/2, RMSNorm,
RoPE, 8 patch rows): seeded patch embeddings (``ext_embeds``) prepended
to the tokens through ``lm_forward``, ``lm_prefill`` then ``lm_decode`` on
a contiguous cache, ``lm_loss`` (the patch rows not scored), and
``norm_tweak_ptq(ext_embeds=)`` at RTN and GPTQ W4 + NT; and the
launcher's text serving (no patch embeddings, as the JAX launcher serves
it) token for token against the JAX engine. RMSNorm scales are set from a
numpy seed (1 + N(0, 0.02^2)) so that a dropped scale would show."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.normtweak import pipeline as jpipe
from repro.models.transformer import get_block as jget
from repro.models.transformer import init_cache as jinit_cache
from repro.models.transformer import lm_decode as _jdecode
from repro.models.transformer import lm_forward as _jforward
from repro.models.transformer import lm_loss as jloss
from repro.models.transformer import lm_prefill as _jprefill
from repro.serve.engine import ContinuousEngine as JaxEngine
import repro_torch.core.quant.types as tt
from repro_torch.checkpoint.convert import params_from_numpy, params_to_numpy
from repro_torch.core.normtweak import pipeline as tpipe
from repro_torch.kernels import ops
from repro_torch.launch import serve as launcher
from repro_torch.models.transformer import (get_block, init_contiguous_cache,
                                            lm_decode, lm_forward, lm_loss,
                                            lm_prefill)
from repro_torch.utils.tree import tree_get
from test_torch_dense_variants import (jitted, perturbed_numpy, smoke_pair,
                                      to_jax)
from test_torch_dense_variants_pipeline import _code_diff

jprefill, jdecode = jitted(_jprefill), jitted(_jdecode)
jforward = jitted(_jforward)

TCFG, JCFG = smoke_pair("internvl2-2b")
P = JCFG.frontend_len
LINEARS = ("attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wi", "mlp/wg",
           "mlp/wo")
# f32 on both sides, sums in other orders (tests/test_models_consistency.py's
# bar)
ATOL = 2e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tree():
    return perturbed_numpy(JCFG)


def patches_and_tokens(seed=1, b=2, s=12):
    rng = np.random.default_rng(seed)
    ext = (0.3 * rng.normal(size=(b, P, JCFG.d_model))).astype(np.float32)
    return ext, rng.integers(0, JCFG.vocab_size, (b, s)).astype(np.int32)


def test_config_and_init():
    """A vision frontend of ``frontend_len`` patch rows and a plain dense
    decoder: no encoder, no cross-attention."""
    assert TCFG.frontend == "vision" and TCFG.frontend_len == 8
    assert not TCFG.enc_dec
    assert all(not s.cross_attn for s in TCFG.all_layer_specs())


def test_lm_forward_with_patches_matches_jax(tree):
    ext, tokens = patches_and_tokens()
    want = np.asarray(jforward(JCFG, to_jax(tree), jnp.asarray(tokens),
                               ext_embeds=jnp.asarray(ext))[0])
    got = lm_forward(TCFG, params_from_numpy(tree, device="cpu"),
                     torch.from_numpy(tokens),
                     torch.from_numpy(ext))[0].numpy()
    assert got.shape == (2, P + tokens.shape[1], JCFG.vocab_size)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    # the patches reach every token's logits
    plain = lm_forward(TCFG, params_from_numpy(tree, device="cpu"),
                       torch.from_numpy(tokens))[0].numpy()
    assert not np.allclose(plain, got[:, P:], atol=1e-3)


def test_prefill_with_patches_then_decode_match_jax(tree):
    """``lm_prefill(ext_embeds=)`` over the patches and a 7-token prompt,
    then 5 ``lm_decode`` steps at positions P + 7 on, on a contiguous
    cache: each at the JAX forward's logits of the same position, and the
    prefill's at the JAX package's ``lm_prefill``."""
    ext, tokens = patches_and_tokens()
    p = params_from_numpy(tree, device="cpu")
    want = np.asarray(jforward(JCFG, to_jax(tree), jnp.asarray(tokens),
                               ext_embeds=jnp.asarray(ext))[0])
    n0, total = 7, P + tokens.shape[1]
    cache = init_contiguous_cache(TCFG, 2, total, "cpu")
    logits = lm_prefill(TCFG, p, torch.from_numpy(tokens[:, :n0]), cache,
                        ext_embeds=torch.from_numpy(ext))
    jlogits, _ = jprefill(JCFG, to_jax(tree), jnp.asarray(tokens[:, :n0]),
                          jinit_cache(JCFG, 2, total),
                          ext_embeds=jnp.asarray(ext))
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(logits.numpy(), want[:, P + n0 - 1], rtol=0,
                               atol=ATOL)
    for t in range(n0, tokens.shape[1]):
        pos = torch.full((2, 1), P + t, dtype=torch.int32)
        logits = lm_decode(TCFG, p, torch.from_numpy(tokens[:, t:t + 1]),
                           cache, pos)
        np.testing.assert_allclose(logits.numpy(), want[:, P + t], rtol=0,
                                   atol=ATOL)
    # and the JAX package's own decode on its cache agrees
    jc = jinit_cache(JCFG, 2, total)
    _, jc = jprefill(JCFG, to_jax(tree), jnp.asarray(tokens[:, :n0]), jc,
                     ext_embeds=jnp.asarray(ext))
    jl, _ = jdecode(JCFG, to_jax(tree), jnp.asarray(tokens[:, n0:n0 + 1]),
                    jc, jnp.full((2, 1), P + n0, jnp.int32))
    np.testing.assert_allclose(np.asarray(jl), want[:, P + n0], rtol=0,
                               atol=ATOL)


def test_lm_loss_with_patches_matches_jax(tree):
    ext, tokens = patches_and_tokens(3, s=13)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "ext_embeds": ext}
    want, jm = jloss(JCFG, to_jax(tree),
                     {k: jnp.asarray(v) for k, v in batch.items()})
    got, tm = lm_loss(TCFG, params_from_numpy(tree, device="cpu"),
                      {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=1e-6)


@pytest.mark.parametrize("method", ["rtn", "gptq"])
def test_pipeline_with_patches_matches_jax(tree, method, monkeypatch):
    """``norm_tweak_ptq`` on 8 samples of 8 patches and 24 tokens in both
    packages (the port's packed product set to the JAX CPU path's f32
    one). tests/test_torch_dense_variants_pipeline.py's bars: RTN every
    layer's codes >= 99.9% equal, none more than a step apart, ln1 and ln2
    within 1e-2 lr and the losses within 1e-3; GPTQ (f32 row loop in the
    JAX package, f64 in the port) layer 0's codes >= 99% equal, its loss
    within 5% and its norms within a mean of 0.5 lr. Equal layer lrs."""
    rng = np.random.default_rng(5)
    ext = (0.3 * rng.normal(size=(8, P, JCFG.d_model))).astype(np.float32)
    tokens = rng.integers(0, JCFG.vocab_size, (8, 24))
    kw = dict(method=method, bits=4, group_size=32, lr0=1e-3, iters=1,
              sample_batch=4)
    jq, jstats = jpipe.norm_tweak_ptq(JCFG, to_jax(tree), jnp.asarray(tokens),
                                      jpipe.NTConfig(**kw),
                                      ext_embeds=jnp.asarray(ext))
    monkeypatch.setattr(ops, "dequant_matmul",
                        lambda x, qt: torch.matmul(x, tt.dequantize(qt)))
    tq, tstats = tpipe.norm_tweak_ptq(
        TCFG, params_from_numpy(tree, device="cpu"),
        torch.from_numpy(tokens), tpipe.NTConfig(**kw),
        ext_embeds=torch.from_numpy(ext))
    assert tstats["layer_lr"] == jstats["layer_lr"]
    layers = [0] if method == "gptq" else range(JCFG.n_layers)
    if method == "gptq":
        np.testing.assert_allclose(tstats["layer_loss"][0],
                                   jstats["layer_loss"][0], rtol=5e-2)
    else:
        np.testing.assert_allclose(tstats["layer_loss"],
                                   jstats["layer_loss"], rtol=1e-3)
    for li in layers:
        lr = tstats["layer_lr"][li]
        tb = get_block(TCFG, tq, li)
        jb = jax.tree_util.tree_map(np.array, jget(JCFG, jq, li))
        for path in LINEARS:
            diff = _code_diff(tree_get(tb, path)["w"],
                              tree_get(jb, path)["w"])
            if method == "gptq":
                assert (diff == 0).mean() >= 0.99, path
            else:
                assert diff.max() <= 1 and (diff == 0).mean() >= 0.999
        for norm in ("ln1", "ln2"):
            err = np.abs(tb[norm]["scale"].numpy() - jb[norm]["scale"])
            if method == "gptq":
                assert err.mean() <= 0.5 * lr, norm
            else:
                assert err.max() <= 1e-2 * lr, norm


def test_launcher_text_serving_matches_jax_engine(monkeypatch):
    """``--arch internvl2-2b --smoke``: the launcher serves the backbone as
    a text LM (no patch embeddings), as the JAX launcher does; the JAX
    engine on the same float params, geometry and requests gives the same
    tokens."""
    eng, report, _ = launcher.main(
        ["--device", "cpu", "--arch", "internvl2-2b", "--smoke",
         "--method", "none", "--requests", "4", "--prompt-len-max", "20",
         "--max-new-min", "3", "--max-new-max", "6", "--virtual-clock"])
    done = sorted(report["requests"], key=lambda r: r.rid)
    assert len(done) == 4 and all(len(r.tokens) == r.max_new for r in done)
    tree = params_to_numpy(eng.params)
    jeng = JaxEngine(JCFG, to_jax(tree), n_slots=eng.n_slots,
                     max_len=eng.spec.max_len, page_size=eng.spec.page_size,
                     prefill_bucket=eng.prefill_bucket)
    for r in done:
        jeng.submit(np.asarray(r.prompt), max_new=r.max_new,
                    arrival=r.arrival)
    jdone = sorted(jeng.run(max_steps=2000), key=lambda r: r.rid)
    assert [list(r.tokens) for r in done] == [list(r.tokens) for r in jdone]
