"""The pieces under bf16 compute, on the CPU: the plain versions of
kernels 1, 4 and 2 on bf16 operands against the JAX package's Pallas
kernels in interpret mode (as tests/test_kernels.py::
test_dequant_matmul_dtypes runs them); ``attention_core``'s three options
(``banded``, ``chunked_decode``, ``scores_dtype``) against the JAX
package's, forward and gradient; and the train step's remat policies
("nothing", "dots") against no remat, bit for bit."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.dequant_matmul import dequant_matmul_pallas
from repro.kernels.expert_dequant_matmul import expert_dequant_matmul_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.paged_harness import build_paged_case as jbuild
from repro.kernels.paged_harness import build_verify_case as jbuild_verify
from repro.models.attention import attention_core as jcore
import repro_torch.configs as tc
from repro_torch.core.quant.types import quantize, quantize_stacked
from repro_torch.kernels import paged_harness as ph
from repro_torch.kernels import ref
from repro_torch.models.attention import attention_core
from repro_torch.models.transformer import init_lm, lm_loss
from repro_torch.train.train_step import _grads_of

# one bf16 step of a value v in [2^e, 2^(e+1)) is 2^(e-7): at most 2^-7
# of |v|
BF16_STEP = 2.0 ** -7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np32(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close_bf16(got, want, f32_tol):
    """``got`` bf16 (or f32) against an f32 ``want``: one bf16 step of
    each value besides the f32 order bound."""
    got = got.float().numpy()
    return bool(np.all(np.abs(got - want)
                       <= f32_tol + BF16_STEP * np.abs(want)))


# ------------------------------------------- (b) plain kernels, bf16 inputs

@pytest.mark.parametrize("bits,group", [(4, 16), (4, -1), (3, 32), (8, 32),
                                        (2, 16)])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_dequant_matmul_bf16_x_matches_pallas(bits, group, out_dtype):
    rng = np.random.default_rng(0)
    x32 = rng.normal(size=(16, 64)).astype(np.float32)
    w = (0.1 * rng.normal(size=(64, 32))).astype(np.float32)
    xb = torch.from_numpy(x32).to(torch.bfloat16)
    qt = quantize(torch.from_numpy(w), bits, group)
    want = _np32(dequant_matmul_pallas(
        jnp.asarray(x32).astype(jnp.bfloat16), jnp.asarray(qt.qw.numpy()),
        jnp.asarray(qt.scale.numpy()), bits=bits, group_size=group, bm=16,
        bn=32, bk=32, interpret=True))
    got = ref.dequant_matmul_ref(xb, qt.qw, qt.scale, bits=bits,
                                 group_size=group, k=64, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    # the same bf16 operands: the f32 sums differ in order only
    assert _close_bf16(got, want, 1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_expert_dequant_matmul_bf16_buffer_matches_pallas(out_dtype):
    rng = np.random.default_rng(1)
    x32 = rng.normal(size=(4, 16, 64)).astype(np.float32)
    w = (0.1 * rng.normal(size=(4, 64, 32))).astype(np.float32)
    qt = quantize_stacked(torch.from_numpy(w), 4, 32)
    want = _np32(expert_dequant_matmul_pallas(
        jnp.asarray(x32).astype(jnp.bfloat16), jnp.asarray(qt.qw.numpy()),
        jnp.asarray(qt.scale.numpy()), bits=4, group_size=32, bm=16, bn=32,
        bk=32, interpret=True))
    got = ref.expert_dequant_matmul_ref(
        torch.from_numpy(x32).to(torch.bfloat16), qt.qw, qt.scale, bits=4,
        group_size=32, k=64, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    assert _close_bf16(got, want, 1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("m_rows,window", [(1, None), (1, 20), (4, None),
                                           (3, 20)])
def test_paged_read_on_bf16_pools_matches_pallas(m_rows, window):
    """The harness's bf16 pools (the JAX package's bit for bit) through the
    plain version, q in bf16 and the output in bf16, against the Pallas
    kernel on the JAX pools with the same bf16 q."""
    seed, s, w, ps, kvh, g, hd = 3, 4, 6, 8, 2, 2, 16
    fills = [0, m_rows, 17, 48]
    if m_rows == 1:
        args = (seed, s, w, ps, kvh, g, hd, fills, 16)
        jq, jpools, jbt, jkl = jbuild(*args)
        q, pools, bt, kl = ph.build_paged_case(*args, pools="bf16",
                                               device="cpu")
    else:
        args = (seed, s, m_rows, w, ps, kvh, g, hd, fills, 16)
        jq, jpools, jbt, jkl = jbuild_verify(*args)
        q, pools, bt, kl = ph.build_verify_case(*args, pools="bf16",
                                                device="cpu")
    assert pools["k_pool"].dtype == torch.bfloat16
    assert np.array_equal(pools["k_pool"].float().numpy(),
                          _np32(jpools["k_pool"]))
    qk = ph.kernel_rows(q, kvh).to(torch.bfloat16)
    jqk = jnp.asarray(qk.float().numpy()).astype(jnp.bfloat16)
    want = _np32(paged_attention_pallas(
        jqk, jpools["k_pool"], jpools["v_pool"], jbt, jkl, window=window,
        m_rows=m_rows, interpret=True))
    got = ref.paged_attention_ref(qk, pools["k_pool"], pools["v_pool"], bt,
                                  kl, window=window, m_rows=m_rows,
                                  out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _close_bf16(got, want, 1e-5)


# ---------------------------------------- (c) the attention core's options

def _qkv(seed, b, sq, skv, h, kvh, hd):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=sh).astype(np.float32)
            for sh in ((b, sq, h, hd), (b, skv, kvh, hd), (b, skv, kvh, hd))]


def _positions(b, sq, skv, pad=0):
    kv = np.broadcast_to(np.arange(skv, dtype=np.int32), (b, skv)).copy()
    kv[:, :pad] = -1                       # left pads: never attended
    q = kv[:, skv - sq:]
    return q.copy(), kv


CORE_CASES = [
    # (name, sq, skv, window, opts): banded SWA prefill (sq > 2 window),
    # chunked decode over 3 blocks, bf16 scores through the chunked core
    ("banded", 96, 96, 16, dict(banded=True, block_kv=32)),
    ("banded_pad", 80, 80, 24, dict(banded=True, block_kv=64)),
    ("chunked_decode", 1, 90, None, dict(chunked_decode=True, block_kv=32)),
    ("chunked_decode_window", 1, 90, 40, dict(chunked_decode=True,
                                              block_kv=32)),
    ("bf16_scores", 40, 72, None, dict(scores_dtype="bfloat16",
                                       block_kv=16)),
    ("bf16_scores_window", 40, 72, 24, dict(scores_dtype="bfloat16",
                                            block_kv=16)),
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,sq,skv,window,opts", CORE_CASES)
def test_attention_core_options_match_jax(name, sq, skv, window, opts,
                                          dtype):
    """Forward and the gradient of a weighted sum of the output, q, k and
    v in ``dtype``: f32 within 1e-5, bf16 within a bf16 step of the
    output (and of the gradients' scale)."""
    b, h, kvh, hd = 2, 4, 2, 16
    q, k, v = _qkv(7, b, sq, skv, h, kvh, hd)
    qp, kp = _positions(b, sq, skv, pad=3)
    wts = np.random.default_rng(8).normal(size=(b, sq, h, hd)).astype(
        np.float32)
    jdt = jnp.dtype(dtype)
    tdt = getattr(torch, dtype)
    jopts = dict(opts)
    if "scores_dtype" in jopts:
        jopts["scores_dtype"] = jnp.dtype(jopts["scores_dtype"])
    topts = dict(opts)
    if "scores_dtype" in topts:
        topts["scores_dtype"] = getattr(torch, topts["scores_dtype"])

    def jloss(q_, k_, v_):
        o = jcore(q_, k_, v_, q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kp),
                  causal=True, window=window, **jopts)
        return jnp.sum(o.astype(jnp.float32) * wts), o

    jargs = [jnp.asarray(a).astype(jdt) for a in (q, k, v)]
    (_, jo), jg = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                             has_aux=True))(*jargs)
    targs = [torch.from_numpy(a).to(tdt).requires_grad_(True)
             for a in (q, k, v)]
    to = attention_core(*targs, q_pos=torch.from_numpy(qp),
                        kv_pos=torch.from_numpy(kp), causal=True,
                        window=window, **topts)
    assert to.dtype == tdt
    (to.float() * torch.from_numpy(wts)).sum().backward()
    jo = _np32(jo)
    if dtype == "float32" and "scores_dtype" not in opts:
        ftol, step = 1e-5, 0.0
    else:
        ftol, step = 0.0, BF16_STEP
    scale = float(np.abs(jo).max())
    assert np.abs(to.detach().float().numpy() - jo).max() <= (
        ftol + step) * max(scale, 1.0)
    for ta, ja in zip(targs, jg):
        ja = _np32(ja)
        gscale = max(float(np.abs(ja).max()), 1.0)
        assert np.abs(ta.grad.float().numpy() - ja).max() <= (
            ftol + 4 * step) * gscale, name


def test_banded_attention_equals_the_plain_core():
    """The band is an evaluation order, not a new function: banded and
    unbanded cores agree in f32 within rounding."""
    q, k, v = [torch.from_numpy(a) for a in _qkv(9, 2, 120, 120, 4, 2, 16)]
    qp, kp = [torch.from_numpy(a) for a in _positions(2, 120, 120)]
    kw = dict(q_pos=qp, kv_pos=kp, causal=True, window=20, block_kv=48)
    a = attention_core(q, k, v, banded=True, **kw)
    b = attention_core(q, k, v, **kw)
    assert float((a - b).abs().max()) <= 1e-5


# --------------------------------------------------- (d) the remat policies

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_policies_equal_no_remat(policy, dtype):
    """llama3.2-1b SMOKE's loss and every gradient under each remat policy
    equal those without remat, bit for bit: remat recomputes the same ops
    on the same inputs (the CPU's kernels are deterministic)."""
    base = tc.get_smoke_config("llama3.2-1b").replace(dtype=dtype,
                                                      param_dtype=dtype)
    params = init_lm(base, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, base.vocab_size, (2, 16)).astype(np.int64))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, dims=1)}
    ref_loss, _, ref_g = _grads_of(base.replace(remat=False), lm_loss,
                                   params, batch)
    loss, _, grads = _grads_of(base.replace(remat=True,
                                            remat_policy=policy),
                               lm_loss, params, batch)
    assert torch.equal(loss, ref_loss)

    def leaves(t):
        return ([x for v in t.values() for x in leaves(v)]
                if isinstance(t, dict) else [t])

    assert all(torch.equal(a, b) for a, b in zip(leaves(grads),
                                                 leaves(ref_g)))


def test_remat_dots_saves_the_matmul_outputs(monkeypatch):
    """Under "dots" the selective-checkpoint policy sees the repeat's ops
    and keeps exactly the outputs of the matmuls without a batch dim (mm,
    addmm: every linear) for the backward pass, recomputing the rest (the
    attention core's bmm among them); "nothing" asks no policy."""
    from repro_torch.models import transformer

    seen, policy = [], transformer._save_dots

    def spy(ctx, op, *args, **kwargs):
        decision = policy(ctx, op, *args, **kwargs)
        seen.append((op, decision))
        return decision

    monkeypatch.setattr(transformer, "_save_dots", spy)
    base = tc.get_smoke_config("llama3.2-1b")
    params = init_lm(base, seed=0, device="cpu")
    toks = torch.zeros((2, 16), dtype=torch.int64)
    batch = {"tokens": toks, "labels": toks}
    _grads_of(base.replace(remat_policy="nothing"), lm_loss, params, batch)
    assert not seen
    _grads_of(base.replace(remat_policy="dots"), lm_loss, params, batch)
    saved = {op for op, d in seen if d.name == "MUST_SAVE"}
    assert saved and saved <= set(transformer._DOTS)
    assert torch.ops.aten.bmm.default in {op for op, d in seen
                                          if d.name == "PREFER_RECOMPUTE"}
