"""The port's paged-attention harness (``repro_torch.kernels.
paged_harness``) against the JAX package's (``repro.kernels.
paged_harness``): equal seeds give equal arrays (the JAX float pools are
the draws rounded to bf16, the port's f32 pools the draws themselves,
which round to the JAX pools and are not bf16 values), and the torch
oracles give the JAX oracles' outputs within 1e-5 on the same (bf16-
rounded) pools; the kernel's plain version on ``kernel_rows``'s layout
gives the oracles' live rows."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import paged_harness as jph
from repro_torch.kernels import paged_harness as ph
from repro_torch.kernels import ref

TOL = 1e-5
# (seed, S, W, page, KVH, G, hd, fills, M): ragged fills with an empty
# slot; GQA 4/2 and MQA 8/1
CASES = [(0, 4, 3, 16, 2, 2, 16, [0, 5, 16, 48], 3),
         (7, 3, 4, 8, 1, 8, 32, [32, 9, 0], 4)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return None if x is None else np.asarray(jnp.asarray(x, jnp.float32)
                                             if x.dtype == jnp.bfloat16
                                             else x)


def _t(x):
    return None if x is None else x.cpu().numpy()


def _same_case(port, jax_case, bf16=False):
    """``bf16``: the port's bf16 pools, the JAX package's bit for bit."""
    q, pools, bt, kv_len = port
    jq, jpools, jbt, jkv = jax_case
    np.testing.assert_array_equal(_t(q), _np(jq))
    np.testing.assert_array_equal(_t(bt), _np(jbt))
    np.testing.assert_array_equal(_t(kv_len), _np(jkv))
    for k in ("k_pool", "v_pool", "k_scale_pool", "v_scale_pool"):
        if jpools[k] is None:
            assert pools[k] is None
            continue
        assert pools[k].dtype == (
            torch.int8 if jpools[k].dtype == jnp.int8
            else torch.bfloat16 if bf16 and k in ("k_pool", "v_pool")
            else torch.float32)
        if bf16 and jpools[k].dtype == jnp.bfloat16:
            np.testing.assert_array_equal(_t(pools[k].float()),
                                          _np(jpools[k]))
        elif jpools[k].dtype == jnp.bfloat16:
            # full f32 draws: a kernel that read them as bf16 would differ
            rounded = pools[k].to(torch.bfloat16).float()
            assert not torch.equal(rounded, pools[k])
            np.testing.assert_array_equal(_t(rounded), _np(jpools[k]))
        else:
            np.testing.assert_array_equal(_t(pools[k]), _np(jpools[k]))


def _m_fills(fills, m):
    return [f if f == 0 or f >= m else m for f in fills]


@pytest.mark.parametrize("kv_bits", [8, 16])
@pytest.mark.parametrize("case", CASES)
def test_builders_equal_the_references(case, kv_bits):
    seed, s, w, ps, kvh, g, hd, fills, m = case
    _same_case(ph.build_paged_case(seed, s, w, ps, kvh, g, hd, fills,
                                   kv_bits, device="cpu"),
               jph.build_paged_case(seed, s, w, ps, kvh, g, hd, fills,
                                    kv_bits))
    vf = _m_fills(fills, m)
    _same_case(ph.build_verify_case(seed, s, m, w, ps, kvh, g, hd, vf,
                                    kv_bits, device="cpu"),
               jph.build_verify_case(seed, s, m, w, ps, kvh, g, hd, vf,
                                     kv_bits))
    _same_case(ph.build_prefill_case(seed, s, m, w, ps, kvh, g, hd, fills,
                                     kv_bits, device="cpu"),
               jph.build_prefill_case(seed, s, m, w, ps, kvh, g, hd, fills,
                                      kv_bits))


@pytest.mark.parametrize("case", CASES)
def test_bf16_pools_equal_the_references(case):
    """``pools="bf16"``: the draws rounded to bf16, equal bit for bit to
    the JAX package's bf16 pools for equal seeds (decode, verify and
    prefill builders)."""
    seed, s, w, ps, kvh, g, hd, fills, m = case
    kw = dict(pools="bf16", device="cpu")
    _same_case(ph.build_paged_case(seed, s, w, ps, kvh, g, hd, fills, 16,
                                   **kw),
               jph.build_paged_case(seed, s, w, ps, kvh, g, hd, fills, 16),
               bf16=True)
    vf = _m_fills(fills, m)
    _same_case(ph.build_verify_case(seed, s, m, w, ps, kvh, g, hd, vf, 16,
                                    **kw),
               jph.build_verify_case(seed, s, m, w, ps, kvh, g, hd, vf, 16),
               bf16=True)
    _same_case(ph.build_prefill_case(seed, s, m, w, ps, kvh, g, hd, fills,
                                     16, **kw),
               jph.build_prefill_case(seed, s, m, w, ps, kvh, g, hd, fills,
                                      16), bf16=True)


def _f32(case):
    """A JAX case with its bf16 pools as f32 (the same values): the
    oracles are compared in f32, the port's kernel's type."""
    q, pools, bt, kv_len = case
    pools = {k: v.astype(jnp.float32) if v is not None
             and v.dtype == jnp.bfloat16 else v for k, v in pools.items()}
    return q, pools, bt, kv_len


def _rounded(case):
    """A port case with its f32 pools rounded to bf16 values, the JAX
    case's pools: the oracles are compared on equal inputs."""
    q, pools, bt, kv_len = case
    pools = {k: v.to(torch.bfloat16).float() if v is not None
             and v.dtype == torch.float32 and k in ("k_pool", "v_pool")
             else v for k, v in pools.items()}
    return q, pools, bt, kv_len


@pytest.mark.parametrize("case,kv_bits,window",
                         [(CASES[0], 16, None), (CASES[1], 8, 20)])
def test_oracles_equal_the_references(case, kv_bits, window):
    seed, s, w, ps, kvh, g, hd, fills, m = case
    live = np.asarray(fills) > 0
    args = (seed, s, w, ps, kvh, g, hd, fills, kv_bits)
    got = ph.gather_oracle(*_rounded(ph.build_paged_case(*args,
                                                         device="cpu")),
                           window)
    want = jph.gather_oracle(*_f32(jph.build_paged_case(*args)), window)
    np.testing.assert_allclose(_t(got)[live], _np(want)[live], atol=TOL,
                               rtol=0)
    vf = _m_fills(fills, m)
    args = (seed, s, m, w, ps, kvh, g, hd, vf, kv_bits)
    got = ph.verify_oracle(*_rounded(ph.build_verify_case(*args,
                                                          device="cpu")),
                           window)
    want = jph.verify_oracle(*_f32(jph.build_verify_case(*args)), window)
    live = np.asarray(vf) > 0
    np.testing.assert_allclose(_t(got)[live], _np(want)[live], atol=TOL,
                               rtol=0)
    chunk = [min(f, m) for f in fills]
    args = (seed, s, m, w, ps, kvh, g, hd, fills, kv_bits)
    got = ph.prefill_oracle(*_rounded(ph.build_prefill_case(*args,
                                                            device="cpu")),
                            window, chunk)
    want = jph.prefill_oracle(*_f32(jph.build_prefill_case(*args)), window,
                              chunk)
    rows = ph.prefill_live_rows(torch.tensor(fills), chunk, m)
    np.testing.assert_array_equal(
        rows, jph.prefill_live_rows(np.asarray(fills), chunk, m))
    np.testing.assert_allclose(_t(got)[rows], _np(want)[rows], atol=TOL,
                               rtol=0)


@pytest.mark.parametrize("kv_bits", [8, 16])
def test_kernel_rows_layout_reads_as_the_oracles(kv_bits):
    """The kernel's plain version on ``kernel_rows``'s layout gives the
    oracles' outputs on every live row (decode and multi-row reads): the
    layout the tuner's search and ``chip_smoke.py`` launch the kernel on."""
    seed, s, w, ps, kvh, g, hd, fills, m = CASES[0]
    q, pools, bt, kv_len = ph.build_paged_case(seed, s, w, ps, kvh, g, hd,
                                               fills, kv_bits, device="cpu")
    out = ref.paged_attention_ref(ph.kernel_rows(q, kvh), pools["k_pool"],
                                  pools["v_pool"], bt, kv_len,
                                  pools["k_scale_pool"],
                                  pools["v_scale_pool"])
    got = out.reshape(s, kvh * g, hd)
    want = ph.gather_oracle(q, pools, bt, kv_len, None)
    live = kv_len > 0
    torch.testing.assert_close(got[live], want[live], atol=TOL, rtol=0)
    q, pools, bt, kv_len = ph.build_prefill_case(seed, s, m, w, ps, kvh, g,
                                                 hd, fills, kv_bits,
                                                 device="cpu")
    out = ref.paged_attention_ref(ph.kernel_rows(q, kvh), pools["k_pool"],
                                  pools["v_pool"], bt, kv_len,
                                  pools["k_scale_pool"],
                                  pools["v_scale_pool"], m_rows=m)
    got = out.reshape(s, kvh, m, g, hd).permute(0, 2, 1, 3, 4).reshape(
        s, m, kvh * g, hd)
    chunk = [min(f, m) for f in fills]
    want = ph.prefill_oracle(q, pools, bt, kv_len, None, chunk)
    rows = torch.from_numpy(ph.prefill_live_rows(kv_len, chunk, m))
    torch.testing.assert_close(got[rows], want[rows], atol=TOL, rtol=0)
    # rows at fill positions <= 0 read nothing: exact zeros
    lim = kv_len[:, None] - m + 1 + torch.arange(m)[None]
    assert torch.all(got[lim <= 0] == 0)


def test_cases_own_their_pools():
    """The builders share one draw between cases of one geometry; a caller
    that writes into its pools leaves the next case's as drawn."""
    seed, s, w, ps, kvh, g, hd, fills, m = CASES[0]
    args = (seed, s, w, ps, kvh, g, hd, fills, 16)
    first = ph.build_paged_case(*args, device="cpu")
    want = first[1]["k_pool"].clone()
    first[1]["k_pool"].zero_()
    first[1]["v_pool"].zero_()
    again = ph.build_paged_case(*args, device="cpu")
    assert torch.equal(again[1]["k_pool"], want)
    _same_case(again, jph.build_paged_case(*args))


def test_f32_pools_catch_a_bf16_load():
    """At llama3.2-1b's decode read (8 slots, kv heads 8, G 4, hd 64,
    pages of 16, a 20-page table) the plain version over the pools
    rounded to bf16 is further than the card check's 1e-4 from the plain
    version over the f32 pools: a kernel that loaded K or V as bf16 fails
    that check on these pools."""
    fills = [0, 1, 16, 37, 100, 256, 300, 320]
    q, pools, bt, kv_len = ph.build_paged_case(0, 8, 20, 16, 8, 4, 64, fills,
                                               16, device="cpu")
    q = ph.kernel_rows(q, 8)
    exact = ref.paged_attention_ref(q, pools["k_pool"], pools["v_pool"], bt,
                                    kv_len, None, None)
    bf = {k: pools[k].to(torch.bfloat16).float() for k in ("k_pool",
                                                            "v_pool")}
    loaded = ref.paged_attention_ref(q, bf["k_pool"], bf["v_pool"], bt,
                                     kv_len, None, None)
    assert float((loaded - exact).abs().max()) > 1e-4
