"""The port's plain kernel versions against the JAX package's Pallas kernels
run in interpret mode (and against its jnp oracles), on inputs made with
numpy from a seed. The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py); here their wrappers must refuse
CPU tensors rather than compute anything."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.quant import types as jt
from repro.kernels import ref as jref
from repro.kernels.dequant_matmul import dequant_matmul_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.paged_harness import (build_paged_case,
                                        build_prefill_case,
                                        build_verify_case)
from repro_torch.core.quant import types as tt
from repro_torch.kernels import ops, ref
from repro_torch.kernels.channel_stats import channel_stats_cuda
from repro_torch.kernels.dequant_matmul import (STREAM, TILE_K,
                                                dequant_matmul_cuda, plan)
from repro_torch.kernels.expert_dequant_matmul import STAGE_K
from repro_torch.kernels.expert_dequant_matmul import (
    expert_dequant_matmul_cuda)
from repro_torch.kernels.expert_w8a8_matmul import expert_w8a8_matmul_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda
from repro_torch.kernels.quantize_pack import quantize_pack_cuda
from repro_torch.kernels.w8a8_matmul import w8a8_matmul_cuda

# (M, K, N): the llama3.2-1b linears' (K, N) pairs scaled to TINY
# (d 192, d_ff 576) and to the llama3.2-1b SMOKE config (d 64, kv 32,
# d_ff 160), at a decode M (8) and a prefill M (40, ragged)
MATMUL_SHAPES = [(8, 192, 192), (40, 192, 576), (8, 576, 192),
                 (8, 64, 64), (40, 64, 32), (8, 64, 160), (40, 160, 64)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: several test processes share the cores, and
    their thread pools would contend for them (see
    tests/test_torch_normtweak.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _dequant_inputs(m, k, n, bits, group, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(m, k)).astype(np.float32)
    w = (rng.normal(size=(k, n)) * 0.05).astype(np.float32)
    qj = jt.quantize(jnp.asarray(w), bits, group)
    return x, np.array(qj.qw), np.array(qj.scale)


@pytest.mark.parametrize("bits,group", [(4, 32), (4, -1), (2, 32), (3, 32),
                                        (8, -1), (3, -1)])
@pytest.mark.parametrize("shape", MATMUL_SHAPES)
def test_dequant_matmul_ref_matches_pallas(shape, bits, group):
    m, k, n = shape
    x, qw, scale = _dequant_inputs(m, k, n, bits, group, seed=m + k + n)
    y_t = ops.dequant_matmul(torch.from_numpy(x), tt.QuantizedTensor(
        torch.from_numpy(qw), torch.from_numpy(scale), bits, group, (k, n)))
    # bk = 32 walks several K tiles, so the Pallas kernel accumulates
    y_p = np.asarray(dequant_matmul_pallas(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(scale), bits=bits,
        group_size=group, bm=m, bn=n, bk=32, interpret=True))
    y_r = np.asarray(jref.dequant_matmul_ref(
        jnp.asarray(x), jnp.asarray(qw), jnp.asarray(scale), bits=bits,
        group_size=group, k=k))
    # every product bf16 x bf16 is exact in f32 on all three sides, so they
    # differ only in the order of the f32 sum: a few ulps of the sum of
    # |terms|; 1e-5 of that bound is far below any wrong operand or scale
    wq = np.asarray(jt.dequantize(jt.QuantizedTensor(
        jnp.asarray(qw), jnp.asarray(scale), bits, group, (k, n))))
    bound = np.abs(x) @ np.abs(wq)
    tol = 1e-5 * bound.max()
    assert np.abs(y_t.numpy() - y_p).max() <= tol
    assert np.abs(y_t.numpy() - y_r).max() <= tol


# (S, W, page, KVH, G, hd, fills, window, kv_bits, m_rows): an empty slot
# (all -1 table row), a page-boundary fill and ragged fills, GQA 4 and MHA,
# head dims 64 (llama3.2-1b), 48 (TINY) and 16 (SMOKE), sliding windows
# that skip whole pages, f32 and int8 pools, decode (m_rows 1) and
# multi-row reads (m_rows 3, 4). W exceeds every fill, so each table also
# holds -1 entries past its pages.
PAGED_CASES = [
    (3, 4, 8, 2, 4, 64, [0, 8, 27], None, 0, 1),
    (3, 4, 8, 2, 4, 64, [0, 8, 27], None, 8, 1),
    (2, 3, 16, 8, 4, 64, [37, 5], None, 8, 1),
    (2, 5, 8, 4, 1, 48, [30, 13], None, 0, 1),
    (2, 6, 8, 2, 2, 16, [45, 20], 12, 8, 1),
    (3, 4, 8, 2, 4, 64, [0, 9, 30], None, 0, 4),
    (3, 4, 8, 2, 4, 64, [0, 9, 30], None, 8, 4),
    (2, 6, 8, 2, 2, 16, [45, 20], 12, 0, 3),
]


def _pools_f32(pools):
    """The port's pools: f32 values (the harness's bf16 pools convert
    exactly) or int8 with f32 scale pools."""
    out = {}
    for key, val in pools.items():
        if val is None:
            out[key] = None
        elif val.dtype == jnp.int8:
            out[key] = torch.from_numpy(np.array(val))
        else:
            out[key] = torch.from_numpy(np.array(val.astype(jnp.float32)))
    return out


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_attention_ref_matches_pallas(case):
    s, w, ps, kvh, g, hd, fills, window, kv_bits, m = case
    if m == 1:
        q, pools, bt, kv_len = build_paged_case(11, s, w, ps, kvh, g, hd,
                                                fills, kv_bits)
        qg = q.reshape(s, kvh, g, hd)
    else:
        q, pools, bt, kv_len = build_verify_case(11, s, m, w, ps, kvh, g,
                                                 hd, fills, kv_bits)
        qg = q.reshape(s, m, kvh, g, hd).transpose(0, 2, 1, 3, 4).reshape(
            s, kvh, m * g, hd)
    o_p = np.asarray(paged_attention_pallas(
        qg, pools["k_pool"], pools["v_pool"], bt, kv_len,
        pools["k_scale_pool"], pools["v_scale_pool"], window=window,
        m_rows=m, interpret=True))
    o_r = np.asarray(jref.paged_attention_ref(
        qg, pools["k_pool"], pools["v_pool"], bt, kv_len,
        pools["k_scale_pool"], pools["v_scale_pool"], window=window,
        m_rows=m))
    tp = _pools_f32(pools)
    args = (tp["k_pool"], tp["v_pool"], torch.from_numpy(np.array(bt)),
            torch.from_numpy(np.array(kv_len)))
    kw = dict(k_scale_pool=tp["k_scale_pool"],
              v_scale_pool=tp["v_scale_pool"], window=window)
    if m == 1:
        o_t = ops.paged_attention(torch.from_numpy(np.array(q)), *args, **kw)
        o_t = o_t.numpy().reshape(s, kvh, g, -1)
    else:
        o_t = ops.paged_rows_read(torch.from_numpy(np.array(q)), *args, **kw)
        o_t = o_t.numpy().reshape(s, m, kvh, g, -1).transpose(
            0, 2, 1, 3, 4).reshape(s, kvh, m * g, -1)
    # same page order and f32 online-softmax updates on both sides; the
    # outputs are convex combinations of O(1) values, and the dot products
    # and exps differ only in rounding (~1e-7): 2e-5 absolute
    np.testing.assert_allclose(o_t, o_p, rtol=0, atol=2e-5)
    np.testing.assert_allclose(o_t, o_r, rtol=0, atol=2e-5)
    # an empty slot is exact zeros, not NaN
    for si, f in enumerate(fills):
        if f == 0:
            assert np.all(o_t[si] == 0.0)


# (S, W, page, KVH, G, hd, fills, window, kv_bits, M, pallas): the verify
# rows (M 2, 3, 5: spec_k 1, 2, 4) and chunk rows (M 16, 64) of the
# engine's reads, with fills below M (a chunk padded past its prompt: rows
# at fill positions < 0, which read nothing and come out as zeros), an
# empty slot, windows, f32 and int8 pools. Pallas interpret runs the
# smaller cases (it walks each row chunk in Python); the JAX package's
# jnp page walk runs all of them
MULTI_ROW_CASES = [
    (3, 4, 8, 2, 4, 64, [0, 2, 27], None, 0, 2, True),
    (3, 4, 8, 2, 4, 64, [0, 1, 30], None, 8, 3, True),
    (2, 6, 8, 2, 2, 16, [45, 4], 12, 8, 5, True),
    (3, 4, 16, 2, 4, 64, [0, 9, 40], None, 0, 16, True),
    (3, 6, 16, 2, 4, 64, [5, 64, 90], None, 8, 64, False),
    (2, 8, 16, 2, 2, 16, [30, 128], 24, 0, 64, False),
]


@pytest.mark.parametrize("read", ["verify", "prefill"])
@pytest.mark.parametrize("case", MULTI_ROW_CASES)
def test_multi_row_reads_match_jax(case, read):
    """``paged_attention_verify`` / ``paged_attention_prefill`` (the engine's
    (S, M, H, hd) reads) against the JAX package's page walk and, where
    cheap, Pallas interpret; rows whose fill limit is <= 0 and empty slots
    are exact zeros on every side."""
    s, w, ps, kvh, g, hd, fills, window, kv_bits, m, pallas = case
    q, pools, bt, kv_len = build_prefill_case(5, s, m, w, ps, kvh, g, hd,
                                              fills, kv_bits)
    qg = q.reshape(s, m, kvh, g, hd).transpose(0, 2, 1, 3, 4).reshape(
        s, kvh, m * g, hd)
    jargs = (qg, pools["k_pool"], pools["v_pool"], bt, kv_len,
             pools["k_scale_pool"], pools["v_scale_pool"])
    want = [np.asarray(jref.paged_attention_ref(*jargs, window=window,
                                                m_rows=m))]
    if pallas:
        want.append(np.asarray(paged_attention_pallas(
            *jargs, window=window, m_rows=m, interpret=True)))
    tp = _pools_f32(pools)
    fn = (ops.paged_attention_verify if read == "verify"
          else ops.paged_attention_prefill)
    o = fn(torch.from_numpy(np.array(q)), tp["k_pool"], tp["v_pool"],
           torch.from_numpy(np.array(bt)), torch.from_numpy(np.array(kv_len)),
           k_scale_pool=tp["k_scale_pool"], v_scale_pool=tp["v_scale_pool"],
           window=window).numpy()
    assert o.shape == (s, m, kvh * g, hd)
    o_g = o.reshape(s, m, kvh, g, hd).transpose(0, 2, 1, 3, 4).reshape(
        s, kvh, m * g, hd)
    for w_ in want:
        # as test_paged_attention_ref_matches_pallas: 2e-5 absolute
        np.testing.assert_allclose(o_g, w_, rtol=0, atol=2e-5)
    for si, f in enumerate(fills):
        dead = np.arange(m) < m - f          # fill position < 0
        assert np.all(o[si, dead] == 0.0)
    assert ops.launch_counts()["paged_attention"] == 0


def test_cuda_wrappers_refuse_cpu_tensors():
    """No CPU path behind the CUDA wrappers: a CPU tensor is refused."""
    x, qw, scale = _dequant_inputs(8, 64, 32, 4, 32, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        dequant_matmul_cuda(torch.from_numpy(x), torch.from_numpy(qw),
                            torch.from_numpy(scale), bits=4, group_size=32,
                            k=64)
    with pytest.raises(ValueError, match="CUDA"):
        paged_attention_cuda(torch.zeros(1, 1, 1, 16),
                             torch.zeros(2, 8, 1, 16),
                             torch.zeros(2, 8, 1, 16),
                             torch.zeros(1, 1, dtype=torch.int32),
                             torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        w8a8_matmul_cuda(torch.zeros((8, 64), dtype=torch.int8),
                         torch.from_numpy(qw), torch.from_numpy(scale),
                         bits=4, group_size=32, k=64)
    eq, es = torch.from_numpy(qw)[None], torch.from_numpy(scale)[None]
    with pytest.raises(ValueError, match="CUDA"):
        expert_dequant_matmul_cuda(torch.zeros((1, 8, 64)), eq, es, bits=4,
                                   group_size=32, k=64)
    with pytest.raises(ValueError, match="CUDA"):
        expert_w8a8_matmul_cuda(torch.zeros((1, 8, 64), dtype=torch.int8),
                                eq, es, bits=4, group_size=32, k=64)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_pack_cuda(torch.zeros((64, 32)), torch.ones((2, 32)),
                           bits=4)
    with pytest.raises(ValueError, match="CUDA"):
        channel_stats_cuda(torch.zeros((8, 32)))
    assert ops.launch_counts() == {"dequant_matmul": 0, "w8a8_matmul": 0,
                                   "paged_attention": 0,
                                   "expert_dequant_matmul": 0,
                                   "expert_w8a8_matmul": 0,
                                   "quantize_pack": 0, "channel_stats": 0}


def test_paged_ref_matches_dequant_gather_oracle():
    """The port's page walk equals plain softmax attention over the gathered,
    dequantized pages (an oracle independent of the walk)."""
    s, w, ps, kvh, g, hd = 3, 4, 8, 2, 4, 16
    fills = [5, 17, 32]
    q, pools, bt, kv_len = build_paged_case(3, s, w, ps, kvh, g, hd, fills, 8)
    tp = _pools_f32(pools)
    qt = torch.from_numpy(np.array(q))
    o = ops.paged_attention(qt, tp["k_pool"], tp["v_pool"],
                            torch.from_numpy(np.array(bt)),
                            torch.from_numpy(np.array(kv_len)),
                            k_scale_pool=tp["k_scale_pool"],
                            v_scale_pool=tp["v_scale_pool"])
    idx = torch.from_numpy(np.array(bt)).clamp_min(0).long()
    kf = (tp["k_pool"][idx].float() * tp["k_scale_pool"][idx][..., None])
    vf = (tp["v_pool"][idx].float() * tp["v_scale_pool"][idx][..., None])
    kf = kf.reshape(s, w * ps, kvh, hd)
    vf = vf.reshape(s, w * ps, kvh, hd)
    for si, f in enumerate(fills):
        qs = qt[si].reshape(kvh, g, hd)
        sc = torch.einsum("kgd,tkd->kgt", qs, kf[si, :f]) / hd ** 0.5
        want = torch.einsum("kgt,tkd->kgd", torch.softmax(sc, -1),
                            vf[si, :f]).reshape(kvh * g, hd)
        torch.testing.assert_close(o[si], want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("m,k,n", [(8, 2048, 8192), (8, 2048, 512),
                                   (8, 8192, 2048), (512, 2048, 8192),
                                   (40, 576, 192), (1, 64, 160), (8, 100, 8),
                                   (2048, 8192, 2048)])
def test_split_plan_covers_k(m, k, n):
    """The K split the wrapper hands the kernel: whole ring stages of the
    body the planner picks, no empty split, all of K covered, and splits
    only where the output tiles are too few to fill the card."""
    p = plan(m, k, n, 4, 1, int8=False)
    step = STAGE_K if p.body == STREAM else TILE_K
    assert p.splits >= 1 and p.k_per_split % step == 0
    assert (p.splits - 1) * p.k_per_split < k <= p.splits * p.k_per_split
    if m >= 512 and n >= 8192:
        assert p.splits == 1
