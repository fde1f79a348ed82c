"""The port's CUDA kernels against their plain versions, on the card.

Needs an NVIDIA GPU (Hopper, sm_90a) and nvcc; every test skips without a
card. This file imports neither JAX nor the JAX package, so it runs on the
GPU machine, which has no JAX:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.quant.types import dequantize, quantize
from repro_torch.kernels import ops, ref
from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda
from repro_torch.kernels.paged_attention import paged_attention_cuda

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    g = torch.Generator(device="cuda")
    g.manual_seed(0)
    return g


@pytest.mark.parametrize("bits,group", [(2, 32), (3, 32), (4, 32), (4, -1),
                                        (8, -1), (3, -1), (4, 16)])
@pytest.mark.parametrize("m,k,n", [(8, 192, 576), (40, 576, 192),
                                   (1, 64, 160), (67, 160, 64),
                                   (130, 256, 200), (8, 1024, 256)])
def test_dequant_matmul_kernel_matches_plain(gen, m, k, n, bits, group):
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    qt = quantize(w, bits, group)
    kw = dict(bits=bits, group_size=group, k=k)
    got = dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    want = ref.dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
    # same bf16-rounded operands, exact products, f32 sums in another
    # order: 4e-5 of the largest sum of |terms|
    bound = (x.to(torch.bfloat16).float().abs()
             @ dequantize(qt).to(torch.bfloat16).float().abs()).max()
    assert float((got - want).abs().max()) <= 4e-5 * float(bound)


@pytest.mark.parametrize("m_rows,quant,window,hd,g", [
    (1, False, None, 64, 4), (1, True, None, 64, 4), (4, False, None, 64, 4),
    (4, True, None, 64, 4), (1, False, 12, 16, 2), (3, True, 12, 16, 2),
    (1, False, None, 48, 1)])
def test_paged_attention_kernel_matches_plain(gen, m_rows, quant, window,
                                              hd, g):
    s, kvh, ps, w = 5, 2, 8, 6
    fills = [0, m_rows, 8, 29, 48]
    n_pages = 1 + s * w
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).cpu()
    bt = torch.full((s, w), -1, dtype=torch.int32)
    nxt = 0
    for si, f in enumerate(fills):
        need = -(-f // ps)
        bt[si, :need] = perm[nxt:nxt + need].to(torch.int32)
        nxt += need
    kf = torch.randn((n_pages, ps, kvh, hd), generator=gen, device="cuda")
    vf = torch.randn((n_pages, ps, kvh, hd), generator=gen, device="cuda")
    ks = vs = None
    if quant:
        ks = kf.abs().amax(-1) / 127.0
        vs = vf.abs().amax(-1) / 127.0
        kf = torch.round(kf / ks[..., None]).to(torch.int8)
        vf = torch.round(vf / vs[..., None]).to(torch.int8)
    q = torch.randn((s, kvh, m_rows * g, hd), generator=gen, device="cuda")
    args = (q, kf, vf, bt.cuda(), torch.tensor(fills, dtype=torch.int32,
                                              device="cuda"), ks, vs)
    got = paged_attention_cuda(*args, window=window, m_rows=m_rows)
    want = ref.paged_attention_ref(*args, window=window, m_rows=m_rows)
    # f32 on both sides, rounding in another order only
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.all(got[0] == 0)                 # empty slot: exact zeros


# the engine's multi-row reads: verify rows (M 2, 3, 5) and prefill chunks
# (M 16, 64) at llama3.2-1b's GQA 4, hd 64, pages of 16, with fills below M
# (rows at fill positions < 0 read nothing: exact zeros, as the plain
# version gives)
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("m_rows,fills", [
    (2, [0, 1, 2, 40, 77]), (3, [0, 2, 16, 33, 100]),
    (5, [0, 3, 5, 64, 200]), (16, [0, 7, 16, 48, 129]),
    (64, [0, 9, 63, 64, 300])])
def test_multi_row_reads_match_plain(gen, m_rows, fills, quant):
    s, kvh, ps, w, g, hd = 5, 2, 16, 20, 4, 64
    n_pages = 1 + s * w
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).cpu()
    bt = torch.full((s, w), -1, dtype=torch.int32)
    nxt = 0
    for si, f in enumerate(fills):
        need = -(-f // ps)
        bt[si, :need] = perm[nxt:nxt + need].to(torch.int32)
        nxt += need
    kf = torch.randn((n_pages, ps, kvh, hd), generator=gen, device="cuda")
    vf = torch.randn((n_pages, ps, kvh, hd), generator=gen, device="cuda")
    ks = vs = None
    if quant:
        ks = kf.abs().amax(-1) / 127.0
        vs = vf.abs().amax(-1) / 127.0
        kf = torch.round(kf / ks[..., None]).to(torch.int8)
        vf = torch.round(vf / vs[..., None]).to(torch.int8)
    q = torch.randn((s, m_rows, kvh * g, hd), generator=gen, device="cuda")
    kl = torch.tensor(fills, dtype=torch.int32, device="cuda")
    kw = dict(k_scale_pool=ks, v_scale_pool=vs)
    before = ops.launch_counts()["paged_attention"]
    got = ops.paged_attention_prefill(q, kf, vf, bt.cuda(), kl, **kw)
    again = ops.paged_attention_verify(q, kf, vf, bt.cuda(), kl, **kw)
    assert ops.launch_counts()["paged_attention"] == before + 2
    cpu = {k: None if v is None else v.cpu() for k, v in kw.items()}
    want = ops.paged_attention_prefill(q.cpu(), kf.cpu(), vf.cpu(), bt,
                                       kl.cpu(), **cpu)
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert torch.equal(got, again)
    for si, f in enumerate(fills):
        dead = torch.arange(m_rows) < m_rows - f
        assert torch.all(got[si, dead.cuda()] == 0)


def _smoke_engines(**engine_kw):
    """SMOKE llama3.2-1b served on the CPU (plain versions) and on the card:
    (the CPU run's tokens, the card's, the CPU engine, the card engine,
    the card run's launch counts, the requests). The prompts share a
    32-token head."""
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ContinuousEngine

    cfg = get_smoke_config("llama3.2-1b")
    params = init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    head = rng.integers(0, cfg.vocab_size, 32)
    reqs = [(np.concatenate([head, rng.integers(0, cfg.vocab_size,
                                                int(rng.integers(4, 40)))]),
             int(rng.integers(3, 12))) for _ in range(6)]
    out, engines = {}, {}
    for device in ("cpu", "cuda"):
        eng = ContinuousEngine(cfg, params, n_slots=4, max_len=96,
                               page_size=8, prefill_bucket=8, device=device,
                               **engine_kw)
        for i, (prompt, max_new) in enumerate(reqs):
            eng.submit(prompt, max_new=max_new, arrival=float(i))
        ops.reset_launch_counts()
        out[device] = [r.tokens for r in eng.run(max_steps=500)]
        engines[device] = eng
        eng.pool.check_invariants()
    return out, engines, ops.launch_counts(), reqs, cfg


def _agree_but_near_ties(cfg, params, reqs, cpu_out, gpu_out):
    """The card's tokens equal the CPU's up to the first flip, and a flip
    sits at a near-tie of the CPU forward (it ends the comparable
    prefix)."""
    from repro_torch.models.transformer import lm_forward

    for (prompt, _), cpu_toks, gpu_toks in zip(reqs, cpu_out, gpu_out):
        seq = torch.tensor(np.concatenate([prompt, cpu_toks])[None])
        logits = lm_forward(cfg, params, seq)[0][0, len(prompt) - 1:-1]
        top2 = torch.topk(logits, 2, dim=-1).values
        for i, (a, b) in enumerate(zip(cpu_toks, gpu_toks)):
            if a != b:
                assert float(top2[i, 0] - top2[i, 1]) <= 1e-3
                break


def test_prefix_chunked_engine_on_the_card_matches_the_cpu(gen):
    """Prefix sharing and chunked prefill on the card: the same sharing as
    the CPU run, the multi-row read launched, tokens as the CPU's but at
    near-ties."""
    out, eng, counts, reqs, cfg = _smoke_engines(
        prefix_share=True, chunked_prefill=16, quant_bits=4, quant_group=32)
    assert eng["cuda"].n_shared_tokens == eng["cpu"].n_shared_tokens > 0
    assert eng["cuda"].n_prefills == eng["cpu"].n_prefills
    assert counts["paged_attention"] > 0 and counts["dequant_matmul"] > 0
    _agree_but_near_ties(cfg, eng["cpu"].params, reqs, out["cpu"],
                         out["cuda"])


def test_spec_engine_on_the_card_matches_the_cpu(gen):
    """Speculative serving on the card (W4 g32 target, W2 draft): tokens as
    the CPU's but at near-ties, every kernel of the round launched."""
    out, eng, counts, reqs, cfg = _smoke_engines(
        spec_decode=True, draft_bits=2, spec_k=4, quant_bits=4,
        quant_group=32)
    assert eng["cuda"].spec_stats()["rounds"] > 0
    assert counts["paged_attention"] > 0 and counts["dequant_matmul"] > 0
    _agree_but_near_ties(cfg, eng["cpu"].params, reqs, out["cpu"],
                         out["cuda"])


# (S, KVH, page, W, G, hd, fills, window, m_rows, n_split): Mixtral's hd
# 128 and GQA 6 over a 1000-token window with enough pages that the
# planner takes the full cluster of 8; llama's hd 64 at 4 splits with
# slots of 1-3 live pages (splits with no live page), at m_rows 1 and 4
SPLIT_CASES = [(4, 2, 16, 72, 6, 128, [0, 100, 1000, 1152], 1000, 1, 8),
               (6, 2, 16, 16, 4, 64, [0, 1, 17, 40, 200, 256], None, 1, 4),
               (6, 2, 16, 16, 4, 64, [0, 4, 17, 40, 200, 256], None, 4, 4)]


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("case", SPLIT_CASES)
def test_paged_attention_split_walk_matches_plain(gen, case, quant):
    """The walk split over a cluster and merged in rank order: the plain
    version's result, exact zeros for the empty slot, and the same bits
    from a second call."""
    from repro_torch.kernels.paged_attention import plan_paged

    s, kvh, ps, w, g, hd, fills, window, m_rows, n_split = case
    assert plan_paged(s, kvh, w, ps, m_rows * g, hd, hd, quant) == n_split
    n_pages = 1 + s * w
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).cpu()
    bt = torch.full((s, w), -1, dtype=torch.int32)
    nxt = 0
    for si, f in enumerate(fills):
        need = -(-f // ps)
        bt[si, :need] = perm[nxt:nxt + need].to(torch.int32)
        nxt += need
    kf = torch.randn((n_pages, ps, kvh, hd), generator=gen, device="cuda")
    vf = torch.randn((n_pages, ps, kvh, hd), generator=gen, device="cuda")
    ks = vs = None
    if quant:
        ks = kf.abs().amax(-1) / 127.0
        vs = vf.abs().amax(-1) / 127.0
        kf = torch.round(kf / ks[..., None]).to(torch.int8)
        vf = torch.round(vf / vs[..., None]).to(torch.int8)
    q = torch.randn((s, kvh, m_rows * g, hd), generator=gen, device="cuda")
    args = (q, kf, vf, bt.cuda(), torch.tensor(fills, dtype=torch.int32,
                                              device="cuda"), ks, vs)
    got = paged_attention_cuda(*args, window=window, m_rows=m_rows)
    want = ref.paged_attention_ref(*args, window=window, m_rows=m_rows)
    # f32 on both sides, rounding in another order only
    assert float((got - want).abs().max()) <= 1e-4
    assert torch.all(got[0] == 0)                 # empty slot: exact zeros
    again = paged_attention_cuda(*args, window=window, m_rows=m_rows)
    assert torch.equal(got, again)                # a fixed merge order


def test_engine_serves_through_the_kernels(gen):
    """SMOKE-size serving on the card launches both kernels, and its greedy
    tokens agree with the CPU engine (plain versions) wherever the CPU
    forward's top-2 margin leaves no near-tie."""
    from repro_torch.models.transformer import init_lm, lm_forward
    from repro_torch.serve.engine import ContinuousEngine

    cfg = get_smoke_config("llama3.2-1b")
    params = init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 40))),
             int(rng.integers(3, 12))) for _ in range(6)]
    outs = {}
    for device in ("cpu", "cuda"):
        eng = ContinuousEngine(cfg, params, n_slots=4, max_len=64,
                               page_size=8, prefill_bucket=8, quant_bits=4,
                               quant_group=32, device=device)
        for prompt, max_new in reqs:
            eng.submit(prompt, max_new=max_new)
        ops.reset_launch_counts()
        outs[device] = [r.tokens for r in eng.run(max_steps=500)]
        if device == "cuda":
            counts = ops.launch_counts()
            assert counts["dequant_matmul"] > 0
            assert counts["paged_attention"] > 0
        else:
            cpu_params = eng.params
    for (prompt, _), cpu_toks, gpu_toks in zip(reqs, outs["cpu"],
                                               outs["cuda"]):
        seq = torch.tensor(np.concatenate([prompt, cpu_toks])[None])
        logits = lm_forward(cfg, cpu_params, seq)[0][0, len(prompt) - 1:-1]
        top2 = torch.topk(logits, 2, dim=-1).values
        for i, (a, b) in enumerate(zip(cpu_toks, gpu_toks)):
            if a != b:
                # a flip is allowed only at a near-tie, and ends the
                # comparable prefix
                assert float(top2[i, 0] - top2[i, 1]) <= 1e-3
                break


W8A8_SHAPES = [(8, 192, 576), (40, 576, 192), (1, 64, 160), (67, 160, 64),
               (130, 256, 200), (5, 1024, 256), (8, 2048, 512)]


W8A8_QUANTS = [(2, 32), (3, 32), (4, 16), (4, 64), (4, 128), (4, -1),
               (8, -1), (3, -1), (2, -1)]
# every shape with every (bits, group) whose group divides K
W8A8_CASES = [(m, k, n, bits, group) for m, k, n in W8A8_SHAPES
              for bits, group in W8A8_QUANTS if group == -1 or k % group == 0]


@pytest.mark.parametrize("m,k,n,bits,group", W8A8_CASES)
def test_w8a8_matmul_kernel_matches_plain(gen, m, k, n, bits, group):
    from repro_torch.core.quant.types import quantize_activation, unpack
    from repro_torch.kernels.w8a8_matmul import w8a8_matmul_cuda

    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    qt = quantize(w, bits, group, act_bits=8)
    xq, _ = quantize_activation(x)
    kw = dict(bits=bits, group_size=group, k=k)
    got = w8a8_matmul_cuda(xq, qt.qw, qt.scale, **kw)
    want = ref.w8a8_matmul_ref(xq, qt.qw, qt.scale, **kw)
    # both take each scale group's sum exactly (int32 / float64), convert
    # it to f32 and rescale it the same way; they differ only in the
    # order of the f32 sum over groups and K splits: 1e-5 of the largest
    # sum of |group terms|
    rows = torch.arange(k, device="cuda") // (k // qt.scale.shape[0])
    wabs = unpack(qt.qw, bits, k).abs().double() * qt.scale[rows].double()
    bound = float((xq.double().abs() @ wabs).max())
    assert float((got - want).abs().max()) <= 1e-5 * bound


# kernels 1 and 3 across M: the decode body (streaming, M up to the
# kernel's STREAM_MAX_M, 96 or 32, in one to three chunks), each
# threshold and both sides of it, the prefill tile with and without K splits, and beyond one
# tile's rows; per-channel
# scales on a K that is no whole number of either body's stages (and, for
# int8 x, not 16-byte rows), groups of 16 rows (the streaming body at any
# M) and 128 rows (one a ring stage of either body); N = 272 is no whole
# number of the tile's 128 columns nor the strip's 256
DENSE_MS = [1, 5, 8, 16, 17, 32, 33, 64, 65, 96, 97, 128, 512, 2048]
DENSE_QUANTS = [(-1, 200), (16, 384), (128, 384)]


def _dense_case(gen, m, k, n, bits, group, act_bits=0):
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    return x, quantize(w, bits, group, act_bits=act_bits)


@pytest.mark.parametrize("group,k", DENSE_QUANTS)
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", DENSE_MS)
def test_dequant_matmul_bodies_match_plain(gen, m, bits, group, k):
    x, qt = _dense_case(gen, m, k, 272, bits, group)
    kw = dict(bits=bits, group_size=group, k=k)
    got = dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    want = ref.dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
    bound = (x.to(torch.bfloat16).float().abs()
             @ dequantize(qt).to(torch.bfloat16).float().abs()).max()
    assert float((got - want).abs().max()) <= 4e-5 * float(bound)


@pytest.mark.parametrize("group,k", DENSE_QUANTS)
@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("m", DENSE_MS)
def test_w8a8_matmul_bodies_match_plain(gen, m, bits, group, k):
    """Per-channel scales: the plain version's bits (one exact int32 sum
    over all of K, K splits added in int32, one rescale); grouped: 1e-5 of
    the largest sum of |group terms|."""
    from repro_torch.core.quant.types import quantize_activation, unpack
    from repro_torch.kernels.w8a8_matmul import w8a8_matmul_cuda

    x, qt = _dense_case(gen, m, k, 272, bits, group, act_bits=8)
    xq, _ = quantize_activation(x)
    kw = dict(bits=bits, group_size=group, k=k)
    got = w8a8_matmul_cuda(xq, qt.qw, qt.scale, **kw)
    want = ref.w8a8_matmul_ref(xq, qt.qw, qt.scale, **kw)
    if group == -1:
        assert torch.equal(got, want)
    else:
        rows = torch.arange(k, device="cuda") // group
        wabs = (unpack(qt.qw, bits, k).abs().double()
                * qt.scale[rows].double())
        bound = float((xq.double().abs() @ wabs).max())
        assert float((got - want).abs().max()) <= 1e-5 * bound


# llama's 2048 x 2048 at a decode M (the streaming body, K split), an M
# whose tiles are few (the tile body, K split) and one whose 16 x 8 tiles
# nearly fill the card (no split)
@pytest.mark.parametrize("m", [8, 128, 2048])
@pytest.mark.parametrize("group", [-1, 128])
def test_dense_kernels_are_deterministic(gen, m, group):
    """Two launches of each dense kernel on the same inputs give the same
    bits (split-K partials summed in split order, no float atomics), one
    launch counted each; W8A8 per-channel gives the plain version's bits."""
    from repro_torch.core.quant.types import quantize_activation
    from repro_torch.kernels.dequant_matmul import plan
    from repro_torch.kernels.w8a8_matmul import w8a8_matmul_cuda

    k = n = 2048
    groups = 1 if group == -1 else k // group
    assert (plan(m, k, n, 4, groups, int8=False).splits > 1) == (m < 2048)
    x, qt = _dense_case(gen, m, k, n, 4, group, act_bits=8)
    xq, _ = quantize_activation(x)
    kw = dict(bits=4, group_size=group, k=k)
    for name, fn, arg in (("dequant_matmul", dequant_matmul_cuda, x),
                          ("w8a8_matmul", w8a8_matmul_cuda, xq)):
        before = ops.launch_counts()[name]
        first = fn(arg, qt.qw, qt.scale, **kw)
        second = fn(arg, qt.qw, qt.scale, **kw)
        assert ops.launch_counts()[name] == before + 2
        assert torch.equal(first, second)
    if group == -1:
        assert torch.equal(second, ref.w8a8_matmul_ref(xq, qt.qw, qt.scale,
                                                       **kw))


def test_w8a8_matmul_refuses_what_it_cannot_take(gen):
    from repro_torch.kernels.w8a8_matmul import w8a8_matmul_cuda

    w = torch.randn((64, 32), generator=gen, device="cuda")
    qt = quantize(w, 4, 8)                       # a group of 8 rows
    xq = torch.zeros((2, 64), dtype=torch.int8, device="cuda")
    with pytest.raises(ValueError, match="multiple of 16"):
        w8a8_matmul_cuda(xq, qt.qw, qt.scale, bits=4, group_size=8, k=64)
    with pytest.raises(ValueError, match="int8"):
        w8a8_matmul_cuda(xq.float(), qt.qw, qt.scale, bits=4, group_size=8,
                         k=64)


@pytest.mark.parametrize("act_bits", [0, 8])
@pytest.mark.parametrize("bits,group", [(4, 32), (3, -1)])
def test_packed_linear_backward_matches_plain(gen, act_bits, bits, group):
    """The gradient of a packed linear through its kernel on the card
    equals the gradient through the plain version on a CPU copy: kernel 1
    backs off to grad @ dequantize(W).T; on A8 the gradient flows through
    the per-token scale only, so the nonzero pattern (each row's argmax
    channel) is the same on both."""
    from repro_torch.models.linear import dense

    k, n, m = 192, 576, 24
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    qt = quantize(w, bits, group, act_bits=act_bits)
    x = torch.randn((2, m // 2, k), generator=gen, device="cuda")
    dy = torch.randn((2, m // 2, n), generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        xd = x.to(dev).requires_grad_(True)
        y = dense({"w": qt.to(dev)}, xd)
        (gx,) = torch.autograd.grad((y * dy.to(dev)).sum(), xd)
        grads[dev] = gx.cpu()
    got, want = grads["cuda"], grads["cpu"]
    assert torch.equal(got != 0, want != 0)
    if act_bits == 8:
        assert int((want != 0).sum()) <= m * 2     # argmax channels only
    # f32 products summed in another order on the two devices
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


# (E, C, K, N): TINY's widths with a ragged capacity, Mixtral-like decode
# (C = 8) and prefill (C = 80) capacities, one expert, a split-K shape, a
# capacity beyond one block's chunk of rows (32), an N that is not a multiple of 16 (the copies' byte path) and
# a K that is not a multiple of 16 (per-channel scales only)
EXPERT_SHAPES = [(4, 8, 192, 576), (3, 5, 576, 192), (2, 80, 160, 64),
                 (1, 1, 64, 160), (8, 8, 1024, 256), (2, 136, 256, 192),
                 (2, 8, 256, 100), (2, 8, 200, 128)]
# a group of 8 is no whole number of the kernel's 16-row K steps: its
# scales are read per value
EXPERT_DQ_QUANTS = [(2, 32), (3, 32), (4, 32), (4, -1), (8, -1), (3, -1),
                    (4, 16), (4, 8)]
# every shape with every (bits, group) whose group divides K
EXPERT_DQ_CASES = [(e, c, k, n, bits, group) for e, c, k, n in EXPERT_SHAPES
                   for bits, group in EXPERT_DQ_QUANTS
                   if group == -1 or k % group == 0]


def _expert_case(gen, e, c, k, n, bits, group, act_bits=0):
    x = torch.randn((e, c, k), generator=gen, device="cuda")
    x[:, -1] = 0.0                       # an empty capacity row
    w = torch.randn((e, k, n), generator=gen, device="cuda") / math.sqrt(k)
    from repro_torch.core.quant.types import quantize_stacked
    return x, quantize_stacked(w, bits, group, act_bits)


@pytest.mark.parametrize("e,c,k,n,bits,group", EXPERT_DQ_CASES)
def test_expert_dequant_matmul_kernel_matches_plain(gen, e, c, k, n, bits,
                                                    group):
    from repro_torch.kernels.expert_dequant_matmul import (
        expert_dequant_matmul_cuda)

    x, qt = _expert_case(gen, e, c, k, n, bits, group)
    kw = dict(bits=bits, group_size=group, k=k)
    before = ops.launch_counts()["expert_dequant_matmul"]
    got = expert_dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    assert ops.launch_counts()["expert_dequant_matmul"] == before + 1
    want = ref.expert_dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
    # kernel 1's bound: the same bf16 operands, f32 sums in another order
    bound = torch.matmul(x.to(torch.bfloat16).float().abs(),
                         dequantize(qt).to(torch.bfloat16).float().abs())
    assert float((got - want).abs().max()) <= 4e-5 * float(bound.max())
    assert torch.all(got[:, -1] == 0)


EXPERT_W8_QUANTS = [(2, 32), (3, 32), (4, 16), (4, 64), (4, -1), (8, -1),
                    (3, -1)]
# every shape with every (bits, group) whose group divides K
EXPERT_W8_CASES = [(e, c, k, n, bits, group) for e, c, k, n in EXPERT_SHAPES
                   for bits, group in EXPERT_W8_QUANTS
                   if group == -1 or k % group == 0]


@pytest.mark.parametrize("e,c,k,n,bits,group", EXPERT_W8_CASES)
def test_expert_w8a8_matmul_kernel_matches_plain(gen, e, c, k, n, bits,
                                                 group):
    from repro_torch.core.quant.types import quantize_activation, unpack
    from repro_torch.kernels.expert_w8a8_matmul import (
        expert_w8a8_matmul_cuda)

    x, qt = _expert_case(gen, e, c, k, n, bits, group, act_bits=8)
    xq, _ = quantize_activation(x.reshape(e * c, k))
    xq = xq.reshape(e, c, k)
    kw = dict(bits=bits, group_size=group, k=k)
    got = expert_w8a8_matmul_cuda(xq, qt.qw, qt.scale, **kw)
    want = ref.expert_w8a8_matmul_ref(xq, qt.qw, qt.scale, **kw)
    # kernel 3's bound: exact group sums, f32 sums over groups and splits
    # in another order
    g = qt.scale.shape[-2]
    rows = torch.arange(k, device="cuda") // (k // g)
    wabs = unpack(qt.qw, bits, k).abs().double() * qt.scale[:, rows].double()
    bound = float(torch.matmul(xq.double().abs(), wabs).max())
    assert float((got - want).abs().max()) <= 1e-5 * bound
    assert torch.all(got[:, -1] == 0)


@pytest.mark.parametrize("e,c,k,n", [(4, 8, 2048, 1024), (2, 136, 640, 512)])
def test_expert_dequant_matmul_is_deterministic(gen, e, c, k, n):
    """Two launches on the same inputs give the same bits (split-K partials
    summed in split order, no float atomics), one launch counted each."""
    from repro_torch.kernels.expert_dequant_matmul import (
        expert_dequant_matmul_cuda, plan)

    x, qt = _expert_case(gen, e, c, k, n, 4, 128)
    kw = dict(bits=4, group_size=128, k=k)
    p = plan(e, c, k, n, 4, k // 128, x_bytes=4)
    assert p.splits > 1 or p.chunks > 1       # the multi-block paths
    before = ops.launch_counts()["expert_dequant_matmul"]
    first = expert_dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    assert ops.launch_counts()["expert_dequant_matmul"] == before + 1
    second = expert_dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    assert ops.launch_counts()["expert_dequant_matmul"] == before + 2
    assert torch.equal(first, second)


@pytest.mark.parametrize("e,c,k,n,group", [(4, 8, 2048, 1024, -1),
                                           (4, 8, 2048, 1024, 128),
                                           (2, 136, 640, 512, -1)])
def test_expert_w8a8_matmul_is_deterministic(gen, e, c, k, n, group):
    """Two launches on the same inputs give the same bits, one launch
    counted each; with per-channel scales they are the plain version's
    bits (the K splits' exact int32 sums are added before the one
    rescale)."""
    from repro_torch.core.quant.types import quantize_activation
    from repro_torch.kernels.expert_dequant_matmul import plan
    from repro_torch.kernels.expert_w8a8_matmul import (
        expert_w8a8_matmul_cuda)

    x, qt = _expert_case(gen, e, c, k, n, 4, group, act_bits=8)
    xq, _ = quantize_activation(x.reshape(e * c, k))
    xq = xq.reshape(e, c, k)
    kw = dict(bits=4, group_size=group, k=k)
    groups = 1 if group == -1 else k // group
    p = plan(e, c, k, n, 4, groups, x_bytes=1)
    assert p.splits > 1 or p.chunks > 1
    before = ops.launch_counts()["expert_w8a8_matmul"]
    first = expert_w8a8_matmul_cuda(xq, qt.qw, qt.scale, **kw)
    assert ops.launch_counts()["expert_w8a8_matmul"] == before + 1
    second = expert_w8a8_matmul_cuda(xq, qt.qw, qt.scale, **kw)
    assert ops.launch_counts()["expert_w8a8_matmul"] == before + 2
    assert torch.equal(first, second)
    if group == -1:
        assert torch.equal(first, ref.expert_w8a8_matmul_ref(
            xq, qt.qw, qt.scale, **kw))


def test_expert_kernels_refuse_what_they_cannot_take(gen):
    from repro_torch.kernels.expert_dequant_matmul import (
        expert_dequant_matmul_cuda)
    from repro_torch.kernels.expert_w8a8_matmul import (
        expert_w8a8_matmul_cuda)

    x, qt = _expert_case(gen, 2, 8, 64, 32, 4, 8, act_bits=8)
    with pytest.raises(ValueError, match="multiple of 16"):
        expert_w8a8_matmul_cuda(torch.zeros((2, 8, 64), dtype=torch.int8,
                                            device="cuda"), qt.qw, qt.scale,
                                bits=4, group_size=8, k=64)
    with pytest.raises(ValueError, match="want x"):
        expert_dequant_matmul_cuda(x[0], qt.qw, qt.scale, bits=4,
                                   group_size=8, k=64)
    with pytest.raises(ValueError, match="want x"):
        expert_dequant_matmul_cuda(x, qt.qw[:1], qt.scale[:1], bits=4,
                                   group_size=8, k=64)


@pytest.mark.parametrize("act_bits", [0, 8])
def test_moe_engine_serves_through_the_expert_kernels(gen, act_bits):
    """Mixtral SMOKE served W4 g32 (or W4A8) on the card launches the
    expert kernel of its linears, and its greedy tokens agree with the CPU
    engine (plain versions) until a near-tie of the CPU forward."""
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ContinuousEngine

    cfg = get_smoke_config("mixtral-8x22b")
    params = init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 40))),
             int(rng.integers(3, 12))) for _ in range(6)]
    kernel = "expert_w8a8_matmul" if act_bits else "expert_dequant_matmul"
    outs = {}
    for device in ("cpu", "cuda"):
        eng = ContinuousEngine(cfg, params, n_slots=4, max_len=64,
                               page_size=8, prefill_bucket=8,
                               prefill_batch=1, quant_bits=4, quant_group=32,
                               act_bits=act_bits, device=device)
        for prompt, max_new in reqs:
            eng.submit(prompt, max_new=max_new)
        ops.reset_launch_counts()
        outs[device] = [r.tokens for r in eng.run(max_steps=500)]
        counts = ops.launch_counts()
        assert (counts[kernel] > 0) == (device == "cuda")
    agree = sum(a == b for a, b in zip(outs["cpu"], outs["cuda"]))
    # A8 rounds every input to int8 per token: a last-bit difference can
    # move a code a whole step, so near-ties flip more often than on W4
    assert agree >= (4 if act_bits else 5)


# (shape, group): TINY's and llama's widths, K not a multiple of a packed
# group (100: the last W3 and W2 groups padded with zero fields), a group
# of 3, a group smaller than a W3 word, and (L, E) stacks
QP_CASES = [((192, 576), 32), ((2048, 512), 128), ((100, 24), -1),
            ((768, 40), 3), ((64, 33), 4), ((3, 64, 40), 16),
            ((2, 3, 96, 24), -1)]


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("shape,group", QP_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_pack_kernel_matches_plain(gen, shape, group, bits, dtype):
    """Byte-equal to the plain version: the same IEEE f32 quotient,
    rounded half to even, clipped, packed. One launch a stack. With a
    power-of-two scale the first row holds exact halves of the grid
    (which round to even) and the weights reach past it (which clip)."""
    from repro_torch.core.quant.types import qmax_for_bits
    from repro_torch.kernels.quantize_pack import quantize_pack_cuda

    lead, (k, n) = shape[:-2], shape[-2:]
    g = 1 if group == -1 else k // group
    w = torch.randn(shape, generator=gen, device="cuda") * 0.1
    qmax = qmax_for_bits(bits)
    ties = (torch.arange(2 * qmax + 2, device="cuda") - qmax - 0.5) / 16
    m = min(n, len(ties))
    w[..., 0, :m] = ties[:m]
    w = w.to(dtype)
    scale = torch.full(lead + (g, n), 1 / 16, device="cuda")
    before = ops.launch_counts()["quantize_pack"]
    got = quantize_pack_cuda(w, scale, bits=bits)
    assert ops.launch_counts()["quantize_pack"] == before + 1
    want = ref.quantize_pack_ref(w, scale, bits=bits)
    assert got.dtype == torch.uint8 and got.shape == want.shape
    assert torch.equal(got, want)


def test_quantize_pack_refuses_what_it_cannot_take(gen):
    from repro_torch.kernels.quantize_pack import quantize_pack_cuda

    w = torch.randn((64, 32), generator=gen, device="cuda")
    with pytest.raises(ValueError, match="G dividing"):
        quantize_pack_cuda(w, torch.ones((3, 32), device="cuda"), bits=4)
    with pytest.raises(ValueError, match="bits"):
        quantize_pack_cuda(w, torch.ones((2, 32), device="cuda"), bits=5)
    with pytest.raises(ValueError, match="f32 or bf16"):
        quantize_pack_cuda(w.half(), torch.ones((2, 32), device="cuda"),
                           bits=4)


# (T, C): one row, a ragged tile and strip, TINY's d 192 over 40-token
# samples, a tweak step's 8 x 2048 tokens at llama's d 2048
CS_SHAPES = [(1, 5), (257, 33), (320, 192), (1000, 70), (16384, 2048)]


@pytest.mark.parametrize("t,c", CS_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("mean", [0.5, 1e3])
def test_channel_stats_kernel_matches_plain(gen, t, c, dtype, mean):
    """Against the plain version (f32 mean, two-pass variance): tile-wise
    two-pass sums merged by Chan's formula, in another order. Mean within
    1e-6 of max(|mean|, std), variance within 1e-5 relative; at mean 1e3
    and std 1 too, where sum(x^2) / T - mean^2 in f32 would be off by
    percents. Deterministic: a second call is bit-equal."""
    from repro_torch.kernels.channel_stats import channel_stats_cuda

    x = (torch.randn((t, c), generator=gen, device="cuda") + mean).to(dtype)
    mu, var = channel_stats_cuda(x)
    want_mu, want_var = ref.channel_stats_ref(x)
    scale = torch.maximum(want_mu.abs(), want_var.sqrt())
    assert torch.all((mu - want_mu).abs() <= 1e-6 * scale + 1e-7)
    assert torch.all((var - want_var).abs() <= 1e-5 * want_var + 1e-9)
    mu2, var2 = channel_stats_cuda(x)
    assert torch.equal(mu, mu2) and torch.equal(var, var2)


def test_channel_stats_gradient_matches_the_cpu(gen):
    """The loss's statistics through the Function on the card (kernel 7
    forward, plain backward) and on the CPU (plain both): the gradient of
    l_dist within 1e-5 of its largest entry."""
    from repro_torch.core.normtweak.losses import l_dist

    f = torch.randn((4, 64, 96), generator=gen, device="cuda")
    q = f + 0.1 * torch.randn(f.shape, generator=gen, device="cuda")
    grads = {}
    for dev in ("cuda", "cpu"):
        qd = q.to(dev).requires_grad_(True)
        before = ops.launch_counts()["channel_stats"]
        (g,) = torch.autograd.grad(l_dist(f.to(dev), qd), qd)
        assert ops.launch_counts()["channel_stats"] - before == (
            2 if dev == "cuda" else 0)
        grads[dev] = g.cpu()
    assert float((grads["cuda"] - grads["cpu"]).abs().max()) <= 1e-5 * float(
        grads["cpu"].abs().max())


# kernel 6 off its vector path: N not a multiple of 4 (scalar loads and
# 1-byte stores), and contiguous views whose data pointers sit 4 bytes past
# 16 (w) or past a 4-byte boundary (scale), with bf16 weights 2 bytes past
QP_SCALAR_CASES = [((2, 256, 1030), 128), ((96, 37), 3), ((2050, 22), -1),
                   ((3, 64, 6), 16)]


@pytest.mark.parametrize("bits", [2, 3, 4, 8])
@pytest.mark.parametrize("shape,group", QP_SCALAR_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_quantize_pack_kernel_odd_n_matches_plain(gen, shape, group, bits,
                                                  dtype):
    """N not a multiple of the 4-column vector: byte-equal to the plain
    version, one launch."""
    from repro_torch.core.quant.types import compute_scales
    from repro_torch.kernels.quantize_pack import quantize_pack_cuda

    w = (torch.randn(shape, generator=gen, device="cuda") * 0.1).to(dtype)
    scale = compute_scales(w.float(), bits, group)
    before = ops.launch_counts()["quantize_pack"]
    got = quantize_pack_cuda(w, scale, bits=bits)
    assert ops.launch_counts()["quantize_pack"] == before + 1
    assert torch.equal(got, ref.quantize_pack_ref(w, scale, bits=bits))


@pytest.mark.parametrize("bits", [3, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("misaligned", ["w", "scale"])
def test_quantize_pack_kernel_unaligned_views_match_plain(gen, bits, dtype,
                                                          misaligned):
    """A contiguous view one element into its storage: the vector path's
    alignment fails and the scalar path gives the same bytes; the aligned
    copy of the same values gives them too."""
    from repro_torch.core.quant.types import compute_scales
    from repro_torch.kernels.quantize_pack import quantize_pack_cuda

    k, n, group = 256, 512, 32
    w = (torch.randn((k, n), generator=gen, device="cuda") * 0.1).to(dtype)
    scale = compute_scales(w.float(), bits, group)
    if misaligned == "w":
        base = torch.empty(w.numel() + 1, dtype=dtype, device="cuda")
        base[1:] = w.flatten()
        w_in, s_in = base[1:].view(k, n), scale
        assert w_in.is_contiguous() and w_in.data_ptr() % 16
    else:
        base = torch.empty(scale.numel() + 1, device="cuda")
        base[1:] = scale.flatten()
        w_in, s_in = w, base[1:].view(scale.shape)
        assert s_in.is_contiguous() and s_in.data_ptr() % 16
    want = ref.quantize_pack_ref(w, scale, bits=bits)
    assert torch.equal(quantize_pack_cuda(w_in, s_in, bits=bits), want)
    assert torch.equal(quantize_pack_cuda(w, scale, bits=bits), want)


# kernel 7 at the whole calibration set's 262,144 rows, and at C not a
# multiple of the vector width (4 f32, 8 bf16: the scalar slots), also
# from a view whose pointer is off 16 bytes
CS_MORE_SHAPES = [(262144, 2048), (4097, 1030), (3000, 2047), (129, 6)]


@pytest.mark.parametrize("t,c", CS_MORE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_stats_kernel_more_shapes_match_plain(gen, t, c, dtype):
    """The same limits as test_channel_stats_kernel_matches_plain, and a
    second call bit-equal to the first."""
    from repro_torch.kernels.channel_stats import channel_stats_cuda

    x = (torch.randn((t, c), generator=gen, device="cuda") + 0.5).to(dtype)
    mu, var = channel_stats_cuda(x)
    want_mu, want_var = ref.channel_stats_ref(x)
    scale = torch.maximum(want_mu.abs(), want_var.sqrt())
    assert torch.all((mu - want_mu).abs() <= 1e-6 * scale + 1e-7)
    assert torch.all((var - want_var).abs() <= 1e-5 * want_var + 1e-9)
    mu2, var2 = channel_stats_cuda(x)
    assert torch.equal(mu, mu2) and torch.equal(var, var2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_channel_stats_kernel_unaligned_view_same_bits(gen, dtype):
    """A contiguous view one element into its storage takes the scalar
    slots; they fill the same slots in the same order as the 16-byte
    copies, so the bits equal the aligned copy's."""
    from repro_torch.kernels.channel_stats import channel_stats_cuda

    t, c = 2000, 512
    x = (torch.randn((t, c), generator=gen, device="cuda") + 0.5).to(dtype)
    base = torch.empty(x.numel() + 1, dtype=dtype, device="cuda")
    base[1:] = x.flatten()
    view = base[1:].view(t, c)
    assert view.is_contiguous() and view.data_ptr() % 16
    mu, var = channel_stats_cuda(x)
    mu_v, var_v = channel_stats_cuda(view)
    assert torch.equal(mu, mu_v) and torch.equal(var, var_v)


# TINY's quality path (Table 2): its two linear shapes at the tweak's M
# (4 samples x 64 tokens) and the evaluation's (8 windows x 64), W2 g64
# and W4 per-channel
@pytest.mark.parametrize("bits,group", [(2, 64), (4, -1)])
@pytest.mark.parametrize("m,k,n", [(256, 192, 576), (256, 576, 192),
                                   (512, 192, 576), (512, 576, 192)])
def test_dequant_matmul_quality_path_shapes_match_plain(gen, m, k, n, bits,
                                                        group):
    x, qt = _dense_case(gen, m, k, n, bits, group)
    kw = dict(bits=bits, group_size=group, k=k)
    got = dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    want = ref.dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
    bound = (x.to(torch.bfloat16).float().abs()
             @ dequantize(qt).to(torch.bfloat16).float().abs()).max()
    assert float((got - want).abs().max()) <= 4e-5 * float(bound)


def test_train_step_on_the_card_matches_the_cpu(gen):
    """One training step of TINY (2 layers) on the card against the same
    step on the CPU, from the same params and batch: the loss within 1e-5
    relative, and each param's move within 1e-3 lr, except where the
    gradient is within the two devices' gradient noise of 0 (1e-3 of the
    leaf's largest |g|), where Adam's first step, nearly sign(g) * lr, may
    move it up to 2 lr the other way (tests/test_torch_train.py)."""
    from repro_torch.configs import TINY
    from repro_torch.device import resolve_device
    from repro_torch.models.transformer import init_lm, lm_loss
    from repro_torch.optim.schedules import constant
    from repro_torch.train.train_step import (_grads_of, init_opt_state,
                                              make_train_step)
    from repro_torch.utils.tree import tree_leaves, tree_map

    resolve_device("cuda")                  # full-f32 products, no TF32
    cfg, lr = TINY.replace(n_repeats=2), 1e-3
    cpu = init_lm(cfg, seed=0, device="cpu")
    card = tree_map(lambda t: t.cuda(), cpu)
    toks = np.random.default_rng(0).integers(4, 256, (16, 65))
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).int(),
             "labels": torch.from_numpy(toks[:, 1:]).int()}
    step = make_train_step(cfg, lr_schedule=constant(lr))
    want_p, _, want_m = step(cpu, init_opt_state(cfg, cpu), batch, 0)
    got_p, _, got_m = step(card, init_opt_state(cfg, card),
                           {k: v.cuda() for k, v in batch.items()}, 0)
    assert abs(float(got_m["loss"]) / float(want_m["loss"]) - 1) <= 1e-5
    _, _, grads = _grads_of(cfg, lm_loss, cpu, batch)
    for g, p0, got, want in zip(tree_leaves(grads), tree_leaves(cpu),
                                tree_leaves(got_p), tree_leaves(want_p)):
        near0 = g.abs() <= 1e-3 * g.abs().max()
        err = (got.cpu() - want).abs()
        assert float(err[~near0].max()) <= 1e-3 * lr
        assert float(err.max()) <= 2 * lr + 1e-6
        assert not torch.equal(got.cpu(), p0)


@pytest.mark.parametrize("kv_bits", [0, 8])
def test_spill_gather_scatter_bytes_on_the_card(gen, kv_bits):
    """The spill's page gather (every pool leaf, one copy to host numpy)
    and the restore's scatter into other pages give back identical bytes,
    for f32 pools and for int8 pools with their f32 scales."""
    from repro_torch.models.transformer import init_cache
    from repro_torch.serve.engine import _PAGE_AXIS, _host_tree, _put_tree
    from repro_torch.serve.kvcache import PageSpec

    cfg = get_smoke_config("llama3.2-1b").replace(kv_cache_bits=kv_bits)
    cache = init_cache(cfg, PageSpec(n_pages=24, page_size=8, max_pages=6),
                       torch.device("cuda"))
    for pool in cache["stack"]["p0"].values():
        if pool.dtype == torch.int8:
            pool.copy_(torch.randint(-127, 128, pool.shape, generator=gen,
                                     device="cuda", dtype=torch.int8))
        else:
            pool.copy_(torch.randn(pool.shape, generator=gen,
                                   device="cuda"))
    before = {k: v.clone() for k, v in cache["stack"]["p0"].items()}
    src = torch.tensor([3, 17, 5, 9, 22], device="cuda")
    dst = torch.tensor([1, 2, 11, 12, 20], device="cuda")
    host = _host_tree(cache, lambda key, t: t.index_select(_PAGE_AXIS, src))
    for key, arr in host["stack"]["p0"].items():
        assert isinstance(arr, np.ndarray)
        want = before[key].index_select(_PAGE_AXIS, src).cpu().numpy()
        assert arr.dtype == want.dtype
        assert arr.tobytes() == want.tobytes()
    for pool in cache["stack"]["p0"].values():
        pool.zero_()
    _put_tree(cache, host,
              lambda d, s: d.index_copy_(_PAGE_AXIS, dst, s),
              torch.device("cuda"))
    for key, pool in cache["stack"]["p0"].items():
        got = pool.index_select(_PAGE_AXIS, dst).cpu().numpy()
        want = before[key].index_select(_PAGE_AXIS, src).cpu().numpy()
        assert got.tobytes() == want.tobytes()


def test_snapshot_restore_on_the_card(gen, tmp_path):
    """SMOKE llama3.2-1b W4 g32 with preemption on the card: an engine
    snapshot taken mid-trace (a spilled request in flight), saved and
    loaded through the disk and restored into a fresh card engine, goes on
    to the uninterrupted run's tokens, events and stats."""
    from repro_torch.checkpoint.store import load_snapshot, save_snapshot
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ContinuousEngine

    cfg = get_smoke_config("llama3.2-1b")
    params = init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(7)
    reqs = [(rng.integers(0, cfg.vocab_size, 8), mn, t, p)
            for mn, t, p in [(16, 0.0, 1), (4, 3.0, 0), (5, 5.0, 0),
                             (6, 7.0, 1)]]

    def build():
        eng = ContinuousEngine(cfg, params, n_slots=1, max_len=48,
                               page_size=8, prefill_bucket=8, decode_block=2,
                               preempt=True, quant_bits=4, quant_group=32,
                               debug=True, device="cuda")
        for prompt, mn, t, p in reqs:
            eng.submit(prompt, max_new=mn, arrival=t, priority=p)
        return eng

    base = build()
    want = {r.rid: r.tokens for r in base.run(max_steps=500)}
    eng = build()
    for _ in range(5):
        eng.step(float(eng.t))
        eng.t += 1
    assert any(r.spill is not None for r in eng.sched.queue)
    save_snapshot(str(tmp_path / "snap"), eng.snapshot())
    fresh = ContinuousEngine(cfg, params, n_slots=1, max_len=48, page_size=8,
                             prefill_bucket=8, decode_block=2, preempt=True,
                             quant_bits=4, quant_group=32, debug=True,
                             device="cuda")
    fresh.restore(load_snapshot(str(tmp_path / "snap")))
    got = {r.rid: r.tokens for r in fresh.run(max_steps=500)}
    assert got == want
    assert fresh.sched.events == base.sched.events
    assert fresh.sched.stats() == base.sched.stats()
    assert fresh.n_restored_pages == base.n_restored_pages > 0


# ----------------------------------------------- the dense variants' shapes

# kernel 1 at W4 g128 on the dense variants' linears, at a decode M and a
# prefill M: qwen2-0.5b's MLP (K 896, 7 groups) and KV projection (N 128),
# chatglm3-6b's down projection (K 13696, 107 groups) and KV projection
# (N 256), granite-20b's MQA KV projection (K 6144, N 128)
@pytest.mark.parametrize("m", [8, 512])
@pytest.mark.parametrize("k,n", [(896, 4864), (896, 128), (13696, 4096),
                                 (4096, 256), (6144, 128)])
def test_dense_variant_linears_match_plain(gen, m, k, n):
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    qt = quantize(w, 4, 128)
    kw = dict(bits=4, group_size=128, k=k)
    got = dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    want = ref.dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
    # as test_dequant_matmul_kernel_matches_plain: 4e-5 of the largest sum
    # of |terms|
    bound = (x.to(torch.bfloat16).float().abs()
             @ dequantize(qt).to(torch.bfloat16).float().abs()).max()
    assert float((got - want).abs().max()) <= 4e-5 * float(bound)


# kernel 3 on granite-20b's W4A8 MLP (per-channel, the launcher's
# SmoothQuant default) at a decode M and a prefill M
@pytest.mark.parametrize("m,k,n", [(8, 6144, 24576), (512, 6144, 24576),
                                   (8, 24576, 6144)])
def test_granite_w8a8_linears_match_plain(gen, m, k, n):
    from repro_torch.core.quant.types import quantize_activation
    from repro_torch.kernels.w8a8_matmul import w8a8_matmul_cuda

    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    qt = quantize(w, 4, -1, act_bits=8)
    xq, _ = quantize_activation(x)
    kw = dict(bits=4, group_size=-1, k=k)
    # per-channel: one exact int32 sum over all of K and one rescale, as
    # the plain version: its bits
    assert torch.equal(w8a8_matmul_cuda(xq, qt.qw, qt.scale, **kw),
                       ref.w8a8_matmul_ref(xq, qt.qw, qt.scale, **kw))


# kernel 2 through the wrappers at the dense variants' groups: qwen2-0.5b
# (GQA 14/2: G 7, a dead row in each block of 8), chatglm3-6b (32/2: G 16)
# and granite-20b (MQA 48/1: G 48, six row chunks on a slot's pages),
# decode reads and granite's 64-token prefill chunk, f32 and int8 pools,
# against the wrappers' CPU path on the same inputs
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("kvh,g,hd,m_rows", [
    (2, 7, 64, 1), (2, 16, 128, 1), (1, 48, 128, 1), (1, 48, 128, 64)])
def test_dense_variant_reads_match_plain(gen, kvh, g, hd, m_rows, quant):
    s, ps, w = 5, 16, 20
    fills = [0, 1, 37, 100, 320] if m_rows == 1 else [0, 9, 64, 129, 300]
    n_pages = 1 + s * w
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).cpu()
    bt = torch.full((s, w), -1, dtype=torch.int32)
    nxt = 0
    for si, f in enumerate(fills):
        need = -(-f // ps)
        bt[si, :need] = perm[nxt:nxt + need].to(torch.int32)
        nxt += need
    kf = torch.randn((n_pages, ps, kvh, hd), generator=gen, device="cuda")
    vf = torch.randn((n_pages, ps, kvh, hd), generator=gen, device="cuda")
    ks = vs = None
    if quant:
        ks = kf.abs().amax(-1) / 127.0
        vs = vf.abs().amax(-1) / 127.0
        kf = torch.round(kf / ks[..., None]).to(torch.int8)
        vf = torch.round(vf / vs[..., None]).to(torch.int8)
    kl = torch.tensor(fills, dtype=torch.int32, device="cuda")
    kw = dict(k_scale_pool=ks, v_scale_pool=vs)
    cpu = {k: None if v is None else v.cpu() for k, v in kw.items()}
    before = ops.launch_counts()["paged_attention"]
    if m_rows == 1:
        q = torch.randn((s, kvh * g, hd), generator=gen, device="cuda")
        got = ops.paged_attention(q, kf, vf, bt.cuda(), kl, **kw)
        want = ops.paged_attention(q.cpu(), kf.cpu(), vf.cpu(), bt,
                                   kl.cpu(), **cpu)
    else:
        q = torch.randn((s, m_rows, kvh * g, hd), generator=gen,
                        device="cuda")
        got = ops.paged_attention_prefill(q, kf, vf, bt.cuda(), kl, **kw)
        want = ops.paged_attention_prefill(q.cpu(), kf.cpu(), vf.cpu(), bt,
                                           kl.cpu(), **cpu)
    assert ops.launch_counts()["paged_attention"] == before + 1
    # f32 on both sides, rounding in another order only
    assert float((got.cpu() - want).abs().max()) <= 1e-4
    assert torch.all(got[0] == 0)                 # empty slot: exact zeros


# deepseek-v2-lite (slice 13): kernel 1 on its dense first layer's down
# projection (K 10944: a ragged last 128-row stage of the streaming body,
# per-channel since no whole number of 128-row groups) at a decode M and a
# 256-token prefill M (the tile), and its latent projection wdkv (N 576)
@pytest.mark.parametrize("m,k,n,group", [(8, 10944, 2048, -1),
                                         (256, 10944, 2048, -1),
                                         (8, 2048, 576, 128),
                                         (256, 2048, 576, 128)])
def test_deepseek_linears_match_plain(gen, m, k, n, group):
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    qt = quantize(w, 4, group)
    kw = dict(bits=4, group_size=group, k=k)
    got = dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    want = ref.dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
    # as test_dequant_matmul_kernel_matches_plain: 4e-5 of the largest sum
    # of |terms|
    bound = (x.to(torch.bfloat16).float().abs()
             @ dequantize(qt).to(torch.bfloat16).float().abs()).max()
    assert float((got - want).abs().max()) <= 4e-5 * float(bound)


# kernels 4 and 5 on deepseek-v2-lite's 64 experts: wi / wg 2048 x 1408
# (five whole 256-column strips and a ragged half strip), wo 1408 x 2048
# (11 groups of 128), at decode capacity 8 and a 256-token prefill's 32,
# W4 g128 and per-channel
@pytest.mark.parametrize("c,k,n", [(8, 2048, 1408), (8, 1408, 2048),
                                   (32, 2048, 1408)])
@pytest.mark.parametrize("group", [128, -1])
@pytest.mark.parametrize("act_bits", [0, 8])
def test_deepseek_experts_match_plain(gen, c, k, n, group, act_bits):
    from repro_torch.core.quant.types import quantize_activation, unpack
    from repro_torch.kernels.expert_dequant_matmul import (
        expert_dequant_matmul_cuda)
    from repro_torch.kernels.expert_w8a8_matmul import (
        expert_w8a8_matmul_cuda)

    e = 64
    x, qt = _expert_case(gen, e, c, k, n, 4, group, act_bits)
    kw = dict(bits=4, group_size=group, k=k)
    if act_bits:
        xq, _ = quantize_activation(x.reshape(e * c, k))
        xq = xq.reshape(e, c, k)
        got = expert_w8a8_matmul_cuda(xq, qt.qw, qt.scale, **kw)
        want = ref.expert_w8a8_matmul_ref(xq, qt.qw, qt.scale, **kw)
        rows = torch.arange(k, device="cuda") // (k // qt.scale.shape[-2])
        wabs = (unpack(qt.qw, 4, k).abs().double()
                * qt.scale[:, rows].double())
        bound = 1e-5 * float(torch.matmul(xq.double().abs(), wabs).max())
    else:
        got = expert_dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
        want = ref.expert_dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
        bound = 4e-5 * float(torch.matmul(
            x.to(torch.bfloat16).float().abs(),
            dequantize(qt).to(torch.bfloat16).float().abs()).max())
    assert float((got - want).abs().max()) <= bound
    assert torch.all(got[:, -1] == 0)


# kernel 6 on deepseek-v2-lite's wdkv (N 576: 4.5 of the planner's
# 128-column tiles) and dense down projection (K 10944, per-channel), and
# one layer's expert stack (64 x 2048 x 1408)
@pytest.mark.parametrize("shape,group", [((2048, 576), 128),
                                         ((10944, 2048), -1),
                                         ((64, 2048, 1408), 128)])
def test_deepseek_quantize_pack_matches_plain(gen, shape, group):
    from repro_torch.core.quant.types import compute_scales
    from repro_torch.kernels.quantize_pack import quantize_pack_cuda

    w = torch.randn(shape, generator=gen, device="cuda") / math.sqrt(
        shape[-2])
    scale = compute_scales(w, 4, group)
    got = quantize_pack_cuda(w, scale, bits=4)
    assert torch.equal(got, ref.quantize_pack_ref(w, scale, bits=4))


def _mla_inputs(gen):
    """deepseek-v2-lite's SMOKE config, its prefix block's MLA params
    seeded on the CPU (kvnorm's scale drawn too), and a 21-token input."""
    from repro_torch.models.transformer import init_lm

    cfg = get_smoke_config("deepseek-v2-lite-16b")
    p = init_lm(cfg, seed=0, device="cpu")["prefix"]["0"]["attn"]
    p["kvnorm"]["scale"] = 1 + 0.02 * torch.randn(
        p["kvnorm"]["scale"].shape, generator=torch.Generator().manual_seed(1))
    x = torch.randn((2, 21, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    return cfg, p, x


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("block_kv", [512, 8])
def test_mla_on_the_card_matches_the_cpu(gen, packed, block_kv):
    """``apply_mla`` on the card (the kernels in every packed linear: wukv
    through kernel 1 in the non-absorbed prefill, dequantized in f32 for
    the absorbed decode) against the port on the CPU (their plain
    versions): a prefill into page pools, single-shot and chunked, then
    absorbed decode steps over the gathered pages; outputs and pools."""
    from repro_torch.core.quant.deploy import quantize_params_for_serving
    from repro_torch.models import mla
    from repro_torch.serve.kvcache import PageSpec
    from repro_torch.utils.tree import tree_index

    cfg, p, x = _mla_inputs(gen)
    cfg = cfg.replace(attn_block_kv=block_kv)
    if packed:
        p = quantize_params_for_serving(cfg, p, bits=4, group_size=16,
                                        device="cpu")
    spec = PageSpec(n_pages=9, page_size=4, max_pages=4)
    bt = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32)
    out = {}
    ops.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        from repro_torch.core.quant.deploy import to_device
        pd = to_device(p, torch.device(dev))
        cache = tree_index(mla.init_paged_mla_cache(cfg, spec, dev, 1), 0)
        s = 13
        pos = torch.arange(s, dtype=torch.int32)[None].expand(2, s)
        ys = [mla.apply_mla(cfg, pd, x[:, :s].to(dev),
                            positions=pos.to(dev), cache=cache,
                            paged={"bt_rows": bt.to(dev)}).cpu()]
        for t in range(s, 16):
            clen = torch.full((2,), t, dtype=torch.int32)
            paged = {"block_table": bt, "write_page": bt[:, t // 4],
                     "write_off": clen % 4, "kv_len": clen + 1}
            ys.append(mla.apply_mla(
                cfg, pd, x[:, t:t + 1].to(dev),
                positions=clen[:, None].to(dev), cache=cache, decode=True,
                paged={k: v.to(dev) for k, v in paged.items()}).cpu())
        out[dev] = (ys, {k: v.cpu() for k, v in cache.items()})
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        # f32 on both sides (packed: the same bf16 operands in the kernel
        # and its plain version), sums in another order
        assert float((a - b).abs().max()) <= (2e-4 if packed else 2e-5)
    for key in ("k_pool", "v_pool"):
        assert float((out["cpu"][1][key] - out["cuda"][1][key])
                     .abs().max()) <= 2e-5
    # every packed linear ran kernel 1 on the card: wq, wdkv, wukv and wo
    # in the prefill, wq, wdkv and wo in each of the 3 decode steps
    assert ops.launch_counts()["dequant_matmul"] == (4 + 3 * 3 if packed
                                                     else 0)


# kernels 1 and 3 on mamba2-2.7b's in_proj (2560 x 10576: N = 16 x 661, no
# multiple of 32, so the streaming body's and the tile's last strips are
# ragged) at a decode M and a 256-token prefill, and its out_proj (5120 x
# 2560), W4 g128 (kernel 1) and per-channel (kernel 3)
@pytest.mark.parametrize("m,k,n", [(8, 2560, 10576), (256, 2560, 10576),
                                   (8, 5120, 2560)])
@pytest.mark.parametrize("act_bits", [0, 8])
def test_mamba2_linears_match_plain(gen, m, k, n, act_bits):
    from repro_torch.core.quant.types import quantize_activation, unpack
    from repro_torch.kernels.w8a8_matmul import w8a8_matmul_cuda

    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    if act_bits:
        qt = quantize(w, 4, -1, act_bits=8)
        xq, _ = quantize_activation(x)
        kw = dict(bits=4, group_size=-1, k=k)
        got = w8a8_matmul_cuda(xq, qt.qw, qt.scale, **kw)
        want = ref.w8a8_matmul_ref(xq, qt.qw, qt.scale, **kw)
        # exact group sums rescaled alike, f32 sums in another order
        wabs = unpack(qt.qw, 4, k).abs().double() * qt.scale.double()
        bound = 1e-5 * float((xq.double().abs() @ wabs).max())
    else:
        qt = quantize(w, 4, 128)
        kw = dict(bits=4, group_size=128, k=k)
        got = dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
        want = ref.dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
        bound = 4e-5 * float((x.to(torch.bfloat16).float().abs()
                              @ dequantize(qt).to(torch.bfloat16).float()
                              .abs()).max())
    assert got.shape == (m, n)
    assert float((got - want).abs().max()) <= bound


# kernel 4 on Jamba's expert shapes (wi / wg 8192 x 24576, wo 24576 x
# 8192) at its decode capacity, two experts, W4 g128
@pytest.mark.parametrize("k,n", [(8192, 24576), (24576, 8192)])
def test_jamba_experts_match_plain(gen, k, n):
    from repro_torch.kernels.expert_dequant_matmul import (
        expert_dequant_matmul_cuda)

    x, qt = _expert_case(gen, 2, 8, k, n, 4, 128)
    kw = dict(bits=4, group_size=128, k=k)
    got = expert_dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    want = ref.expert_dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
    bound = 4e-5 * float(torch.matmul(
        x.to(torch.bfloat16).float().abs(),
        dequantize(qt).to(torch.bfloat16).float().abs()).max())
    assert float((got - want).abs().max()) <= bound
    assert torch.all(got[:, -1] == 0)


# kernel 6 on mamba2-2.7b's in_proj stack (N 10576: no multiple of the
# planner's 128-column tiles; 4 of its 64 layers) and out_proj
@pytest.mark.parametrize("shape", [(4, 2560, 10576), (5120, 2560)])
def test_mamba2_quantize_pack_matches_plain(gen, shape):
    from repro_torch.core.quant.types import compute_scales
    from repro_torch.kernels.quantize_pack import quantize_pack_cuda

    w = torch.randn(shape, generator=gen, device="cuda") / math.sqrt(
        shape[-2])
    scale = compute_scales(w, 4, 128)
    got = quantize_pack_cuda(w, scale, bits=4)
    assert torch.equal(got, ref.quantize_pack_ref(w, scale, bits=4))


@pytest.mark.parametrize("packed", [False, True])
def test_mamba_on_the_card_matches_the_cpu(gen, packed):
    """``apply_mamba`` on the card (kernel 1 in the packed in_proj and
    out_proj) against the port on the CPU: a left-padded slot-prefill of
    two prompts into rows (2, 0) of a 3-row cache, then decode steps over
    all three rows; outputs and the state, conv and len rows."""
    from repro_torch.core.quant.deploy import (quantize_params_for_serving,
                                               to_device)
    from repro_torch.models import mamba2
    from repro_torch.models.transformer import init_lm
    from repro_torch.utils.tree import tree_index

    cfg = get_smoke_config("mamba2-2.7b")
    p = init_lm(cfg, seed=0, device="cpu")["stack"]["p0"]["mamba"]
    p = tree_index(p, 0)
    p["dt_bias"] = 0.5 * torch.randn(p["dt_bias"].shape,
                                     generator=torch.Generator().manual_seed(1))
    if packed:
        p = quantize_params_for_serving(cfg, p, bits=4, group_size=32,
                                        device="cpu")
    x = torch.randn((3, 19, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    pos = torch.arange(19, dtype=torch.int32)[None].repeat(2, 1)
    pos[1, :5] = -1
    pos[1, 5:] = torch.arange(14)
    out = {}
    ops.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        pd = to_device(p, torch.device(dev))
        cache = tree_index(mamba2.init_mamba_cache(cfg, 3, dev, n_layers=1),
                           0)
        ys = [mamba2.apply_mamba(
            cfg, pd, x[:2, :16].to(dev), positions=pos[:, :16].to(dev),
            cache=cache,
            slots=torch.tensor([2, 0], dtype=torch.int32, device=dev)).cpu()]
        for t in range(16, 19):
            ys.append(mamba2.apply_mamba(cfg, pd, x[:, t:t + 1].to(dev),
                                         cache=cache, decode=True).cpu())
        out[dev] = (ys, {k: v.cpu() for k, v in cache.items()})
    for a, b in zip(out["cpu"][0], out["cuda"][0]):
        assert float((a - b).abs().max()) <= (2e-4 if packed else 2e-5)
    for key in ("state", "conv"):
        assert float((out["cpu"][1][key] - out["cuda"][1][key])
                     .abs().max()) <= 2e-5
    assert torch.equal(out["cpu"][1]["len"], out["cuda"][1]["len"])
    # in_proj and out_proj on kernel 1: the prefill and 3 decode steps
    assert ops.launch_counts()["dequant_matmul"] == (2 * 4 if packed else 0)


def _ssm_engines(arch, **engine_kw):
    """``arch``'s SMOKE config served on the CPU and on the card: (tokens
    by device, engines, the card run's launch counts, requests, cfg)."""
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ContinuousEngine

    cfg = get_smoke_config(arch)
    params = init_lm(cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, int(rng.integers(4, 40))),
             int(rng.integers(3, 12))) for _ in range(6)]
    out, engines = {}, {}
    for device in ("cpu", "cuda"):
        eng = ContinuousEngine(cfg, params, n_slots=4, max_len=64,
                               page_size=8, device=device, **engine_kw)
        for i, (prompt, max_new) in enumerate(reqs):
            eng.submit(prompt, max_new=max_new, arrival=float(i))
        ops.reset_launch_counts()
        out[device] = [r.tokens for r in eng.run(max_steps=500)]
        engines[device] = eng
        eng.pool.check_invariants()
    return out, engines, ops.launch_counts(), reqs, cfg


def test_mamba2_engine_on_the_card_matches_the_cpu(gen):
    """mamba2 SMOKE served W4 g32 on the card (slot-prefill of co-batched
    prompts, every slot's state stepped): tokens as the CPU's but at
    near-ties, kernel 1 launched and no paged read."""
    out, eng, counts, reqs, cfg = _ssm_engines(
        "mamba2-2.7b", prefill_bucket=8, prefill_batch=2, quant_bits=4,
        quant_group=32)
    assert counts["dequant_matmul"] > 0 and counts["paged_attention"] == 0
    _agree_but_near_ties(cfg, eng["cpu"].params, reqs, out["cpu"],
                         out["cuda"])


def test_jamba_engine_on_the_card_matches_the_cpu(gen):
    """Jamba SMOKE (float) served on the card at the reference's hybrid
    case (prefill_bucket 1, prefill_batch 1): the attention layer's paged
    read on kernel 2 beside the mamba layers' slot rows; the CPU's tokens
    (full-f32 products on both)."""
    out, eng, counts, reqs, cfg = _ssm_engines(
        "jamba-1.5-large-398b", prefill_bucket=1, prefill_batch=1)
    assert counts["paged_attention"] > 0
    assert out["cuda"] == out["cpu"]


# ------------------------------------------------- bf16 operands (slice 18)
#
# Kernels 1 and 4 read a bf16 x as it is and write f32 or bf16; kernel 2
# reads bf16 pools as they are, its q f32 or bf16, its output either. A
# bf16 output is the f32 sum rounded once: against the plain version (the
# same f32 sum in another order, rounded once too) an element may sit one
# bf16 step apart (2^(e-7) for a value in [2^e, 2^(e+1)): at most 2^-7 of
# its size) when the two sums straddle a rounding boundary, besides the
# f32 order bound of the f32 tests above.

BF16_STEP = 2.0 ** -7


def _close(got, want, f32_bound):
    got, want = got.float(), want.float()
    tol = f32_bound + BF16_STEP * want.abs()
    return bool(torch.all((got - want).abs() <= tol))


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("bits,group", [(4, 128), (4, -1), (3, 32), (8, -1),
                                        (2, 64)])
@pytest.mark.parametrize("m,k,n", [(8, 2048, 1024), (1, 256, 200),
                                   (40, 576, 192), (512, 1024, 512),
                                   (130, 256, 200)])
def test_dequant_matmul_bf16_x_matches_plain(gen, m, k, n, bits, group,
                                             out_dtype):
    """Both bodies (the streaming one up to 96 rows, the tile above) on a
    bf16 x, K split or not, writing bf16 or f32."""
    if group != -1 and k % group:
        pytest.skip("the group does not divide K")
    x = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    qt = quantize(w, bits, group)
    kw = dict(bits=bits, group_size=group, k=k, out_dtype=out_dtype)
    before = ops.launch_counts()["dequant_matmul"]
    got = dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    assert ops.launch_counts()["dequant_matmul"] == before + 1
    assert got.dtype == out_dtype
    want = ref.dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
    bound = (x.float().abs()
             @ dequantize(qt).to(torch.bfloat16).float().abs()).max()
    assert _close(got, want, 4e-5 * float(bound))


def test_dequant_matmul_bf16_refuses_per_value_scales(gen):
    x = torch.randn((8, 256), generator=gen, device="cuda").to(torch.bfloat16)
    qt = quantize(torch.randn((256, 64), generator=gen, device="cuda"), 4, 8)
    with pytest.raises(ValueError, match="bf16 x"):
        dequant_matmul_cuda(x, qt.qw, qt.scale, bits=4, group_size=8, k=256)


@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("e,c,k,n,bits,group", [
    (8, 8, 1024, 2048, 4, 128), (4, 8, 2048, 1024, 4, -1),
    (16, 8, 256, 352, 4, 128), (2, 40, 640, 512, 3, 32),
    (3, 136, 256, 256, 8, -1)])
def test_expert_dequant_matmul_bf16_buffer_matches_plain(gen, e, c, k, n,
                                                         bits, group,
                                                         out_dtype):
    from repro_torch.kernels.expert_dequant_matmul import (
        expert_dequant_matmul_cuda)

    x, qt = _expert_case(gen, e, c, k, n, bits, group)
    x = x.to(torch.bfloat16)
    kw = dict(bits=bits, group_size=group, k=k, out_dtype=out_dtype)
    got = expert_dequant_matmul_cuda(x, qt.qw, qt.scale, **kw)
    assert got.dtype == out_dtype
    want = ref.expert_dequant_matmul_ref(x, qt.qw, qt.scale, **kw)
    bound = torch.matmul(x.float().abs(),
                         dequantize(qt).to(torch.bfloat16).float().abs())
    assert _close(got, want, 4e-5 * float(bound.max()))
    assert torch.all(got[:, -1] == 0)


@pytest.mark.parametrize("q_dtype,out_dtype", [
    (torch.bfloat16, torch.bfloat16), (torch.float32, torch.float32),
    (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("m_rows,window,hd,g", [
    (1, None, 64, 4), (5, None, 64, 4), (1, 12, 16, 2), (3, 12, 16, 2),
    (1, None, 128, 6), (16, None, 64, 4)])
def test_paged_attention_bf16_pools_match_plain(gen, m_rows, window, hd, g,
                                                q_dtype, out_dtype):
    """bf16 pools read as they are (no f32 copy before the launch): the
    decode read, the verify rows, a window, a chunk."""
    s, kvh, ps, w = 5, 2, 8, 10
    fills = [0, m_rows, 8, 29, 77]
    n_pages = 1 + s * w
    perm = (torch.randperm(n_pages - 1, generator=gen, device="cuda")
            + 1).cpu()
    bt = torch.full((s, w), -1, dtype=torch.int32)
    nxt = 0
    for si, f in enumerate(fills):
        need = -(-f // ps)
        bt[si, :need] = perm[nxt:nxt + need].to(torch.int32)
        nxt += need
    kb = torch.randn((n_pages, ps, kvh, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vb = torch.randn((n_pages, ps, kvh, hd), generator=gen,
                     device="cuda").to(torch.bfloat16)
    q = torch.randn((s, kvh, m_rows * g, hd), generator=gen,
                    device="cuda").to(q_dtype)
    args = (q, kb, vb, bt.cuda(), torch.tensor(fills, dtype=torch.int32,
                                              device="cuda"))
    before = ops.launch_counts()["paged_attention"]
    got = paged_attention_cuda(*args, window=window, m_rows=m_rows,
                               out_dtype=out_dtype)
    assert ops.launch_counts()["paged_attention"] == before + 1
    assert got.dtype == out_dtype
    want = ref.paged_attention_ref(*args, window=window, m_rows=m_rows,
                                   out_dtype=out_dtype)
    # f32 on both sides over the same upcast values, another order
    assert _close(got, want, 1e-4)
    assert torch.all(got[0] == 0)


def test_bf16_tied_head_matches_the_f32_product(gen):
    """A bf16 tied head on the card (bf16 operands, f32 sums and f32
    logits in one product) against x.float() @ w.float().t() on the same
    normed x: the same exact products, summed in another order, so within
    1e-5 of the largest sum of |terms|."""
    from repro_torch.models.norms import apply_norm
    from repro_torch.models.transformer import _head

    cfg = get_smoke_config("llama3.2-1b").replace(
        dtype="bfloat16", param_dtype="bfloat16", d_model=2048,
        vocab_size=4096)
    assert cfg.tie_embeddings and cfg.logit_softcap == 0
    d, v = cfg.d_model, cfg.vocab_size
    x = torch.randn((3, 5, d), generator=gen, device="cuda").to(
        torch.bfloat16)
    scale = (1 + 0.1 * torch.randn((d,), generator=gen, device="cuda"))
    w = 0.05 * torch.randn((v, d), generator=gen, device="cuda")
    params = {"final_norm": {"scale": scale.to(torch.bfloat16)},
              "embed": {"w": w.to(torch.bfloat16)}}
    with torch.no_grad():
        got = _head(cfg, params, x)
        xn = apply_norm(cfg, params["final_norm"], x)
    assert got.dtype == torch.float32 and got.shape == (3, 5, v)
    wf = params["embed"]["w"].float()
    want = xn.float() @ wf.t()
    bound = (xn.float().abs() @ wf.abs().t()).max()
    assert float((got - want).abs().max()) <= 1e-5 * float(bound)


@pytest.mark.parametrize("sq,block_kv,chunked,scores", [
    (1, 512, False, torch.float32), (1, 1024, True, torch.float32),
    (1, 1024, True, torch.bfloat16), (64, 1024, False, torch.bfloat16)])
def test_bf16_attention_core_reads_the_cache_as_it_is(gen, sq, block_kv,
                                                      chunked, scores):
    """The attention core on bf16 operands on the card (bf16 products
    writing f32 or ``scores_dtype`` sums) against the same function on the
    CPU, which reads the operands as f32: the same exact products summed
    in another order, so the bf16 outputs are within 2 bf16 steps of
    max|v|. A decode query copies nothing of the cache (its peak over the
    call below half of K's own bytes); a multi-row query's stays below
    one f32 copy of K and V (its heads' one bf16 copy of each)."""
    from repro_torch.models.attention import attention_core

    b, skv, h, kvh, hd = 4, 8192, 8, 2, 128
    bf = torch.bfloat16
    q = torch.randn((b, sq, h, hd), generator=gen, device="cuda").to(bf)
    k = torch.randn((b, skv, kvh, hd), generator=gen, device="cuda").to(bf)
    v = torch.randn((b, skv, kvh, hd), generator=gen, device="cuda").to(bf)
    kv_pos = torch.arange(skv, dtype=torch.int32, device="cuda")
    kv_pos = kv_pos[None].expand(b, skv).clone()
    kv_pos[1, 5000:] = -1
    q_pos = (skv - sq + torch.arange(sq, dtype=torch.int32,
                                     device="cuda"))[None].expand(b, sq)
    kw = dict(causal=True, block_kv=block_kv, chunked_decode=chunked,
              scores_dtype=scores)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        got = attention_core(q, k, v, q_pos=q_pos, kv_pos=kv_pos, **kw)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    limit = k.numel() if sq == 1 else 8 * k.numel()
    assert peak < limit, (peak, limit)
    want = attention_core(q.cpu(), k.cpu(), v.cpu(), q_pos=q_pos.cpu(),
                          kv_pos=kv_pos.cpu(), **kw)
    assert got.dtype == bf and got.shape == (b, sq, h, hd)
    err = float((got.cpu().float() - want.float()).abs().max())
    assert err <= 2 * 2.0 ** -7 * float(v.abs().max()), err
