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
        logits = lm_forward(cfg, cpu_params, seq)[0, len(prompt) - 1:-1]
        top2 = torch.topk(logits, 2, dim=-1).values
        for i, (a, b) in enumerate(zip(cpu_toks, gpu_toks)):
            if a != b:
                # a flip is allowed only at a near-tie, and ends the
                # comparable prefix
                assert float(top2[i, 0] - top2[i, 1]) <= 1e-3
                break
