#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds the three CUDA kernels from src/repro_torch/kernels/csrc/ (nvcc, at
first use) and holds each against its plain PyTorch version on the card at
the shapes the main paths give it. Then, with llama3.2-1b at full width and
depth and seeded random weights, it drives three paths, each with the
kernels' launch counts set to 0 just before it and read just after:

  1. serving W4 g128 (RTN-packed) through the port's ContinuousEngine
     (16 requests, 8 slots);
  2. the paper's pipeline through the launcher's ``build_params`` — self-
     generated calibration, then GPTQ W4 g128 + norm tweaking, then
     SmoothQuant W4A8 + norm tweaking — with layer 0 quantized and tweaked
     again on a CPU copy of its inputs and held against the card;
  3. serving the SmoothQuant W4A8 + NT model (the same workload), every
     quantized linear on the W8A8 kernel.

Every served greedy token is held against a plain forward over the same
sequence (on a CPU copy of the served params, where every packed linear
runs its kernel's plain version). Imports nothing of JAX or of the JAX
package. Any failure raises and exits non-zero.

Output, in order: the card's name and power limit (nvidia-smi), the kernel
build time, one line per kernel check, per path its metrics and launch
counts and the plain-path checks, then the JSON line {"kernels": [...]}
and, last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
BF16_TENSOR_FLOPS = 989e12
INT8_TENSOR_OPS = 1979e12
F32_FLOPS = 67e12

SEED = 0
N_REQUESTS = 16
# a served token is held against the plain forward's argmax wherever that
# forward's top-2 logit margin exceeds this: the served path sums in other
# orders (tensor-core tiles, the page walk; the CPU's BLAS for the plain
# forward), and a last-ulp difference can flip a bf16 input rounding and
# cascade through 16 layers, so near-ties may legitimately break either
# way
MARGIN = 0.05
# W4A8 rounds every linear's input to int8 per token, so a last-bit
# difference that flips one int8 code moves that input by a whole step
# (1/127 of the token's amax, not 2^-8 of the value as bf16 does): on
# llama3.2-1b the plain W4A8 forward moves its logits by ~0.6 under a 1e-7
# relative change of its input, far past MARGIN.
# On W4A8 the margin is therefore measured in the run: twice the largest
# logit change of the plain forward when the embedding table is perturbed
# by NOISE relative, and at least MARGIN. So few tokens clear that margin
# that W4A8 also holds every served token to the band below the plain
# top logit (its plain logit must be within the margin of the top), and
# its disagreements with the plain argmax at MARGIN to the count of the
# NOISE-perturbed plain forward's own (check_against_plain)
NOISE = 1e-7


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


class Timer:
    """Device time of one call, averaged over runs, with L2 flushed before
    each run (on the serving path every weight and page is read cold). The
    flush writes 256 MiB (~80 us on an H100), long enough that the host has
    enqueued the timed call before the device reaches the start event, so
    host launch overhead stays out of the reading."""

    def __init__(self, iters: int = 20):
        self.iters = iters
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn) -> float:
        for _ in range(3):
            fn()
        total = 0.0
        for _ in range(self.iters):
            self.flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / self.iters


def sync(device) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                      else "operations")


# ----------------------------------------------------------- kernel phase

def check_dequant_matmul(timer, gen):
    from repro_torch.core.quant.types import dequantize, quantize
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant_matmul import dequant_matmul_cuda

    # (M, K, N, bits, group): llama3.2-1b's four (K, N) linear shapes at a
    # decode M (8 slots) and a prefill M, W4 g128; then bits 2, 3 and 8, a
    # per-channel case, a group of 16 (smaller than the kernel's K step, so
    # one scale per element), and TINY's K = 192 and 576 (per-channel,
    # ragged M)
    cases = [(m, k, n, 4, 128) for m in (8, 512)
             for k, n in ((2048, 2048), (2048, 512), (2048, 8192),
                          (8192, 2048))]
    cases += [(8, 2048, 2048, 2, 128), (8, 2048, 2048, 3, 128),
              (8, 2048, 2048, 8, 128), (8, 2048, 8192, 4, -1),
              (8, 2048, 2048, 4, 16),
              (40, 192, 576, 4, -1), (40, 576, 192, 3, -1)]
    results = []
    for m, k, n, bits, group in cases:
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        qt = quantize(w, bits, group)
        args = (x, qt.qw, qt.scale)
        kw = dict(bits=bits, group_size=group, k=k)
        got = dequant_matmul_cuda(*args, **kw)
        want = ref.dequant_matmul_ref(*args, **kw)
        torch.cuda.synchronize()
        # kernel and plain version multiply the same bf16-rounded operands
        # (products exact in f32) and differ only in the order of the f32
        # sum: allow 4e-5 of the largest sum of |terms|
        xb = x.to(torch.bfloat16).float()
        wb = dequantize(qt).to(torch.bfloat16).float()
        tol = 4e-5 * float((xb.abs() @ wb.abs()).max())
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"dequant_matmul M={m} K={k} N={n} W{bits} "
                                 f"g{group}: max |err| {err} > {tol}")
        xbf, wbf = x.to(torch.bfloat16), wb.to(torch.bfloat16)
        ms = timer(lambda: dequant_matmul_cuda(*args, **kw))
        plain_ms = timer(lambda: ref.dequant_matmul_ref(*args, **kw))
        library_ms = timer(lambda: torch.matmul(xbf, wbf))
        nbytes = (m * k * 4 + qt.qw.numel() + qt.scale.numel() * 4
                  + m * n * 4)
        b_ms, b_by = bound(nbytes, 2.0 * m * k * n, BF16_TENSOR_FLOPS)
        r = dict(shape=[m, k, n], bits=bits, group=group, max_abs_err=err,
                 tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 bound_ms=b_ms, bound_by=b_by)
        print("dequant_matmul", json.dumps(r))
        results.append(r)
    return results


def check_w8a8_matmul(timer, gen):
    from repro_torch.core.quant.types import (quantize, quantize_activation,
                                              unpack)
    from repro_torch.kernels import ref
    from repro_torch.kernels.w8a8_matmul import w8a8_matmul_cuda

    # (M, K, N, bits, group): llama3.2-1b's four (K, N) linear shapes at a
    # decode M (8 slots) and a prefill M, W4 per-channel (the launcher's
    # SmoothQuant default, which the W4A8 serving path runs); then W4 g128,
    # W8 and W3 per-channel, and a ragged M = 5
    cases = [(m, k, n, 4, -1) for m in (8, 512)
             for k, n in ((2048, 2048), (2048, 512), (2048, 8192),
                          (8192, 2048))]
    cases += [(8, 2048, 8192, 4, 128), (512, 2048, 8192, 4, 128),
              (8, 2048, 2048, 8, -1), (8, 2048, 2048, 3, -1),
              (5, 2048, 2048, 4, -1)]
    results = []
    for m, k, n, bits, group in cases:
        x = torch.randn((m, k), generator=gen, device="cuda")
        w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
        qt = quantize(w, bits, group, act_bits=8)
        xq, _ = quantize_activation(x)
        args = (xq, qt.qw, qt.scale)
        kw = dict(bits=bits, group_size=group, k=k)
        got = w8a8_matmul_cuda(*args, **kw)
        want = ref.w8a8_matmul_ref(*args, **kw)
        torch.cuda.synchronize()
        # both take each scale group's sum exactly and rescale it alike;
        # they differ only in the order of the f32 sum over groups and K
        # splits: allow 1e-5 of the largest sum of |group terms|
        q8 = unpack(qt.qw, bits, k).to(torch.int8)
        rows = torch.arange(k, device="cuda") // (k // qt.scale.shape[0])
        wabs = q8.abs().double() * qt.scale[rows].double()
        tol = 1e-5 * float((xq.abs().double() @ wabs).max())
        err = float((got - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"w8a8_matmul M={m} K={k} N={n} W{bits} "
                                 f"g{group}: max |err| {err} > {tol}")
        ms = timer(lambda: w8a8_matmul_cuda(*args, **kw))
        plain_ms = timer(lambda: ref.w8a8_matmul_ref(*args, **kw))
        # yardsticks for per-channel scales (one group: one sum over all of
        # K, rescaled once), on the unpacked int8 weights. library_ms:
        # torch.matmul of bf16 copies of the int8 operands, at every shape:
        # integers up to 127 are exact in bf16, and at W4 and below the
        # f32 accumulation holds every partial sum exactly (|sum| <= 127 x
        # 7 x 8192 < 2^24), though the bf16 output rounds the result. int_mm_ms: torch._int_mm's exact int32 sums, which take
        # M > 16 and K, N multiples of 8. Grouped scales need one sum a
        # group: no single call computes them
        library_ms = int_mm_ms = None
        if group == -1:
            xb, qb = xq.to(torch.bfloat16), q8.to(torch.bfloat16)
            library_ms = timer(lambda: torch.matmul(xb, qb))
            if m > 16 and k % 8 == 0 and n % 8 == 0:
                int_mm_ms = timer(lambda: torch._int_mm(xq, q8))
        nbytes = (m * k + qt.qw.numel() + qt.scale.numel() * 4 + m * n * 4)
        b_ms, b_by = bound(nbytes, 2.0 * m * k * n, INT8_TENSOR_OPS)
        r = dict(shape=[m, k, n], bits=bits, group=group, max_abs_err=err,
                 tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                 int_mm_ms=int_mm_ms, bound_ms=b_ms, bound_by=b_by)
        print("w8a8_matmul", json.dumps(r))
        results.append(r)
    return results


def _paged_case(gen, s, w, ps, kvh, g, hd, fills, quant):
    """Pools of random pages in shuffled order; per-slot fills (0 = an
    empty slot, its table row all -1) with -1 entries past each slot's
    pages."""
    n_pages = 1 + s * w
    perm = torch.randperm(n_pages - 1, generator=gen, device="cuda") + 1
    bt = torch.full((s, w), -1, dtype=torch.int32)
    nxt = 0
    for si, f in enumerate(fills):
        need = -(-f // ps)
        bt[si, :need] = perm[nxt:nxt + need].cpu().to(torch.int32)
        nxt += need
    kf = torch.randn((n_pages, ps, kvh, hd), generator=gen, device="cuda")
    vf = torch.randn((n_pages, ps, kvh, hd), generator=gen, device="cuda")
    if quant:
        def q8(x):
            sc = x.abs().amax(-1).clamp_min(1e-6) / 127.0
            return (torch.round(x / sc[..., None]).clamp(-127, 127)
                    .to(torch.int8), sc)
        (kq, ks), (vq, vs) = q8(kf), q8(vf)
        pools = (kq, vq, ks, vs)
    else:
        pools = (kf, vf, None, None)
    return pools, bt.cuda(), torch.tensor(fills, dtype=torch.int32,
                                          device="cuda")


def check_paged_attention(timer, gen):
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.paged_attention import paged_attention_cuda

    # GQA 32/8, hd 64, page 16 (llama3.2-1b); 8 slots with an empty slot,
    # ragged fills and a full table, at m_rows 1 (decode) and 4 (verify /
    # chunked-prefill rows), f32 and int8 pools
    s, kvh, g, hd, ps, w = 8, 8, 4, 64, 16, 20
    fills = [0, 1, 16, 37, 100, 256, 300, 320]
    results = []
    for m_rows in (1, 4):
        for quant in (False, True):
            f = [x if x == 0 or x >= m_rows else m_rows for x in fills]
            (kp, vp, ks, vs), bt, kl = _paged_case(gen, s, w, ps, kvh, g,
                                                   hd, f, quant)
            q = torch.randn((s, kvh, m_rows * g, hd), generator=gen,
                            device="cuda")
            args = (q, kp, vp, bt, kl, ks, vs)
            got = paged_attention_cuda(*args, m_rows=m_rows)
            want = ref.paged_attention_ref(*args, m_rows=m_rows)
            torch.cuda.synchronize()
            # f32 throughout on both sides; outputs are convex combinations
            # of O(1) values and differ only by rounding in another order
            tol = 1e-4
            err = float((got - want).abs().max())
            if not err <= tol or not torch.all(got[0] == 0):
                raise AssertionError(f"paged_attention m_rows={m_rows} "
                                     f"int8={quant}: max |err| {err}")
            # yardstick: SDPA over the gathered (dequantized) pages with a
            # boolean mask of the same per-row causal limits
            idx = bt.long().clamp_min(0)
            kg = kp[idx].float()
            vg = vp[idx].float()
            if quant:
                kg = kg * ks[idx][..., None]
                vg = vg * vs[idx][..., None]
            kg = kg.reshape(s, w * ps, kvh, hd).permute(0, 2, 1, 3)
            vg = vg.reshape(s, w * ps, kvh, hd).permute(0, 2, 1, 3)
            rows = torch.arange(m_rows * g, device="cuda")
            lim = kl[:, None].long() - (m_rows - 1 - rows // g)[None]
            pos = torch.arange(w * ps, device="cuda")
            mask = (pos[None, None, None, :] < lim[:, None, :, None])
            mask = mask.expand(s, kvh, m_rows * g, w * ps)
            library_ms = timer(lambda: F.scaled_dot_product_attention(
                q, kg, vg, attn_mask=mask))
            ms = timer(lambda: paged_attention_cuda(*args, m_rows=m_rows))
            plain_ms = timer(lambda: ref.paged_attention_ref(
                *args, m_rows=m_rows))
            live_rows = lim.clamp_min(0).sum().item()        # (token, row)
            tok_bytes = kvh * 2 * hd * (1 if quant else 4) + (
                kvh * 2 * 4 if quant else 0)
            nbytes = (q.numel() * 4 + bt.numel() * 4 + kl.numel() * 4
                      + got.numel() * 4 + int(kl.sum()) * tok_bytes)
            flops = live_rows * kvh * 2 * (hd + hd)
            b_ms, b_by = bound(nbytes, flops, F32_FLOPS)
            r = dict(m_rows=m_rows, int8=quant, fills=f, max_abs_err=err,
                     tol=tol, ms=ms, plain_ms=plain_ms,
                     library_ms=library_ms, bound_ms=b_ms, bound_by=b_by)
            print("paged_attention", json.dumps(r))
            results.append(r)
    return results


# ---------------------------------------------------------- serving phase

def serve(cfg, params, label, device="cuda", **quant):
    """Serve the 16-request workload on ``params`` (packed by the engine
    when ``quant`` gives quant_bits); returns (engine, finished requests,
    metrics). The launch counts are reset just before the run and read
    just after it."""
    from repro_torch.kernels import ops
    from repro_torch.serve.engine import ContinuousEngine

    t0 = time.perf_counter()
    engine = ContinuousEngine(cfg, params, n_slots=8, page_size=16,
                              prefill_bucket=16, max_len=320, seed=SEED,
                              device=device, **quant)
    del params                  # the float tree, when the engine packed it
    sync(device)
    print(f"{label} setup: {time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(SEED)
    reqs = []
    for _ in range(N_REQUESTS):
        plen = int(rng.integers(32, 257))
        max_new = int(rng.integers(32, 65))
        prompt = rng.integers(0, cfg.vocab_size, plen)
        reqs.append(engine.submit(prompt, max_new=max_new, arrival=0.0))

    # launches made inside the run's decode blocks, for the per-step counts
    decode_launches = dict.fromkeys(ops.launch_counts(), 0)
    decode_block = engine._decode_block

    def counted_decode_block():
        before = ops.launch_counts()
        toks = decode_block()
        for name, n in ops.launch_counts().items():
            decode_launches[name] += n - before[name]
        return toks

    engine._decode_block = counted_decode_block
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_start = time.perf_counter()
    done = engine.run(clock=lambda: time.perf_counter() - t_start)
    sync(device)
    wall = time.perf_counter() - t_start
    launches = ops.launch_counts()
    per_step = {name: n / engine.n_decode_steps
                for name, n in decode_launches.items()}
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    assert len(done) == N_REQUESTS and all(r.done for r in done)
    n_tok = sum(len(r.tokens) for r in done)
    for r in done:
        assert len(r.tokens) == r.max_new
        assert all(0 <= t < cfg.vocab_size for t in r.tokens)
    engine.pool.check_invariants()
    assert engine.pool.n_free == engine.spec.n_pages - 1
    ttft = np.array([r.ttft for r in done]) * 1e3
    tpot = np.array([r.tpot for r in done]) * 1e3
    stats = dict(path=label, requests=N_REQUESTS, tokens=n_tok, wall_s=wall,
                 tokens_per_s=n_tok / wall,
                 ttft_ms_p50=float(np.percentile(ttft, 50)),
                 ttft_ms_p99=float(np.percentile(ttft, 99)),
                 tpot_ms_p50=float(np.percentile(tpot, 50)),
                 tpot_ms_p99=float(np.percentile(tpot, 99)),
                 decode_steps=engine.n_decode_steps,
                 prefill_calls=engine.n_prefills,
                 prefill_tokens=engine.n_prefill_tokens,
                 peak_mem_gib=peak / 2**30, launches=launches,
                 decode_launches=decode_launches,
                 launches_per_decode_step=per_step)
    print("serve", json.dumps(stats))
    return engine, done, stats


def check_against_plain(cfg, engine, done, measure_margin=False):
    """Every served greedy token equals the plain forward's argmax wherever
    that forward's top-2 margin exceeds the margin: MARGIN, or with
    ``measure_margin`` the margin measured on these sequences (see NOISE).
    The plain forward runs on a CPU copy of the served packed params, where
    every quantized linear runs its kernel's plain version; all sequences
    go in one batch, padded on the right (causal attention keeps the
    padding out of real positions).

    With ``measure_margin`` (W4A8), also:
      * band: every served token's plain logit lies within the margin of
        the plain top logit. Its power is printed: how many vocabulary
        entries lie in the band at each position, and a control that must
        fail it — each request's served tokens held against the next
        request's plain logits, as a server that mixed up its slots would;
      * sensitivity: at MARGIN, the served tokens disagree with the plain
        argmax at no more positions than the plain forward under the NOISE
        perturbation disagrees with itself (a fault in serving — a wrong
        slot's cache, a wrong position — flips far more);
      * the same forward on the card (every linear on its kernel) moves no
        served position's logits by more than the margin from the plain
        ones."""
    from repro_torch.core.quant.deploy import to_device
    from repro_torch.models.transformer import lm_forward

    t0 = time.perf_counter()
    params = to_device(engine.params, "cpu")
    seqs = [np.concatenate([r.prompt, np.asarray(r.tokens, np.int32)])
            for r in done]
    toks = torch.zeros((len(seqs), max(map(len, seqs))), dtype=torch.int64)
    for i, seq in enumerate(seqs):
        toks[i, :len(seq)] = torch.from_numpy(seq.astype(np.int64))
    with torch.no_grad():
        logits = lm_forward(cfg, params, toks)
    served = [slice(r.n_prompt - 1, r.n_prompt - 1 + len(r.tokens))
              for r in done]
    preds = [row[sl] for row, sl in zip(logits, served)]
    served_toks = [torch.tensor(r.tokens, dtype=torch.int64) for r in done]
    margin, noise_preds, card_shift = MARGIN, None, None
    if measure_margin:
        emb = params["embed"]["w"]
        gen = torch.Generator().manual_seed(SEED)
        noisy = dict(params, embed={"w": emb * (1 + NOISE * torch.randn(
            emb.shape, generator=gen))})
        with torch.no_grad():
            shifted = lm_forward(cfg, noisy, toks)
        noise_preds = [row[sl] for row, sl in zip(shifted, served)]
        del shifted
        noise_shift = max(float((a - b).abs().max())
                          for a, b in zip(noise_preds, preds))
        margin = max(MARGIN, 2 * noise_shift)
        with torch.no_grad():
            on_card = lm_forward(cfg, engine.params, toks.to(
                engine.device)).cpu()
        card_shift = max(float((on_card[i, sl] - pred).abs().max())
                         for i, (sl, pred) in enumerate(zip(served, preds)))
        del on_card

    def gap_arg(pred):
        top2 = torch.topk(pred, 2, dim=-1).values
        return top2[:, 0], top2[:, 0] - top2[:, 1], pred.argmax(-1)

    def below_top(pred, top, tok):
        return top - pred[torch.arange(len(tok)), tok]

    compared = agreed = total = 0
    worst = []
    for r, pred, tok in zip(done, preds, served_toks):
        _, gap, arg = gap_arg(pred)
        sel = gap > margin
        total += len(tok)
        compared += int(sel.sum())
        agreed += int((arg[sel] == tok[sel]).sum())
        bad = torch.nonzero(sel & (arg != tok))[:, 0]
        worst += [(r.rid, int(i), float(gap[i])) for i in bad]
    line = dict(tokens=total, compared=compared, agreed=agreed,
                margin=margin, disagreements=worst[:10])
    failed = compared == 0 or agreed != compared
    if measure_margin:
        in_band = control_in = control_total = 0
        served_flips = noise_flips = at_margin = 0
        band_sizes = []
        for i, (pred, noise, tok) in enumerate(zip(preds, noise_preds,
                                                   served_toks)):
            top, gap, arg = gap_arg(pred)
            in_band += int((below_top(pred, top, tok) <= margin).sum())
            band_sizes.append((pred >= (top - margin)[:, None]).sum(-1))
            at = gap > MARGIN
            at_margin += int(at.sum())
            served_flips += int((arg[at] != tok[at]).sum())
            noise_flips += int((noise.argmax(-1)[at] != arg[at]).sum())
            # control: this request's tokens against the next one's logits
            other = preds[(i + 1) % len(preds)]
            n = min(len(tok), len(other))
            o_top = other[:n].max(-1).values
            control_in += int((below_top(other[:n], o_top, tok[:n])
                               <= margin).sum())
            control_total += n
        band = torch.cat(band_sizes).double()
        line.update(
            noise=NOISE, noise_logit_shift=noise_shift,
            card_logit_shift=card_shift, within_margin_of_top=in_band,
            band_size=dict(mean=float(band.mean()),
                           median=float(band.median()),
                           max=int(band.max()),
                           vocab_share=float(band.mean()) / cfg.vocab_size),
            control_other_request=dict(tokens=control_total,
                                       within_margin_of_top=control_in),
            at_fixed_margin=dict(margin=MARGIN, compared=at_margin,
                                 served_disagree=served_flips,
                                 noise_disagree=noise_flips))
        failed = (failed or in_band != total or not card_shift <= margin
                  or control_in >= control_total
                  or served_flips > noise_flips)
    line.update(device="cpu", seconds=time.perf_counter() - t0)
    print("plain_check", json.dumps(line))
    if failed:
        raise AssertionError(f"served tokens disagree with the plain "
                             f"forward: {line}")


# --------------------------------------------------------- pipeline phase

def _packed_leaves(tree, prefix=""):
    """(path, tensor) for every tensor of a block tree, packed weights as
    their codes and scales."""
    from repro_torch.core.quant.types import QuantizedTensor

    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _packed_leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, QuantizedTensor):
        yield prefix + "qw", tree.qw
        yield prefix + "scale", tree.scale
    else:
        yield prefix[:-1], tree


def run_pipeline(cfg, method, device="cuda"):
    """The launcher's ``build_params`` at full size on the card: seeded
    float weights, self-generated calibration, then ``method`` W4 + norm
    tweaking. The pipeline's own ``quantize_block`` and ``tweak_block`` are
    wrapped to record per layer the launches inside the tweak and that the
    tweak changed no non-norm leaf, and to keep layer 0's inputs and
    results for the CPU check. Returns (params, record)."""
    from repro_torch.core.normtweak import pipeline
    from repro_torch.core.quant.deploy import to_device
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as launcher
    from repro_torch.models.norms import is_norm_path
    from repro_torch.utils.tree import tree_partition

    argv = ["--no-smoke", "--arch", "llama3.2-1b", "--method", method,
            "--bits", "4"]
    if method == "gptq":
        argv += ["--group-size", "128"]
    args = launcher.parse_args(argv)
    rec = {"tweak_launches": dict.fromkeys(ops.launch_counts(), 0),
           "non_norm_changed": []}
    real_quantize, real_tweak = pipeline.quantize_block, pipeline.tweak_block

    def quantize_block(bp, taps, **kw):
        out = real_quantize(bp, taps, **kw)
        if "layer0" not in rec:
            rec["layer0"] = dict(block=to_device(bp, "cpu"),
                                 taps=to_device(taps, "cpu"), kw=kw,
                                 qbp=to_device(out, "cpu"))
        return out

    def tweak_block(cfg_, qbp, qx, fout, positions, nt, lr):
        before = ops.launch_counts()
        out, loss = real_tweak(cfg_, qbp, qx, fout, positions, nt, lr)
        for name, n in ops.launch_counts().items():
            rec["tweak_launches"][name] += n - before[name]
        rest_in = dict(_packed_leaves(tree_partition(qbp, is_norm_path)[1]))
        rest_out = _packed_leaves(tree_partition(out, is_norm_path)[1])
        rec["non_norm_changed"] += [
            path for path, t in rest_out
            if t is not None and not torch.equal(t, rest_in[path])]
        if "tweak0" not in rec:
            rec["tweak0"] = dict(qx=qx.cpu(), fout=fout.cpu(),
                                 positions=positions.cpu(), nt=nt, lr=lr,
                                 out=to_device(out, "cpu"))
        return out, loss

    pipeline.quantize_block, pipeline.tweak_block = (quantize_block,
                                                     tweak_block)
    try:
        sync(device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        params, stats = launcher.build_params(cfg, args,
                                              torch.device(device))
        sync(device)
        rec["total_s"] = time.perf_counter() - t0
        rec["launches"] = ops.launch_counts()
    finally:
        pipeline.quantize_block, pipeline.tweak_block = (real_quantize,
                                                         real_tweak)
    rec["stats"] = stats
    return params, rec


def check_pipeline(cfg, method, params, rec):
    """Every quantizable linear packed (with the method's act_bits), no
    non-norm leaf changed by the tweak, the tweak went through the kernel
    of the method's linears, and layer 0 quantized and tweaked again by
    the port on a CPU copy of its inputs agrees with the card.

    Codes: at least 99% equal, at most 0.01% more than one step apart, and
    the GPTQ objective ||X (Q - W)||^2 on the layer's calibration inputs
    within 0.1%. (Not "all within one step": GPTQ's row loop carries each
    row's rounding error onto every later row, so the 1e-11-relative
    difference between the card's and the CPU's f64 inverse and Cholesky
    grows through the loop until it flips roundings in the last third of
    the rows, and a flipped code moves later values by up to |U[i, j] /
    U[i, i]| ~ 1 step: a few codes end 2-3 steps apart.) Norms: the tweak
    deltas within the CPU tests' bounds against the JAX package
    (tests/test_torch_normtweak.py): on W4A8 the same moved channels and
    1e-3 lr; on W4 a mean of 0.5 lr."""
    from repro_torch.core.normtweak.pipeline import tweak_block
    from repro_torch.core.quant.blockquant import quantize_block, tap_key_for
    from repro_torch.core.quant.types import (QuantizedTensor, dequantize,
                                              unpack)
    from repro_torch.utils.tree import tree_get

    act_bits = 8 if method == "smoothquant" else 0
    kernel = "w8a8_matmul" if act_bits else "dequant_matmul"
    paths = ["attn/wq", "attn/wk", "attn/wv", "attn/wo", "mlp/wi", "mlp/wg",
             "mlp/wo"]
    for path in paths:
        w = tree_get(params["stack"]["p0"], path)["w"]
        if not (isinstance(w, QuantizedTensor) and w.act_bits == act_bits
                and w.shape[0] == cfg.n_repeats):
            raise AssertionError(f"{method}: {path} is not packed for all "
                                 f"{cfg.n_repeats} layers: {w!r:.200}")
    if rec["non_norm_changed"]:
        raise AssertionError(f"{method}: the tweak changed non-norm params "
                             f"{rec['non_norm_changed'][:5]}")
    if rec["tweak_launches"][kernel] <= 0:
        raise AssertionError(f"{method}: {kernel} never launched inside the "
                             "tweak")

    t0 = time.perf_counter()
    l0, t0rec = rec["layer0"], rec["tweak0"]
    q_cpu = quantize_block(l0["block"], l0["taps"], **l0["kw"])
    codes = {}
    for path in paths:
        a, b = (tree_get(q, path)["w"] for q in (l0["qbp"], q_cpu))
        diff = (unpack(a.qw, a.bits, a.k) - unpack(b.qw, b.bits, b.k)).abs()
        x = l0["taps"][tap_key_for(path)].reshape(-1, a.k)
        w = tree_get(l0["block"], path)["w"]
        obj = [float(torch.square(x @ (dequantize(q) - w)).sum())
               for q in (a, b)]
        rows = torch.nonzero(diff.amax(dim=1))[:, 0]
        codes[path] = dict(equal=float((diff == 0).float().mean()),
                           over_one=float((diff > 1).float().mean()),
                           max_diff=int(diff.max()),
                           first_diff_row=int(rows[0]) if len(rows) else None,
                           rows=a.k,
                           objective_rel=abs(obj[0] - obj[1]) / obj[1])
        c = codes[path]
        if not (c["equal"] >= 0.99 and c["over_one"] <= 1e-4
                and c["objective_rel"] <= 1e-3):
            raise AssertionError(f"{method} layer 0 {path}: card and CPU "
                                 f"codes differ: {c}")
    tweaked_cpu, _ = tweak_block(cfg, l0["qbp"], t0rec["qx"], t0rec["fout"],
                                 t0rec["positions"], t0rec["nt"],
                                 t0rec["lr"])
    lr = t0rec["lr"]
    norms = {}
    for norm in ("ln1", "ln2"):
        start = l0["qbp"][norm]["scale"]
        d_card = t0rec["out"][norm]["scale"] - start
        d_cpu = tweaked_cpu[norm]["scale"] - start
        err = (d_card - d_cpu).abs()
        norms[norm] = dict(mean_err_lr=float(err.mean()) / lr,
                           max_err_lr=float(err.max()) / lr,
                           mean_delta_lr=float(d_card.abs().mean()) / lr,
                           same_moved=bool(torch.equal(d_card != 0,
                                                       d_cpu != 0)))
        ok = (norms[norm]["same_moved"] and norms[norm]["max_err_lr"] <= 1e-3
              if act_bits else norms[norm]["mean_err_lr"] <= 0.5)
        if not ok:
            raise AssertionError(f"{method} layer 0 {norm}: card and CPU "
                                 f"tweaks differ: {norms[norm]}")
    return dict(codes=codes, norms=norms, seconds=time.perf_counter() - t0)


def pipeline_phase(cfg, method, device="cuda"):
    params, rec = run_pipeline(cfg, method, device)
    st = rec["stats"]
    check = check_pipeline(cfg, method, params, rec)
    line = dict(method=method, total_s=rec["total_s"], calib_s=st["calib_s"],
                quant_s=sum(st["layer_quant_s"]),
                tweak_s=sum(st["layer_tweak_s"]),
                forward_s=sum(st["layer_forward_s"]),
                layer_quant_s=st["layer_quant_s"],
                layer_tweak_s=st["layer_tweak_s"],
                layer_forward_s=st["layer_forward_s"],
                layer_l_dist=st["layer_loss"], layer_lr=st["layer_lr"],
                launches=rec["launches"],
                tweak_launches=rec["tweak_launches"], layer0_cpu=check)
    print("pipeline", json.dumps(line))
    return params, line


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: the port is not at {src}/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    from repro_torch.configs import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import build
    from repro_torch.models.transformer import init_lm

    resolve_device("cuda")            # pins full-f32 matmuls (no TF32)
    print(nvidia_smi())
    t0 = time.perf_counter()
    built = build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s "
          f"(compiled: {', '.join(built) or 'none, cached'})")

    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    timer = Timer()
    dq = check_dequant_matmul(timer, gen)
    w8 = check_w8a8_matmul(timer, gen)
    pa = check_paged_attention(timer, gen)
    del timer
    torch.cuda.empty_cache()

    cfg = get_config("llama3.2-1b")
    # path 1 (slice 1): W4 g128 serving
    engine, done, w4 = serve(cfg, init_lm(cfg, seed=SEED, device="cuda"),
                             "serve_w4", quant_bits=4, quant_group=128)
    check_against_plain(cfg, engine, done)
    for name in ("dequant_matmul", "paged_attention"):
        if w4["launches"][name] <= 0:
            raise AssertionError(f"{name} was never launched serving W4")
    # the counting wrapper makes the engine a reference cycle: collect it
    del engine, done
    gc.collect()
    torch.cuda.empty_cache()

    # path 2: the paper's pipeline, GPTQ W4 g128 + NT, SmoothQuant W4A8 + NT
    params, gptq = pipeline_phase(cfg, "gptq")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    params, sq = pipeline_phase(cfg, "smoothquant")

    # path 3: serving the SmoothQuant W4A8 + NT model
    engine, done, w4a8 = serve(cfg, params, "serve_w4a8")
    del params
    check_against_plain(cfg, engine, done, measure_margin=True)
    per_step = w4a8["launches_per_decode_step"]
    n_linears = 7 * cfg.n_repeats
    if (per_step["w8a8_matmul"] != n_linears
            or w4a8["launches"]["dequant_matmul"] != 0
            or w4a8["launches"]["paged_attention"] <= 0):
        raise AssertionError(f"W4A8 serving: want {n_linears} W8A8 launches "
                             f"per decode step, paged attention and no "
                             f"dequant launch, got "
                             f"{per_step}, {w4a8['launches']}")

    def entry(name, source, replaces, cases, main_case, path):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=path["launches"][name],
                    launches_per_decode_step=path[
                        "launches_per_decode_step"][name],
                    path=path["path"],
                    launches_by_path=dict(
                        serve_w4=w4["launches"][name],
                        pipeline_gptq=gptq["launches"][name],
                        pipeline_smoothquant=sq["launches"][name],
                        serve_w4a8=w4a8["launches"][name]),
                    max_abs_err=max(c["max_abs_err"] for c in cases),
                    ms=main_case["ms"], plain_ms=main_case["plain_ms"],
                    bound_ms=main_case["bound_ms"],
                    bound_by=main_case["bound_by"],
                    library_ms=main_case["library_ms"], main_case=main_case,
                    cases=cases)

    # the entries' times are at the decode shape the serving paths run
    # most: M = 8 slots x the 2048 x 8192 MLP linears (W4 g128 for the
    # dequant matmul, W4 per-channel for the W8A8 matmul), and the
    # m_rows = 1 f32-pool read over ragged fills
    dq_main = next(c for c in dq if c["shape"] == [8, 2048, 8192]
                   and c["bits"] == 4 and c["group"] == 128)
    w8_main = next(c for c in w8 if c["shape"] == [8, 2048, 8192]
                   and c["bits"] == 4 and c["group"] == -1)
    pa_main = next(c for c in pa if c["m_rows"] == 1 and not c["int8"])
    print(json.dumps({"kernels": [
        entry("dequant_matmul", "src/repro_torch/kernels/csrc/dequant_matmul.cu",
              "src/repro/kernels/dequant_matmul.py:43", dq, dq_main, w4),
        entry("w8a8_matmul", "src/repro_torch/kernels/csrc/w8a8_matmul.cu",
              "src/repro/kernels/w8a8_matmul.py:36", w8, w8_main, w4a8),
        entry("paged_attention",
              "src/repro_torch/kernels/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention.py:64", pa, pa_main, w4),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
