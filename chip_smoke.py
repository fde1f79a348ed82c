#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (H100, sm_90a).

    python3 chip_smoke.py

Builds both CUDA kernels from src/repro_torch/kernels/csrc/ (nvcc, at first
use), holds each against its plain PyTorch version on the card at the
shapes the serving path gives it, then serves 16 requests with
llama3.2-1b at full width and depth (seeded random weights, packed W4
g128) through the port's ContinuousEngine, and holds every served greedy
token against a plain forward over the same sequence (on a CPU copy of the
served params, where every packed linear runs its kernel's plain version).
Imports nothing of JAX or of the JAX package. Any failure raises and exits
non-zero.

Output, in order: the card's name and power limit (nvidia-smi), the kernel
build time, one line per kernel check, the serving metrics and launch
counts, the plain-path check, then the JSON line {"kernels": [...]} and,
last, {"ok": true, "device": {...}}.
"""
from __future__ import annotations

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

def serve(cfg, device="cuda"):
    from repro_torch.kernels import ops
    from repro_torch.models.transformer import init_lm
    from repro_torch.serve.engine import ContinuousEngine

    t0 = time.perf_counter()
    params = init_lm(cfg, seed=SEED, device=device)
    engine = ContinuousEngine(cfg, params, quant_bits=4, quant_group=128,
                              n_slots=8, page_size=16, prefill_bucket=16,
                              max_len=320, seed=SEED, device=device)
    del params
    sync(device)
    print(f"serve setup: init + W4 g128 packing {time.perf_counter() - t0:.2f}"
          " s")
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
    stats = dict(requests=N_REQUESTS, tokens=n_tok, wall_s=wall,
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
    if device == "cuda":
        for name, n in launches.items():
            if n <= 0:
                raise AssertionError(f"kernel {name} was never launched on "
                                     "the serving path")
    return engine, done, stats


def check_against_plain(cfg, engine, done):
    """Every served greedy token equals the plain forward's argmax wherever
    that forward's top-2 margin exceeds MARGIN. The forward runs on a CPU
    copy of the served packed params, where every quantized linear runs
    its kernel's plain version; all sequences go in one batch, padded on
    the right (causal attention keeps the padding out of real positions)."""
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
    compared = agreed = total = 0
    worst = []
    for r, row in zip(done, logits):
        pred = row[r.n_prompt - 1:r.n_prompt - 1 + len(r.tokens)]
        top2 = torch.topk(pred, 2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).numpy()
        arg = pred.argmax(-1).numpy()
        served = np.asarray(r.tokens)
        sel = margin > MARGIN
        total += len(served)
        compared += int(sel.sum())
        agreed += int((arg[sel] == served[sel]).sum())
        bad = np.nonzero(sel & (arg != served))[0]
        worst += [(r.rid, int(i), float(margin[i])) for i in bad]
    line = dict(tokens=total, compared=compared, agreed=agreed,
                margin=MARGIN, device="cpu",
                seconds=time.perf_counter() - t0, disagreements=worst[:10])
    print("plain_check", json.dumps(line))
    if compared == 0 or agreed != compared:
        raise AssertionError(f"served tokens disagree with the plain "
                             f"forward: {line}")


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
    pa = check_paged_attention(timer, gen)
    del timer
    torch.cuda.empty_cache()

    cfg = get_config("llama3.2-1b")
    engine, done, stats = serve(cfg)
    check_against_plain(cfg, engine, done)

    def entry(name, source, replaces, cases, main_case):
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=stats["launches"][name],
                    launches_per_decode_step=stats[
                        "launches_per_decode_step"][name],
                    max_abs_err=max(c["max_abs_err"] for c in cases),
                    ms=main_case["ms"], plain_ms=main_case["plain_ms"],
                    bound_ms=main_case["bound_ms"],
                    bound_by=main_case["bound_by"],
                    library_ms=main_case["library_ms"], main_case=main_case,
                    cases=cases)

    # the entries' times are at the decode shape the serving path runs
    # most: M = 8 slots x the 2048 x 8192 MLP linears, and the m_rows = 1
    # f32-pool read over ragged fills
    dq_main = next(c for c in dq if c["shape"] == [8, 2048, 8192]
                   and c["bits"] == 4 and c["group"] == 128)
    pa_main = next(c for c in pa if c["m_rows"] == 1 and not c["int8"])
    print(json.dumps({"kernels": [
        entry("dequant_matmul", "src/repro_torch/kernels/csrc/dequant_matmul.cu",
              "src/repro/kernels/dequant_matmul.py:43", dq, dq_main),
        entry("paged_attention",
              "src/repro_torch/kernels/csrc/paged_attention.cu",
              "src/repro/kernels/paged_attention.py:64", pa, pa_main),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
