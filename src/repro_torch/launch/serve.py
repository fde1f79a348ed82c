"""Serving launcher: quantize (GPTQ/RTN/SmoothQuant ± Norm-Tweaking) and
drive the continuous-batching engine with seeded traffic, reporting
throughput and per-request latency percentiles (port of
``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
        --smoke --bits 4 --method gptq --requests 16 --rate 8.0

runs on the card; ``--device cpu`` runs every kernel's plain version
instead. ``--no-smoke`` runs the full-size config. The paper's pipeline
(``build_params``): seeded float weights, 8 self-generated calibration
samples of 32 tokens, then ``norm_tweak_ptq`` — ``--method smoothquant``
is W4A8 (per-token int8 activations, the W8A8 kernel), ``--no-tweak``
the plain quantizer. Traffic shapes come from serve/traffic.py
(``--trace poisson|bursty|uniform``; ``--batch-frac`` labels that share of
requests batch-class; ``--shared-prefix N`` starts every prompt with the
same N tokens). ``--virtual-clock`` drives the run on the deterministic
step clock instead of wall time.

``--prefix-share`` reuses full prompt-prefix pages across requests and
``--chunked-prefill N`` caps a prefill call at N tokens a slot;
``--spec-decode`` (float params: ``--method none``) serves with a packed
``--draft-bits`` 2 or 3 draft of the same params proposing up to
``--spec-k`` tokens a round, and the report gives its acceptance.

Overload and faults (serve/scheduler.py, serve/faults.py): ``--preempt``
arms priority scheduling with KV spill (interactive requests evict batch
victims under pressure, ``--age-promote`` bounds batch starvation) and the
report gives the preemption and spill counters; ``--deadline T`` gives
every request an SLO of T time units after its arrival (missed: shed from
the queue or cancelled mid-run); ``--faults SEED`` injects a seeded chaos
schedule (NaN logits, pool exhaustion, kernel faults, corrupt spills,
latency spikes, one crash) and serves through it with ``run_resilient``,
each crash recovered from the last snapshot; ``--snapshot-every N``
snapshots the engine every N steps. Faults and snapshots run on the
virtual clock. ``--engine static`` runs the static-batch ``ServeEngine``
on the same workload (groups of one prompt length, lockstep decode),
``--engine both`` the two side by side.

``--tp N`` serves tensor-parallel over N ranks, one process each: the
launcher spawns them (or, started by ``torchrun --nproc-per-node N``,
runs as the rank torchrun made), every rank runs this same program on its
shard, and rank 0 prints. The process group's backend is ``gloo`` for
``--device cpu`` and ``nccl`` for the card; ``--dist-backend`` overrides
it. Several ranks on one card need ``--dist-backend gloo`` (NCCL refuses
two ranks on one device). ``--tp`` with the static engine is refused, as
by the JAX launcher.
``--arch whisper-medium`` is refused, as by the JAX launcher (the
encoder-decoder has no paged serving; ``models/encdec.py`` serves it on
contiguous caches); ``--arch internvl2-2b`` is served as a text LM, with
no patch embeddings, as the JAX launcher serves it.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.registry import list_archs
from repro_torch.core.calibration.generator import generate_calibration
from repro_torch.core.normtweak.pipeline import NTConfig, norm_tweak_ptq
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_lm
from repro_torch.serve import traffic
from repro_torch.serve.engine import (ContinuousEngine, ServeEngine,
                                      attention_only_refusal)
from repro_torch.serve.faults import FaultPlan, run_resilient


def tree_size_bytes(tree) -> int:
    """Bytes of every tensor in a param tree (packed weights: codes and
    scales)."""
    if isinstance(tree, dict):
        return sum(tree_size_bytes(v) for v in tree.values())
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    return tree_size_bytes({"qw": tree.qw, "scale": tree.scale})


def build_params(cfg, args, device):
    """Seeded float params, then (unless ``--method none``) self-generated
    calibration and the norm-tweaking pipeline. Returns (params, stats:
    the pipeline's per-layer record plus "calib_s", or None)."""
    params = init_lm(cfg, seed=0, device=device)
    print(f"{cfg.name}: float {tree_size_bytes(params) / 1e6:.1f} MB")
    if args.method == "none":
        return params, None
    gen = torch.Generator(device=device)
    gen.manual_seed(1)
    t0 = time.perf_counter()
    calib = generate_calibration(cfg, params, gen, n_samples=8,
                                 token_length=32)
    if device.type == "cuda":
        torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    nt = NTConfig(method=args.method, bits=args.bits,
                  group_size=args.group_size, tweak=not args.no_tweak,
                  lr0=1e-3, iters=1, sample_batch=4,
                  act_bits=8 if args.method == "smoothquant" else 0)
    params, stats = norm_tweak_ptq(cfg, params, calib, nt,
                                   log=lambda s: print("  " + s))
    stats["calib_s"] = calib_s
    print(f"quantized: {tree_size_bytes(params) / 1e6:.1f} MB "
          f"(W{args.bits}{'A8' if nt.act_bits else ''}"
          f"{'+NT' if nt.tweak else ''}); calibration {calib_s:.2f} s, "
          f"quantization {sum(stats['layer_quant_s']):.2f} s, tweak "
          f"{sum(stats['layer_tweak_s']):.2f} s")
    return params, stats


def make_workload(cfg, args):
    """Seeded trace from the traffic harness (serve/traffic.py)."""
    return traffic.make_trace(
        kind=args.trace, n=args.requests,
        rate=args.rate if args.rate > 0 else 1e9,
        seed=args.seed, vocab_size=cfg.vocab_size,
        prompt_len=(args.prompt_len_min, args.prompt_len_max),
        max_new=(args.max_new_min, args.max_new_max),
        batch_frac=args.batch_frac,
        burst_len=args.burst_len, idle_len=args.idle_len,
        burst_rate_mult=args.burst_rate_mult,
        shared_prefix=args.shared_prefix, deadline=args.deadline)


def run_continuous(cfg, params, work, args, device):
    """Warm the engine on every prefill bucket of the workload (with
    ``--prefix-share`` in two waves, the second hitting the shared-prefix
    floor so the suffix-prefill shapes run too), reset its counters, clock,
    step index and the prefix index, then replay the trace: plainly, or
    with ``--faults`` / ``--snapshot-every`` through ``run_resilient``
    (which builds, and after a crash rebuilds, the engine this way).
    Returns (engine, report)."""
    plen_max = max(len(it.prompt) for it in work)
    bucket_up = -(-plen_max // args.prefill_bucket) * args.prefill_bucket

    def build():
        eng = ContinuousEngine(cfg, params, n_slots=args.slots,
                               max_len=bucket_up + args.max_new_max,
                               page_size=args.page_size,
                               prefill_bucket=args.prefill_bucket,
                               prefix_share=args.prefix_share,
                               chunked_prefill=args.chunked_prefill,
                               spec_decode=args.spec_decode,
                               draft_bits=args.draft_bits,
                               spec_k=args.spec_k, preempt=args.preempt,
                               age_promote=args.age_promote,
                               seed=args.seed, tp=args.tp, device=device)
        if args.tp > 1:
            rep = eng.tp_placement_report()
            print(f"tensor-parallel x{args.tp}: params "
                  f"{rep['params']['per_device_bytes'] / 1e6:.1f} MB/device "
                  f"(global {rep['params']['global_bytes'] / 1e6:.1f} MB), "
                  f"KV pools "
                  f"{rep['kv']['per_device_bytes'] / 1e6:.1f} MB/device")
        buckets = sorted({eng._bucket(len(it.prompt)) for it in work})
        waves = 2 if args.prefix_share else 1
        shared_floor = ((args.shared_prefix // args.page_size)
                        * args.page_size if args.prefix_share else 0)
        for wave in range(waves):
            for b in buckets:
                for mn in sorted({2, args.max_new_max}):
                    p = np.zeros(b, np.int64)
                    if wave > 0 and 0 < shared_floor < b:
                        p[shared_floor:] = 1
                    eng.submit(p, max_new=mn)
            eng.run(max_steps=10_000)
        print(f"warmed {len(buckets)} prefill buckets ({waves} "
              f"wave{'s' if waves > 1 else ''}): {buckets}")
        # the report covers the timed run alone: counters, the clock, the
        # step index (fault plans are step-indexed), the event log and the
        # warm-up prompts' prefix registrations go
        eng.t = 0
        eng.n_steps_total = 0
        eng.n_decode_steps = eng.n_prefills = eng.n_prefill_tokens = 0
        eng.n_shared_tokens = 0
        eng.n_spilled_pages = eng.n_restored_pages = 0
        eng.n_spec_rounds = eng.n_draft_tokens = eng.n_spec_emitted = 0
        eng.spec_accept_sum[:] = 0
        eng.spec_round_count[:] = 0
        eng.sched.events.clear()
        for k in eng.sched._COUNTERS:
            setattr(eng.sched, k, 0)
        eng.pool.clear_prefix_cache()
        return eng

    resilient = args.faults is not None or args.snapshot_every > 0
    if resilient:
        plan = (FaultPlan.seeded(args.faults, n_steps=max(64, 4 * len(work)),
                                 n_slots=args.slots, crashes=1)
                if args.faults is not None else None)
        t0 = time.perf_counter()
        res = run_resilient(build, work, faults=plan,
                            snapshot_every=args.snapshot_every,
                            max_steps=1_000_000)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0       # includes the warm-ups
        eng, report = res["engine"], res["report"]
        print(f"resilient: {res['n_crashes']} crash(es) recovered from "
              f"snapshot, {res['n_snapshots']} periodic snapshots"
              + (f", fault plan {plan!r}" if plan is not None else ""))
    else:
        eng = build()
        if device.type == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        clock = None if args.virtual_clock else (
            lambda: time.perf_counter() - t0)
        report = traffic.replay(eng, work, clock=clock, max_steps=1_000_000)
        if device.type == "cuda":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    done = report["requests"]
    total_tok = sum(len(r.tokens) for r in done)
    print(f"continuous: {len(done)} requests, {total_tok} tokens in "
          f"{dt:.2f}s ({total_tok / dt:.1f} tok/s; {eng.n_decode_steps} "
          f"decode steps, {eng.n_prefills} prefills)")
    print(f"  prefilled {eng.n_prefill_tokens} prompt tokens, "
          f"{eng.n_shared_tokens} reused from the prefix cache "
          f"({eng.pool.n_cached} pages cached)")
    if args.preempt:
        sc, sp = report["scheduler"], report["spill"]
        print(f"  overload {sc['n_preemptions']} preemptions "
              f"({sp['spilled_pages']} pages spilled, "
              f"{sp['restored_pages']} restored), "
              f"{sc['n_rejected']} rejected, "
              f"{sc['n_finished_preempted']} finished after preemption")
    virtual = args.virtual_clock or resilient
    print(traffic.format_report(report, unit="steps" if virtual else "s"))
    if args.spec_decode:
        st = eng.spec_stats()
        print(f"  spec     {st['rounds']} rounds, {st['draft_tokens']} draft "
              f"tokens proposed, {st['accepted_draft_tokens']} accepted "
              f"(rate {st['acceptance_rate']:.3f})")
        print(f"  accepted len  mean {st['mean_accepted_len']:.2f} "
              f"tokens/slot-round, per slot "
              f"{st['per_slot_mean_accepted_len']}")
    print("request 0:", done[0].tokens)
    return eng, report


def run_static(cfg, params, work, args, device):
    """The static-batch baseline on the same workload: requests grouped by
    prompt length, up to ``--slots`` a batch, each batch decoded in
    lockstep to its longest budget. Returns (engine, report: requests,
    useful tokens, seconds, tokens per second)."""
    eng = ServeEngine(cfg, params, device=device)
    groups: dict[int, list] = {}
    for it in work:
        groups.setdefault(len(it.prompt), []).append((it.prompt, it.max_new))
    t0 = time.perf_counter()
    total = 0
    for _, items in sorted(groups.items()):
        for i in range(0, len(items), args.slots):
            chunk = items[i:i + args.slots]
            eng.generate(np.stack([p for p, _ in chunk]),
                         max_new=max(m for _, m in chunk))
            total += sum(m for _, m in chunk)
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"static: {len(work)} requests, {total} useful tokens in "
          f"{dt:.2f}s ({total / dt:.1f} tok/s, first calls included)")
    return eng, dict(requests=len(work), tokens=total, seconds=dt,
                     tokens_per_s=total / dt)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b",
                    choices=["tiny"] + list_archs())
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="use the reduced config of --arch (--no-smoke for "
                         "full size)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu (their plain "
                         "versions)")
    ap.add_argument("--method", default="gptq",
                    choices=["gptq", "rtn", "smoothquant", "none"])
    ap.add_argument("--bits", type=int, default=4)
    ap.add_argument("--group-size", type=int, default=-1)
    ap.add_argument("--no-tweak", action="store_true")
    ap.add_argument("--engine", default="continuous",
                    choices=["continuous", "static", "both"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=8.0,
                    help="arrival rate, req/s (0 = all at t=0)")
    ap.add_argument("--trace", default="poisson",
                    choices=["poisson", "bursty", "uniform"])
    ap.add_argument("--batch-frac", type=float, default=0.5,
                    help="fraction of requests labelled batch-class "
                         "(deterministic stride, not sampled)")
    ap.add_argument("--burst-len", type=float, default=4.0)
    ap.add_argument("--idle-len", type=float, default=8.0)
    ap.add_argument("--burst-rate-mult", type=float, default=8.0)
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common system prompt of this many "
                         "tokens to every request")
    ap.add_argument("--virtual-clock", action="store_true",
                    help="drive the run on the deterministic step clock "
                         "instead of wall time")
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--prefill-bucket", type=int, default=16)
    ap.add_argument("--prompt-len-min", type=int, default=8)
    ap.add_argument("--prompt-len-max", type=int, default=64)
    ap.add_argument("--max-new-min", type=int, default=8)
    ap.add_argument("--max-new-max", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prefix-share", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="reuse full prompt-prefix pages across requests")
    ap.add_argument("--chunked-prefill", type=int, default=0,
                    help="max tokens a prefill call takes a slot, rounded "
                         "to pages (0 = the whole prompt in one call)")
    ap.add_argument("--spec-decode", action="store_true",
                    help="self-speculative decoding: a packed draft of the "
                         "same params proposes, the target verifies "
                         "(greedy output is the target-only stream)")
    ap.add_argument("--draft-bits", type=int, default=2, choices=(2, 3),
                    help="the draft's weight width")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="most draft proposals a round")
    ap.add_argument("--preempt", action="store_true",
                    help="priority scheduling with KV spill: interactive "
                         "arrivals evict batch victims to host RAM under "
                         "slot or page pressure")
    ap.add_argument("--age-promote", type=float, default=None,
                    help="promote a batch request to interactive standing "
                         "after waiting this long (starvation bound)")
    ap.add_argument("--deadline", type=float, default=None,
                    help="per-request SLO: shed from the queue or cancel "
                         "mid-run a request unfinished this many time "
                         "units after its arrival")
    ap.add_argument("--faults", type=int, default=None, metavar="SEED",
                    help="inject a seeded chaos schedule and serve through "
                         "it with the crash-recovery driver (virtual "
                         "clock)")
    ap.add_argument("--snapshot-every", type=int, default=0,
                    help="snapshot the engine every N steps (0 = off); a "
                         "crash recovers from the latest")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel width of the continuous engine: "
                         "N ranks, one process each")
    ap.add_argument("--dist-backend", default=None,
                    choices=["gloo", "nccl"],
                    help="the ranks' process-group backend (default: gloo "
                         "for --device cpu, nccl for the card; several "
                         "ranks on one card need gloo)")
    args = ap.parse_args(argv)
    if args.tp > 1 and args.engine != "continuous":
        # the static baseline has no TP path
        raise SystemExit("--tp applies to the continuous engine only "
                         "(use --engine continuous)")
    if args.spec_decode and args.engine != "continuous":
        raise SystemExit("--spec-decode applies to the continuous engine "
                         "only (use --engine continuous)")
    if args.spec_decode and args.method != "none":
        # the pipeline hands back packed weights; the engine packs its own
        # draft from the float params and refuses a packed tree
        raise SystemExit("--spec-decode quantizes its own low-bit draft "
                         "from the float params; use --method none")
    return args


def _rank_main(rank: int, world: int, argv):
    """One rank of a ``--tp`` run: the launcher on this rank's shard,
    printing on rank 0 only; returns the served tokens by request."""
    out = contextlib.nullcontext() if rank == 0 else \
        contextlib.redirect_stdout(io.StringIO())
    with out:
        _, report, _ = _serve(parse_args(argv), rank)
    return [list(r.tokens) for r in report["requests"]]


def main(argv=None):
    """Run the launcher; returns (engine, report, pipeline stats): the
    continuous engine's when it runs (with ``--engine both`` the static
    run's report under report["static"]), else the static engine's.

    With ``--tp N`` outside a process group it spawns the N ranks and
    returns (None, every rank's served tokens by request, None); started
    by torchrun it joins torchrun's group and runs as its rank."""
    args = parse_args(argv)
    if args.tp > 1 and not dist.is_initialized():
        from repro_torch.launch.spawn import default_backend, run_ranks

        backend = args.dist_backend or default_backend(args.device)
        if "WORLD_SIZE" in os.environ:        # torchrun made this rank
            dist.init_process_group(backend, init_method="env://")
            rank = dist.get_rank()
            try:
                out = contextlib.nullcontext() if rank == 0 else \
                    contextlib.redirect_stdout(io.StringIO())
                with out:
                    return _serve(args, rank)
            finally:
                dist.destroy_process_group()
        print(f"--tp {args.tp}: {args.tp} ranks, backend {backend}")
        argv = sys.argv[1:] if argv is None else list(argv)
        tokens = run_ranks(_rank_main, args.tp, backend=backend,
                           args=(argv,), timeout=24 * 3600.0)
        return None, tokens, None
    return _serve(args, dist.get_rank() if dist.is_initialized() else 0)


def _serve(args, rank: int):
    """The launcher's run on this process (one rank of ``--tp``, or the
    only one)."""
    if args.tp > 1 and args.device != "cpu" and torch.cuda.device_count():
        torch.cuda.set_device(rank % torch.cuda.device_count())
    device = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.enc_dec:
        # the JAX launcher's refusal, word for word: whisper has no paged
        # serving (models/encdec.py serves it on contiguous caches)
        raise SystemExit("whisper serving demo lives in tests/test_system.py")
    why = attention_only_refusal(cfg, preempt=args.preempt,
                                 prefix_share=args.prefix_share,
                                 chunked_prefill=args.chunked_prefill,
                                 spec_decode=args.spec_decode)
    if why and args.engine != "static":
        raise SystemExit(f"--arch {args.arch}: {why}")
    params, stats = build_params(cfg, args, device)
    work = make_workload(cfg, args)
    eng = report = None
    if args.engine in ("continuous", "both"):
        eng, report = run_continuous(cfg, params, work, args, device)
    if args.engine in ("static", "both"):
        s_eng, s_report = run_static(cfg, params, work, args, device)
        if report is None:
            eng, report = s_eng, s_report
        else:
            report["static"] = s_report
    return eng, report, stats


if __name__ == "__main__":
    main()
