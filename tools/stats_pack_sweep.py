"""Time variants of kernel 7 (channel statistics) or kernel 6
(quantize-pack) on the card, geometry by geometry.

    python3 tools/stats_pack_sweep.py stats|pack [--variants JSON]
        [--out FILE]

A variant is a JSON object of the source's ``constexpr int`` constants
(``csrc/channel_stats.cu``: STRIP, TILE, STAGES; ``csrc/quantize_pack.cu``:
RUNS, RUN_ROWS) and of the wrapper module's planner constants
(TARGET_BLOCKS, MAX_RANKS; GRID_BLOCKS), each overriding the committed
value; ``{}`` is the committed kernel. Every variant's source is written
under ``build/sweep/``, all are compiled together with the flags of
``kernels/build.py``, and each is loaded in place of the committed
library, held against the plain version at the main shapes (kernel 7
within chip_smoke.py's limits, kernel 6 byte for byte) and timed in
device ms by ``chip_smoke.py``'s timer: the median of its 20 runs (whose
mean one slow run can move), each with L2 flushed first, or, for the
"warm" cases, inputs that fit in L2 and calls replayed back to back
from a CUDA graph (what the kernel does when neither DRAM nor the host
is in the way). ``torch.var_mean`` is timed beside kernel 7. This
is where the two sources' geometry and the planners' constants come
from. One JSON line per (variant, case) on stdout (and in ``--out``),
after the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels import channel_stats as cs  # noqa: E402
from repro_torch.kernels import quantize_pack as qp  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.roofline import F32_FLOPS, bound  # noqa: E402

KINDS = {"stats": ("channel_stats", cs), "pack": ("quantize_pack", qp)}
# the default grid of each kind: the committed geometry first
DEFAULTS = {
    "stats": [{}, {"STAGES": 3}, {"TILE": 4, "STAGES": 4}, {"TILE": 16},
              {"STRIP": 128}, {"STRIP": 32}, {"TARGET_BLOCKS": 32},
              {"TARGET_BLOCKS": 132}, {"TARGET_BLOCKS": 264}],
    "pack": [{}, {"RUN_ROWS": 16}, {"RUNS": 4}, {"RUNS": 16},
             {"GRID_BLOCKS": 528}, {"GRID_BLOCKS": 1056},
             {"GRID_BLOCKS": 4224}],
}
# kernel 7: (T, C, dtype, warm); kernel 6: (shape, bits, group, dtype,
# warm)
STATS_CASES = [(16384, 2048, torch.float32, False),
               (262144, 2048, torch.float32, False),
               (16384, 2048, torch.bfloat16, False),
               (262144, 2048, torch.bfloat16, False),
               (1000, 70, torch.float32, False),
               (64, 64, torch.float32, False),
               (4096, 2048, torch.float32, True),
               (8192, 2048, torch.bfloat16, True)]
PACK_CASES = [((16, 2048, 8192), 4, 128, torch.float32, False),
              ((8, 6144, 16384), 4, 128, torch.float32, False),
              ((2048, 8192), 4, 128, torch.bfloat16, False),
              ((2048, 2048), 4, 128, torch.float32, False),
              ((2048, 2048), 3, -1, torch.float32, False),
              ((64, 64), 4, 32, torch.float32, False),
              ((2048, 2048), 4, 128, torch.float32, True)]
COLD = None   # chip_smoke.py's timer: L2 flushed before each run
WARM = None   # the same with nothing flushed
REPS = 10     # calls a warm run replays


def time_ms(fn, warm: bool) -> float:
    """Median device ms of 20 runs of ``chip_smoke.Timer``. Cold: L2
    flushed before each run. Warm: REPS calls captured in a CUDA graph and
    replayed back to back (no host work between them), per call."""
    global COLD, WARM
    if not warm:
        if COLD is None:
            COLD = chip_smoke.Timer()
        times = COLD.runs(fn)
    else:
        if WARM is None:
            WARM = chip_smoke.Timer(flush=False)
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(REPS):
                fn()
        times = [t / REPS for t in WARM.runs(graph.replay)]
    return sorted(times)[len(times) // 2]


def variant_source(name: str, var: dict) -> str:
    """The source with the variant's constants that it declares."""
    src = (build.SRC_DIR / f"{name}.cu").read_text()
    for key, val in var.items():
        src = re.sub(rf"constexpr int {key} = \d+;",
                     f"constexpr int {key} = {int(val)};", src)
    return src


def compile_all(name: str, mod, variants: list[dict]) -> list[Path]:
    """Every variant's library, compiled in parallel."""
    out_dir = build.BUILD_DIR.parent / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    committed = (build.SRC_DIR / f"{name}.cu").read_text()
    procs = []
    for i, var in enumerate(variants):
        for key in var:
            if (f"constexpr int {key} = " not in committed
                    and not hasattr(mod, key)):
                raise ValueError(f"{key} is a constant of neither "
                                 f"{name}.cu nor its wrapper")
        cu = out_dir / f"{name}_{i}.cu"
        cu.write_text(variant_source(name, var))
        so = out_dir / f"lib{name}_{i}.so"
        procs.append((so, subprocess.Popen(
            build.nvcc_command(cu, so, "-I", str(build.SRC_DIR)),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    for so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {so}:\n{log.decode()}")
    return [so for so, _ in procs]


def use_variant(mod, var: dict) -> dict:
    """Set the wrapper module's constants of the variant; returns the
    values to restore."""
    saved = {key: getattr(mod, key) for key in var if hasattr(mod, key)}
    for key in saved:
        setattr(mod, key, var[key])
    return saved


def run_stats(gen, var) -> list[dict]:
    rows = []
    for t, c, dtype, warm in STATS_CASES:
        x = (torch.randn((t, c), generator=gen, device="cuda")).to(dtype)
        mu, var_ = cs.channel_stats_cuda(x)
        want_mu, want_var = ref.channel_stats_ref(x)
        scale = torch.maximum(want_mu.abs(), want_var.sqrt())
        ok = bool(((mu - want_mu).abs() <= 1e-6 * scale).all()
                  and ((var_ - want_var).abs() <= 1e-5 * want_var).all())
        ms = time_ms(lambda: cs.channel_stats_cuda(x), warm)
        lib_ms = time_ms(lambda: torch.var_mean(x, dim=0, correction=0),
                         warm)
        b_ms, _ = bound(x.numel() * x.element_size() + 8 * c,
                        3.0 * x.numel(), F32_FLOPS)
        plan = cs.plan_stats(t, c, dtype == torch.bfloat16)
        rows.append(dict(variant=var, shape=[t, c],
                         dtype=str(dtype).split(".")[-1], warm=warm, ok=ok,
                         ms=ms,
                         var_mean_ms=lib_ms, bound_ms=b_ms,
                         plan=plan._asdict(),
                         clusters_at_once=build.max_clusters(
                             plan.ranks, dtype == torch.bfloat16)))
        del x
    return rows


def run_pack(gen, var) -> list[dict]:
    from repro_torch.core.quant.types import compute_scales

    rows = []
    for shape, bits, group, dtype, warm in PACK_CASES:
        w = (torch.randn(shape, generator=gen, device="cuda")
             / shape[-2] ** 0.5).to(dtype)
        scale = compute_scales(w.float(), bits, group)
        got = qp.quantize_pack_cuda(w, scale, bits=bits)
        ok = bool(torch.equal(got, ref.quantize_pack_ref(w, scale,
                                                         bits=bits)))
        ms = time_ms(lambda: qp.quantize_pack_cuda(w, scale, bits=bits),
                     warm)
        b_ms, _ = bound(w.numel() * w.element_size()
                        + scale.numel() * 4 + got.numel(), 0.0, F32_FLOPS)
        b = math.prod(shape[:-2])
        rows.append(dict(variant=var, shape=list(shape), bits=bits,
                         group=group, dtype=str(dtype).split(".")[-1],
                         warm=warm, ok=ok, ms=ms, bound_ms=b_ms,
                         plan=qp.plan_pack(b, *shape[-2:], bits)._asdict()))
        del w, scale, got
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kind", choices=sorted(KINDS))
    ap.add_argument("--variants", default=None,
                    help="JSON list of variants (default: the built-in grid)")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    name, mod = KINDS[args.kind]
    variants = (json.loads(args.variants) if args.variants
                else DEFAULTS[args.kind])
    lines = [chip_smoke.nvidia_smi()]
    print(lines[0], flush=True)
    libs = compile_all(name, mod, variants)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(chip_smoke.SEED)
    run = run_stats if args.kind == "stats" else run_pack
    for var, lib in zip(variants, libs):
        saved = use_variant(mod, var)
        try:
            with build.library_from(name, lib):
                for row in run(gen, var):
                    line = json.dumps(row)
                    print(line, flush=True)
                    lines.append(line)
        finally:
            for key, val in saved.items():
                setattr(mod, key, val)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
