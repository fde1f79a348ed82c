"""Time both bodies of the dense kernels (1 and 3) across M and K splits
on the card.

    python3 tools/dense_sweep.py [--ms 8,16,32,48,64,96,128,512] [--out FILE]

For kernel 1 (dequant matmul, W4 g128) and kernel 3 (W8A8, W4
per-channel), at each M of ``--ms`` on llama3.2-1b's 2048 x 8192 and
2048 x 2048 linears, and at the decode M = 8 on its other two shapes and
Mixtral's attention shapes, it times the candidates the tuner searches
(``kernels/template.py::dense_candidates``: the planner's own plan, the
streaming body at 1-64 K splits up to M 512, the tile at 1-8) and one
``torch.matmul`` of bf16 operands. Each variant is first held against
the plain version with ``chip_smoke.py``'s tolerance, and timed with its
timer (device ms, L2 flushed before each run). This is where
``kernels/dequant_matmul.py``'s STREAM_MAX_M and STREAM_TARGET_BLOCKS
come from. One JSON line per case
on stdout (and in ``--out``), after the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402
from repro_torch.core.quant.types import (dequantize, quantize,  # noqa: E402
                                          quantize_activation, unpack)
from repro_torch.kernels import dequant_matmul as dq  # noqa: E402
from repro_torch.kernels import ref, template  # noqa: E402

SWEEP_SHAPES = ((2048, 8192), (2048, 2048))
DECODE_SHAPES = ((2048, 512), (8192, 2048), (6144, 6144), (6144, 1024))


def sweep_case(name: str, m: int, k: int, n: int, timer, gen) -> dict:
    int8 = name == "w8a8_matmul"
    group = -1 if int8 else 128
    groups = 1 if group == -1 else k // group
    x = torch.randn((m, k), generator=gen, device="cuda")
    w = torch.randn((k, n), generator=gen, device="cuda") / math.sqrt(k)
    qt = quantize(w, 4, group, act_bits=8 if int8 else 0)
    if int8:
        a, _ = quantize_activation(x)
        want = ref.w8a8_matmul_ref(a, qt.qw, qt.scale, bits=4,
                                   group_size=group, k=k)
        tol = chip_smoke.w8a8_tol(a, qt)
        lib = (a.to(torch.bfloat16), unpack(qt.qw, 4, k).to(torch.bfloat16))
    else:
        a = x
        want = ref.dequant_matmul_ref(a, qt.qw, qt.scale, bits=4,
                                      group_size=group, k=k)
        tol = chip_smoke.dequant_tol(x, qt)
        lib = (x.to(torch.bfloat16), dequantize(qt).to(torch.bfloat16))
    # the tuner's candidates (kernels/template.py), the planner's first
    choices = template.dense_candidates(m, k, n, 4, groups, int8=int8)
    planned = dq.plan(m, k, n, 4, groups, int8=int8)
    row = dict(kernel=name, shape=[m, k, n],
               planned=dict(body=planned.body, splits=planned.splits),
               stream={}, tile={})
    for choice in choices:
        p = template.valid_dense(choice, m, k, n, 4, groups, int8=int8)
        label = "stream" if p.body == dq.STREAM else "tile"

        def call(p=p):
            return dq.launch(name, a, qt.qw, qt.scale, p, bits=4, k=k)

        err = float((call() - want).abs().max())
        if not err <= tol:
            raise AssertionError(f"{name} {label} splits={p.splits} M={m} "
                                 f"K={k} N={n}: |err| {err} > {tol}")
        row[label][p.splits] = timer(call)
        if p == planned:
            row["planned"]["ms"] = row[label][p.splits]
    row["library_ms"] = timer(lambda: torch.matmul(*lib))
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ms", default="8,16,32,48,64,96,128,512",
                    help="token rows M on the two sweep shapes")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("dense_sweep: needs a CUDA device")
    card = chip_smoke.nvidia_smi()
    print(card)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(chip_smoke.SEED)
    timer = chip_smoke.Timer()
    cases = [(int(m), k, n) for m in args.ms.split(",")
             for k, n in SWEEP_SHAPES]
    cases += [(8, k, n) for k, n in DECODE_SHAPES]
    lines = [card]
    for name in ("dequant_matmul", "w8a8_matmul"):
        for m, k, n in cases:
            line = json.dumps(sweep_case(name, m, k, n, timer, gen))
            print(line, flush=True)
            lines.append(line)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
