"""Time kernel 2 (paged attention) at every cluster size on the card.

    python3 tools/paged_sweep.py [--out FILE]

At llama3.2-1b's decode read (GQA 32/8, hd 64, 20 pages of 16) with 8
and 32 slots, f32 and int8 pools, and at Mixtral's 4096-token window
(GQA 48/8, hd 128, 288 pages) with 8 slots, it launches the kernel at
n_split 1-8 and at ``plan_paged``'s choice, with ``chip_smoke.py``'s
ragged fills (an empty slot included), on pools and queries built by
``kernels/paged_harness.py`` from a seed. Each split is first held against
the plain version (1e-4) and timed with ``chip_smoke.py``'s timer (device
ms, L2 flushed before each run). This is where
``kernels/paged_attention.py``'s TARGET_BLOCKS and MIN_SPLIT_TOKENS come
from. One JSON line per case on stdout (and in ``--out``), after the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import chip_smoke  # noqa: E402
from repro_torch.kernels import paged_attention as pa  # noqa: E402
from repro_torch.kernels import paged_harness as ph  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

LLAMA_FILLS = [0, 1, 16, 37, 100, 256, 300, 320]
MIXTRAL_FILLS = [0, 1, 16, 160, 2000, 4096, 4097, 4608]
# (label, kv heads, G, hd, table width, window, fills, int8)
CASES = [("llama_s8", 8, 4, 64, 20, None, LLAMA_FILLS, False),
         ("llama_s8_int8", 8, 4, 64, 20, None, LLAMA_FILLS, True),
         ("llama_s32", 8, 4, 64, 20, None, LLAMA_FILLS * 4, False),
         ("mixtral_window", 8, 6, 128, 288, 4096, MIXTRAL_FILLS, False)]


def sweep_case(label, kvh, g, hd, w, window, fills, quant, timer,
               seed) -> dict:
    s, ps = len(fills), 16
    q, pools, bt, kl = ph.build_paged_case(seed, s, w, ps, kvh, g, hd, fills,
                                           8 if quant else 16)
    q = ph.kernel_rows(q, kvh)
    kp, vp = pools["k_pool"], pools["v_pool"]
    ks, vs = pools["k_scale_pool"], pools["v_scale_pool"]
    want = ref.paged_attention_ref(q, kp, vp, bt, kl, ks, vs, window=window)
    out = torch.empty_like(want)
    planned = pa.plan_paged(s, kvh, w, ps, g, hd, hd,
                           "int8" if quant else "f32")
    row = dict(case=label, slots=s, hd=hd, group=g, window=window,
               int8=quant, planned=planned, ms={})
    for n in range(1, pa.MAX_SPLIT + 1):
        def call(n=n):
            pa._launch(q, kp, vp, bt, kl, ks, vs, out, window, 1, n)
            return out

        err = float((call() - want).abs().max())
        if not err <= 1e-4:
            raise AssertionError(f"{label} n_split={n}: |err| {err}")
        row["ms"][n] = timer(call)
    row["planned_ms"] = row["ms"][planned]
    return row


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("paged_sweep: needs a CUDA device")
    card = chip_smoke.nvidia_smi()
    print(card)
    timer = chip_smoke.Timer()
    lines = [card]
    for i, case in enumerate(CASES):
        line = json.dumps(sweep_case(*case, timer, chip_smoke.SEED + i))
        print(line, flush=True)
        lines.append(line)
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
