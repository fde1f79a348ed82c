"""A/B of a kernel between two checkouts on one card.

    python3 tools/kernel_ab.py dense|paged|stats|pack OTHER_TREE \
        [--out FILE]

Runs each tree's own ``chip_smoke.py`` checks of the dense kernels (1 and
3), of paged attention (kernel 2), of the channel statistics (kernel 7)
or of the quantize-pack (kernel 6) -- its kernels, built in that tree,
its cases, its timer and tolerances -- in a fresh process per turn, in
the order other, this, this, other, and prints one JSON line per turn
with the device ms of every case the two trees share (dense: same M, K,
N, bits and group; paged: same head dim, m_rows and pool type, with
SDPA's ms on the same inputs beside; stats: same T, C, dtype and mean,
with ``torch.var_mean``'s ms beside; pack: same shape, bits, group and
dtype).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

THIS_TREE = Path(__file__).resolve().parents[1]

# each kind's chip_smoke.py checks, as {kernel name: check function}
CHECKS = {"dense": {"dequant_matmul": "check_dequant_matmul",
                    "w8a8_matmul": "check_w8a8_matmul"},
          "paged": {"paged_attention": "check_paged_attention"},
          "stats": {"channel_stats": "check_channel_stats"},
          "pack": {"quantize_pack": "check_quantize_pack"}}
# the library call timed beside a kind's kernel, by its name in the lines
LIBRARY = {"paged": "sdpa_ms", "stats": "var_mean_ms"}

TURN = r"""
import json, sys
import torch
tree, checks = sys.argv[1], json.loads(sys.argv[2])
sys.path[:0] = [tree + "/src", tree]
import chip_smoke
from repro_torch.device import resolve_device
from repro_torch.kernels import build
resolve_device("cuda")
build.build(tuple(checks))
gen = torch.Generator(device="cuda")
gen.manual_seed(chip_smoke.SEED)
timer = chip_smoke.Timer()
out = {name: getattr(chip_smoke, fn)(timer, gen)
       for name, fn in checks.items()}
print("AB " + json.dumps(out))
"""


def case_key(name: str, c: dict) -> str:
    if name == "paged_attention":
        return f"hd{c['hd']} m_rows{c['m_rows']} int8={c['int8']}"
    if name == "channel_stats":
        return f"{c['shape'][0]}x{c['shape'][1]} {c['dtype']} mean{c['mean']}"
    if name == "quantize_pack":
        return " ".join(map(str, (*c["shape"], f"W{c['bits']}",
                                  f"g{c['group']}", c["dtype"])))
    return " ".join(map(str, (name, *c["shape"], c["bits"], c["group"])))


def turn(tree: Path, kind: str) -> dict:
    """One tree's checks, by case key: (ms, the library call's ms)."""
    proc = subprocess.run(
        [sys.executable, "-c", TURN, str(tree), json.dumps(CHECKS[kind])],
        capture_output=True, text=True, timeout=900, check=True)
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("AB "))
    return {case_key(name, c): (c["ms"], c.get("library_ms"))
            for name, rows in json.loads(line[3:]).items() for c in rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("kind", choices=sorted(CHECKS))
    ap.add_argument("other", help="root of the other checkout")
    ap.add_argument("--out", default=None, help="also write the lines here")
    args = ap.parse_args()
    other = Path(args.other).resolve()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card)
    lines = [card]
    turns = [("other", other), ("this", THIS_TREE), ("this", THIS_TREE),
             ("other", other)]
    results = [(label, turn(tree, args.kind)) for label, tree in turns]
    shared = sorted(set.intersection(*(set(r) for _, r in results)))
    for label, r in results:
        row = {"tree": label, "ms": {key: r[key][0] for key in shared}}
        if args.kind in LIBRARY:
            row[LIBRARY[args.kind]] = {key: r[key][1] for key in shared}
        line = json.dumps(row)
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
