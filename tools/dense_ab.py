"""A/B of the dense kernels (1 and 3) between two checkouts on one card.

    python3 tools/dense_ab.py OTHER_TREE [--out FILE]

Runs each tree's own ``chip_smoke.py`` checks of kernels 1 and 3 (its
kernels, built in that tree, its cases, its timer and tolerances) in a
fresh process per turn, in the order other, this, this, other, and prints
one JSON line per turn with the device ms of every case the two trees
share (same M, K, N, bits and group).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

THIS_TREE = Path(__file__).resolve().parents[1]

TURN = r"""
import json, sys
import torch
tree = sys.argv[1]
sys.path[:0] = [tree + "/src", tree]
import chip_smoke
from repro_torch.device import resolve_device
from repro_torch.kernels import build
resolve_device("cuda")
build.build()
gen = torch.Generator(device="cuda")
gen.manual_seed(chip_smoke.SEED)
timer = chip_smoke.Timer()
out = {"dequant_matmul": chip_smoke.check_dequant_matmul(timer, gen),
       "w8a8_matmul": chip_smoke.check_w8a8_matmul(timer, gen)}
print("AB " + json.dumps(out))
"""


def turn(tree: Path) -> dict:
    """One tree's checks of kernels 1 and 3, by case key."""
    proc = subprocess.run([sys.executable, "-c", TURN, str(tree)],
                          capture_output=True, text=True, timeout=900,
                          check=True)
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("AB "))
    cases = json.loads(line[3:])
    return {(name, *c["shape"], c["bits"], c["group"]): c["ms"]
            for name, rows in cases.items() for c in rows}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
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
    results = [(label, turn(tree)) for label, tree in turns]
    shared = sorted(set.intersection(*(set(r) for _, r in results)))
    for label, r in results:
        line = json.dumps({"tree": label, "ms": {
            " ".join(map(str, key)): r[key] for key in shared}})
        print(line, flush=True)
        lines.append(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
