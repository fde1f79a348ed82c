"""Aggregate dry-run JSON records into a roofline table (port of
``repro.launch.report``: the same table from the same records).

    PYTHONPATH=src python -m repro_torch.launch.report --dir results/dryrun
"""
from __future__ import annotations

import argparse
import glob
import json
import os


def fmt_bytes(b):
    if b is None:
        return "-"
    for unit in ("B", "KB", "MB", "GB", "TB"):
        if abs(b) < 1024:
            return f"{b:.1f}{unit}"
        b /= 1024
    return f"{b:.1f}PB"


def fmt_s(v):
    if v is None:
        return "-"
    if v < 1e-3:
        return f"{v * 1e6:.1f}us"
    if v < 1.0:
        return f"{v * 1e3:.1f}ms"
    return f"{v:.2f}s"


def load(dir_):
    recs = []
    for f in sorted(glob.glob(os.path.join(dir_, "*.json"))):
        with open(f) as fh:
            recs.append(json.load(fh))
    return recs


def table(recs, mesh="single"):
    rows = []
    hdr = ("| arch | shape | status | compute | memory | collective | "
           "dominant | useful | frac | HBM/dev |")
    sep = "|" + "---|" * 10
    rows.append(hdr)
    rows.append(sep)
    for r in recs:
        if r["mesh"] != mesh:
            continue
        if r["status"] == "skipped":
            rows.append(f"| {r['arch']} | {r['shape']} | skipped | - | - | - "
                        f"| - | - | - | - |")
            continue
        if r["status"] == "error":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | - | - | - | "
                        f"- | - | - | - |")
            continue
        rf = r["roofline"]
        peak = r["memory"].get("peak_bytes") or r["memory"].get("temp_bytes")
        uf = rf.get("useful_flops_ratio")
        uf_s = f"{uf:.2f}" if uf is not None else "-"
        rows.append(
            f"| {r['arch']} | {r['shape']} | ok "
            f"| {fmt_s(rf['compute_s'])} | {fmt_s(rf['memory_s'])} "
            f"| {fmt_s(rf['collective_s'])} | {rf['dominant']} "
            f"| {uf_s} | {rf['roofline_fraction']:.3f} "
            f"| {fmt_bytes(peak)} |")
    return "\n".join(rows)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="results/dryrun")
    ap.add_argument("--mesh", default="single")
    args = ap.parse_args(argv)
    recs = load(args.dir)
    n_ok = sum(1 for r in recs if r["status"] == "ok")
    n_skip = sum(1 for r in recs if r["status"] == "skipped")
    n_err = sum(1 for r in recs if r["status"] == "error")
    print(f"records: {len(recs)} (ok={n_ok} skipped={n_skip} err={n_err})\n")
    print(table(recs, args.mesh))
    if n_err:
        print("\nerrors:")
        for r in recs:
            if r["status"] == "error":
                print(f"  {r['arch']} {r['shape']} {r['mesh']}: "
                      f"{r['error'][:160]}")


if __name__ == "__main__":
    main()
