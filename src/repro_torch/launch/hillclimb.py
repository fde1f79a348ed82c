"""Perf hill-climbing driver (port of ``repro.launch.hillclimb``): run a
cell of the dry run with a named variant through ``dryrun.run_cell`` and
diff its roofline terms and peak bytes against the baseline record
``results/dryrun/<arch>__<shape>__<mesh>.json``.

    PYTHONPATH=src python -m repro_torch.launch.hillclimb --cell \\
        chatglm3-6b:decode_32k --variant chunked_decode
"""
from __future__ import annotations

import argparse
import json
import os

# named variants: {"cfg": {...}, "rules": {...}, "donate_cache", ...}, the
# JAX package's by name. "donate_cache" donates the cache buffers to the
# jitted step there; the port's step updates the cache in place always,
# so the flag changes nothing here (it is kept so the names stay the
# same).
VARIANTS = {
    "base_fixed": {},
    # --- decode (serving) ---
    "donate_cache": {"donate_cache": True},
    "kv_int8": {"cfg": {"kv_cache_bits": 8}, "donate_cache": True},
    "chunked_decode": {"cfg": {"chunked_decode": True, "attn_block_kv": 2048},
                       "donate_cache": True},
    "chunked_decode_512": {"cfg": {"chunked_decode": True,
                                   "attn_block_kv": 512},
                           "donate_cache": True},
    # --- train memory ---
    "blockkv_2048": {"cfg": {"attn_block_kv": 2048}},
    "blockkv_4096": {"cfg": {"attn_block_kv": 4096}},
    "remat_dots": {"cfg": {"remat_policy": "dots"}},
    "blockkv2048_rematdots": {"cfg": {"attn_block_kv": 2048,
                                      "remat_policy": "dots"}},
    "blockkv4096_rematdots": {"cfg": {"attn_block_kv": 4096,
                                      "remat_policy": "dots"}},
    # --- collectives ---
    "fsdp": {"cfg": {"fsdp": True}},
    "fsdp_gc8": {"cfg": {"fsdp": True}, "grad_compress_bits": 8},
    "gc8": {"grad_compress_bits": 8},
    "expert_tp": {"rules": {"expert": None, "expert_ff": "model",
                            "capacity": "model"}},
    "moe_shardmap": {"cfg": {"moe_impl": "shard_map"}},
    "moe_shardmap_fsdp": {"cfg": {"moe_impl": "shard_map", "fsdp": True}},
    "fsdp_expert_tp": {"cfg": {"fsdp": True},
                       "rules": {"expert": None, "expert_ff": "model",
                                 "capacity": "model"}},
    # context-parallel decode: replicate the (tiny) q heads, keep the KV
    # cache seq-sharded end-to-end -> no per-layer cache all-gather
    "ctx_parallel_decode": {"rules": {"heads": None, "kv_heads": None,
                                      "cache_seq": "model"}},
    "bf16_scores": {"cfg": {"attn_scores_dtype": "bfloat16"}},
    "bf16_scores_rematdots": {"cfg": {"attn_scores_dtype": "bfloat16",
                                      "remat_policy": "dots"}},
    # --- SWA ---
    "banded_swa": {"cfg": {"banded_window_attn": True}},
    "banded_blockkv": {"cfg": {"banded_window_attn": True,
                               "attn_block_kv": 2048}},
}


def diff_lines(arch: str, shape: str, variant: str, base: dict,
               rec: dict) -> list[str]:
    """The JAX package's diff print: each roofline term, the dominant one,
    the roofline fraction and the peak bytes, baseline -> variant."""
    br, vr = base["roofline"], rec["roofline"]
    out = [f"{arch} {shape} [{variant}] vs baseline:"]
    for k in ("compute_s", "memory_s", "collective_s"):
        b, v = br[k], vr[k]
        delta = (v - b) / b * 100 if b else 0.0
        out.append(f"  {k:13s} {b:10.4f} -> {v:10.4f}  ({delta:+.1f}%)")
    out.append(f"  dominant      {br['dominant']} -> {vr['dominant']}")
    out.append(f"  frac          {br['roofline_fraction']:.4f} -> "
               f"{vr['roofline_fraction']:.4f}")
    pb = base["memory"].get("peak_bytes") or 0
    pv = rec["memory"].get("peak_bytes") or 0
    out.append(f"  peak HBM      {pb / 2 ** 30:.2f}GB -> {pv / 2 ** 30:.2f}GB")
    return out


def main(argv=None):
    from repro_torch.launch.dryrun import run_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="arch:shape")
    ap.add_argument("--variant", required=True,
                    help=f"one of {list(VARIANTS)}")
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--out", default="results/perf")
    ap.add_argument("--base-dir", default="results/dryrun")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's SMOKE config (a quick run)")
    ap.add_argument("--batch", type=int, default=0,
                    help="rows the realized run starts its cut from")
    args = ap.parse_args(argv)

    arch, shape = args.cell.split(":")
    variant = VARIANTS[args.variant]
    rec = run_cell(arch, shape, args.mesh == "multi", args.out,
                   variant=variant, variant_name=args.variant,
                   device=args.device, smoke=args.smoke, batch=args.batch)
    base_path = os.path.join(args.base_dir,
                             f"{arch}__{shape}__{args.mesh}.json")
    if rec["status"] == "ok" and os.path.exists(base_path):
        with open(base_path) as f:
            base = json.load(f)
        print("\n".join(diff_lines(arch, shape, args.variant, base, rec)))
    else:
        print(json.dumps(rec, indent=2)[:2000])
    return rec


if __name__ == "__main__":
    main()
