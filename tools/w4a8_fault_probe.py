"""What whisper's W4A8 layer-0 check reads when kernel 3 is wrong.

    python3 tools/w4a8_fault_probe.py [--out FILE]

Runs chip_smoke.py's whisper-medium SmoothQuant W4A8 + NT pipeline (2
encoder + 2 decoder layers, its seeded weights and calibration) on the
card once with kernel 3 as it is and once with each planted fault, then
reads layer 0 of the encoder and of the decoder with chip_smoke.py's
``layer_on_card`` (the plain-kernel reruns, and each half's rule: per
channel on the encoder, by the mean on the decoder). A fault wraps kernel
3's CUDA entry point for the pipeline's run only, so the plain reruns are
untouched:

  * "one_scale": the middle output channel's scale is read from its
    neighbour's, in every launch;
  * "all_scales": every output channel's scale is read from its
    neighbour's (the last from the first).

Prints one JSON line per (fault, half): each norm leaf's mean and max
|card delta - plain delta| in lr, the bar its rule sets, whether the
same channels moved, and whether the check passes. Needs one card.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import chip_smoke as cs  # noqa: E402

FAULTS = ("none", "one_scale", "all_scales")


def faulty(real, fault):
    """Kernel 3's entry point ``real`` with ``fault``'s scales."""
    def run(xq, qw, scale, **kw):
        if fault == "one_scale":
            j = scale.shape[-1] // 2
            scale = scale.clone()
            scale[..., j] = scale[..., j + 1]
        else:
            scale = torch.roll(scale, -1, dims=-1)
        return real(xq, qw, scale.contiguous(), **kw)
    return run


def bar(c):
    """The bar ``layer_on_card``'s rule holds this norm leaf to, in lr."""
    if c["noise_rule"] == "channel":
        return dict(max_err_lr=c["noise_max_err_lr"] + 1e-3)
    return dict(mean_err_lr=c["noise_mean_err_lr"] + 1e-3)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the lines here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("w4a8_fault_probe: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels import w8a8_matmul as w8

    build.build()
    wh = get_config("whisper-medium")
    cfg = wh.replace(n_repeats=cs.WHISPER_PIPE_REPEATS,
                     n_enc_repeats=cs.WHISPER_PIPE_REPEATS)
    lines = []
    for fault in FAULTS:
        real = w8.w8a8_matmul_cuda
        if fault != "none":
            w8.w8a8_matmul_cuda = faulty(real, fault)
        try:
            params, rec = cs.run_pipeline(
                cfg, "smoothquant", cs.encdec_build(cfg, "smoothquant"),
                keep_at=(0, cfg.n_enc_repeats))
        finally:
            w8.w8a8_matmul_cuda = real
        del params
        for name, _, part, cross, li, rule in cs.whisper_halves(cfg):
            out = cs.layer_on_card(
                part, "smoothquant", rec["kept"][li],
                [(p, None) for p in cs.whisper_linears(cross)], noise=rule)
            norms = {k: dict(mean_err_lr=c["mean_err_lr"],
                             max_err_lr=c["max_err_lr"],
                             over_1e3_lr=c["over_1e3_lr"],
                             same_moved=c["same_moved"], bar=bar(c),
                             ok=c["ok"])
                     for k, c in out["norms"].items()}
            line = dict(fault=fault, half=name, rule=rule,
                        passes=all(c["ok"] for c in norms.values()),
                        norms=norms)
            lines.append(json.dumps(line))
            print(lines[-1], flush=True)
        cs.release()
    print(cs.nvidia_smi())
    if args.out:
        Path(args.out).write_text("\n".join(lines) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
