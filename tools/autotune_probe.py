"""Run ``chip_smoke.py``'s tuner phases alone on the card (~2 min).

    python3 tools/autotune_probe.py

Builds the kernels, serves llama3.2-1b W4 g128 once (``serve_w4``: the
tokens the tuned serve is held against), then runs ``autotune_paths``:
the search of the tuner's classes into a cache in a temporary file, the
warm check of each class's tuned and fixed plans (timed in turns, beside
the roofline's bound), ``serve_w4_tuned`` and the sanitizer's two
replays in this process; last the sanitizer CLI as a process of its own
(``python -m repro_torch.analysis.sanitize`` with RTORCH_AUTOTUNE=1 and a
fresh cache), whose first replay also counts the kernel loads. Prints
the card's name and power limit, one line per class and each phase's
seconds.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.transformer import init_lm  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("autotune_probe: needs a CUDA device")
    resolve_device("cuda")
    cs.CARD = cs.nvidia_smi()
    print(cs.CARD, flush=True)
    with cs.phase("kernel_build"):
        build.build()
    cfg = get_config("llama3.2-1b")
    with cs.phase("serve_w4"):
        engine, done, _ = cs.serve(
            cfg, init_lm(cfg, seed=cs.SEED, device="cuda"), "serve_w4",
            cs.LLAMA_WORK, quant_bits=4, quant_group=128)
        cs.SERVE_W4_TOKENS.update({r.rid: list(r.tokens) for r in done})
        del engine, done
        cs.release()
    tuning = cs.autotune_paths(cfg)
    for r in tuning["autotune"]["classes"]:
        print(r["kernel"], r["key"], "tuned", r["tuned"],
              round(r["tuned_ms"], 4), "fixed", r["fixed"],
              round(r["fixed_ms"], 4), flush=True)
    with cs.phase("sanitize_process"), tempfile.TemporaryDirectory() as tmp:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   RTORCH_AUTOTUNE="1",
                   RTORCH_AUTOTUNE_CACHE=str(Path(tmp) / "sanitize.json"))
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis.sanitize"],
            env=env, capture_output=True, text=True, timeout=600)
        print(proc.stdout[-6000:], proc.stderr[-3000:], flush=True)
        if proc.returncode:
            raise SystemExit(f"sanitize: exit {proc.returncode}")
    print("phases", json.dumps(cs.PHASE_S), flush=True)


if __name__ == "__main__":
    main()
