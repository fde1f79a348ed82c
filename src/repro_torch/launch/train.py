"""Training launcher (port of ``repro.launch.train``), on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny \\
        --steps 700 --ckpt-dir DIR [--device cpu]

Trains on the seeded synthetic corpus (``data/synthetic.py``, 200,000
tokens, 5% held out) through the fault-tolerant ``Trainer``: Adam with a
20-step warm-up and cosine decay, gradient clipping at 1.0, a checkpoint
every ``--ckpt-every`` steps, resuming from the latest one in
``--ckpt-dir``. Prints the held-out perplexity at the end.

Single-card: ``--multi-pod`` (the JAX launcher's 2 x 16 x 16 mesh) waits
for multi-device support (ROADMAP.md queue 1 item 8) and
``--grad-compress-bits`` for gradient compression (item 7); both are
refused, never ignored. Without the elastic coordinator a straggler step
is logged, not remeshed.
"""
from __future__ import annotations

import argparse

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.registry import list_archs
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import heldout_split, make_corpus
from repro_torch.device import resolve_device
from repro_torch.models.transformer import init_lm
from repro_torch.optim.schedules import warmup_cosine
from repro_torch.train.evaluate import perplexity
from repro_torch.train.train_step import init_opt_state, make_train_step
from repro_torch.train.trainer import Trainer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tiny",
                    choices=["tiny"] + list_archs())
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config of --arch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the initial params")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--crash-at", type=int, default=None, metavar="STEP",
                    help="raise after this step (fault injection: a rerun "
                         "with the same --ckpt-dir resumes)")
    ap.add_argument("--grad-compress-bits", type=int, default=0)
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise SystemExit("--multi-pod is not ported yet: it comes with the "
                         "multi-device slice (ROADMAP.md queue 1 item 8)")
    if args.grad_compress_bits:
        raise SystemExit("--grad-compress-bits is not ported yet: gradient "
                         "compression comes with the rest of training "
                         "(ROADMAP.md queue 1 item 7)")
    return args


def main(argv=None, log=print):
    """Run the launcher; returns (trainer, the run's result, the held-out
    evaluation)."""
    args = parse_args(argv)
    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    corpus, _ = make_corpus(cfg.vocab_size, 200_000, seed=0)
    train_toks, held = heldout_split(corpus)
    pipe = DataPipeline(train_toks, batch_size=args.batch, seq_len=args.seq,
                        seed=0)
    params = init_lm(cfg, seed=args.seed, device=device)
    step_fn = make_train_step(
        cfg, lr_schedule=warmup_cosine(args.lr, 20, args.steps))
    opt = init_opt_state(cfg, params)
    ckpt = CheckpointManager(args.ckpt_dir, keep=3)

    def on_straggler(step, dt):
        log(f"straggler: step {step} took {dt * 1e3:.1f} ms (single card: "
            "logged, not remeshed)")

    trainer = Trainer(cfg, params, opt, step_fn, pipe, ckpt,
                      on_straggler=on_straggler)
    try:
        start = trainer.maybe_resume()
        if start:
            log(f"resumed at step {start}")
        result = trainer.run(args.steps, ckpt_every=args.ckpt_every,
                             log_every=args.log_every, log=log,
                             crash_at=args.crash_at)
    finally:
        ckpt.close()
    log(f"done: {result}")
    heldout = perplexity(cfg, trainer.params, held, seq_len=args.seq)
    log(f"heldout: {heldout}")
    return trainer, result, heldout


if __name__ == "__main__":
    main()
