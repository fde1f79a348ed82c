"""Training launcher (port of ``repro.launch.train``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch tiny \\
        --steps 700 --ckpt-dir DIR [--device cpu]

Trains on the seeded synthetic corpus (``data/synthetic.py``, 200,000
tokens, 5% held out) through the fault-tolerant ``Trainer``: Adam with a
20-step warm-up and cosine decay, gradient clipping at 1.0, a checkpoint
every ``--ckpt-every`` steps, resuming from the latest one in
``--ckpt-dir``. Prints the held-out perplexity at the end.

The mesh comes from the process group's world size, as the JAX
launcher's comes from the device count: (n, 1) over ("data", "model"),
and the production mesh (launch/mesh.py) at 256 ranks or more or with
``--multi-pod`` (2 x 16 x 16: 512 ranks, refused on any other world).
Under it the train step is data-parallel (train/train_step.py: each rank
its rows of the global batch, gradients averaged over the data ranks).
Run several ranks with ``torchrun --nproc-per-node N -m
repro_torch.launch.train ...``, or call ``main`` from each rank of
``launch/spawn.py::run_ranks``; rank 0 prints, and every rank checkpoints
its copy of the params (rank r > 0 under ``--ckpt-dir``/rank<r>).
``--grad-compress-bits`` 8 or 4 compresses the gradients with error
feedback. A straggler is passed to the elastic coordinator
(launch/elastic.py), which logs the remesh plan it would take after
repeated strikes; the run is not remeshed, as in the JAX launcher.
"""
from __future__ import annotations

import argparse
import contextlib
import os

import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.registry import list_archs
from repro_torch.data.pipeline import DataPipeline
from repro_torch.data.synthetic import heldout_split, make_corpus
from repro_torch.device import resolve_device
from repro_torch.distributed.partitioning import rules_for_config
from repro_torch.distributed.sharding import sharding_ctx
from repro_torch.launch.elastic import ElasticCoordinator
from repro_torch.launch.mesh import chips_in_mesh, make_mesh
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
    ap.add_argument("--grad-compress-bits", type=int, default=0,
                    help="int8 (8) or int4 (4) gradient compression with "
                         "error feedback; 0 off")
    ap.add_argument("--multi-pod", action="store_true",
                    help="build the 2x16x16 mesh (needs 512 ranks)")
    return ap.parse_args(argv)


def make_train_mesh(multi_pod: bool = False):
    """The launcher's mesh over the process group (one rank without
    one)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if multi_pod or world >= 256:
        from repro_torch.launch.mesh import make_production_mesh
        return make_production_mesh(multi_pod=multi_pod)
    return make_mesh((world, 1), ("data", "model"))


def coordinator_for(mesh) -> ElasticCoordinator:
    """The elastic coordinator of the launcher's mesh: its "model" axis as
    the TP degree, and pods of 256 chips, or one pod of the whole world
    when it is smaller. (The JAX launcher keeps the coordinator's defaults,
    a TP degree of 16 and 256-chip pods, whose plan fails on a world under
    16 chips at the third straggler; a straggler must not end a run.)"""
    chips = chips_in_mesh(mesh)
    return ElasticCoordinator(chips, model_parallel=mesh.shape["model"],
                              chips_per_pod=min(256, chips))


def straggler_handler(coord: ElasticCoordinator, log):
    """The trainer's straggler callback: each straggler goes to the
    coordinator, and the remesh plan it returns after repeated strikes is
    logged; the run is not remeshed (the JAX launcher's behaviour)."""
    def on_straggler(step, dt):
        plan = coord.straggler(step, dt)
        log(f"straggler: step {step} took {dt * 1e3:.1f} ms")
        if plan:
            log(f"!! evicting slow host: remesh plan {plan.shape}, "
                f"grad-accum x{plan.accum_steps} (logged, not remeshed)")
    return on_straggler


def main(argv=None, log=print):
    """Run the launcher; returns (trainer, the run's result, the held-out
    evaluation). Started by torchrun it first joins torchrun's process
    group (``gloo`` for ``--device cpu``, ``nccl`` for the card)."""
    args = parse_args(argv)
    if "WORLD_SIZE" in os.environ and not dist.is_initialized():
        from repro_torch.launch.spawn import default_backend

        dist.init_process_group(default_backend(args.device),
                                init_method="env://")
        try:
            return _train(args, log)
        finally:
            dist.destroy_process_group()
    return _train(args, log)


def _train(args, log):
    rank = dist.get_rank() if dist.is_initialized() else 0
    if rank:
        log = lambda *a, **k: None          # noqa: E731 (rank 0 prints)
    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    mesh = make_train_mesh(args.multi_pod)
    log(f"mesh: {mesh.shape} ({chips_in_mesh(mesh)} chips)")
    coord = coordinator_for(mesh)
    corpus, _ = make_corpus(cfg.vocab_size, 200_000, seed=0)
    train_toks, held = heldout_split(corpus)
    pipe = DataPipeline(train_toks, batch_size=args.batch, seq_len=args.seq,
                        seed=0)
    params = init_lm(cfg, seed=args.seed, device=device)
    step_fn = make_train_step(
        cfg, lr_schedule=warmup_cosine(args.lr, 20, args.steps),
        grad_compress_bits=args.grad_compress_bits)
    opt = init_opt_state(cfg, params,
                         grad_compress_bits=args.grad_compress_bits)
    # every rank holds the same params and checkpoints its own copy, rank
    # 0 into --ckpt-dir and rank r into its rank<r> subdirectory, from
    # which each resumes
    ckpt_dir = (args.ckpt_dir if rank == 0
                else os.path.join(args.ckpt_dir, f"rank{rank}"))
    ckpt = CheckpointManager(ckpt_dir, keep=3)

    trainer = Trainer(cfg, params, opt, step_fn, pipe, ckpt,
                      on_straggler=straggler_handler(coord, log))
    ctx = (sharding_ctx(mesh, rules_for_config(cfg, mesh))
           if chips_in_mesh(mesh) > 1 else contextlib.nullcontext())
    try:
        with ctx:
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
