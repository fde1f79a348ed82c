"""Fault-tolerant training driver (port of ``repro.train.trainer``).

Guarantees:
  * exact resume — params, Adam state, the RNG seed and the data cursor
    are all in the checkpoint; batches are a pure function of (seed,
    step), so a restarted run replays the same trajectory bit for bit
    (the CPU tests, with one thread; ``chip_smoke.py`` on the card, where
    the embedding's backward sorts its indices rather than adding with
    atomics);
  * async checkpointing — saves overlap the next steps;
  * straggler detection — per-step wall-time EWMA; a step slower than
    `straggler_z` standard deviations triggers a callback.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.data.pipeline import DataPipeline
from repro_torch.models.config import ModelConfig


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The step's random stream (the gradient compression's rounding
    noise), a function of (seed, step) alone, as the JAX trainer's
    ``fold_in(PRNGKey(seed), step)``: a resumed run draws what the
    uninterrupted one drew."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed * (1 << 32) + step)
    return gen


class StepTimeMonitor:
    def __init__(self, alpha: float = 0.1, z: float = 4.0, warmup: int = 5):
        self.alpha = alpha
        self.z = z
        self.warmup = warmup
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def update(self, dt: float) -> bool:
        """Returns True if this step is a straggler."""
        self.n += 1
        if self.n <= self.warmup:
            self.mean = dt if self.n == 1 else \
                (1 - self.alpha) * self.mean + self.alpha * dt
            return False
        straggler = dt > self.mean + self.z * max(self.var, 1e-12) ** 0.5 \
            and dt > 1.5 * self.mean
        d = dt - self.mean
        self.mean += self.alpha * d
        self.var = (1 - self.alpha) * (self.var + self.alpha * d * d)
        return straggler


class Trainer:
    def __init__(self, cfg: ModelConfig, params, opt_state, step_fn,
                 pipeline: DataPipeline, ckpt: CheckpointManager, *,
                 rng_seed: int = 0,
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.cfg = cfg
        self.params = params
        self.opt_state = opt_state
        self.step_fn = step_fn
        self.pipe = pipeline
        self.ckpt = ckpt
        self.rng_seed = rng_seed
        self.monitor = StepTimeMonitor()
        self.on_straggler = on_straggler
        self.start_step = 0
        self.history: list[dict] = []
        self.device = params["embed"]["w"].device

    def maybe_resume(self) -> int:
        restored = self.ckpt.restore(device=self.device)
        if restored is not None:
            step, params, opt_state, extra = restored
            self.params = params
            self.opt_state = opt_state
            self.start_step = step + 1
        return self.start_step

    def run(self, num_steps: int, *, ckpt_every: int = 50,
            log_every: int = 10,
            log: Callable[[str], None] = print,
            crash_at: Optional[int] = None) -> dict:
        """`crash_at`: raise after that step (fault-injection for tests)."""
        step = self.start_step
        end = num_steps
        while step < end:
            t0 = time.perf_counter()
            batch = {k: torch.as_tensor(v, device=self.device)
                     for k, v in self.pipe.batch_at(step).items()}
            self.params, self.opt_state, metrics = self.step_fn(
                self.params, self.opt_state, batch, step,
                step_generator(self.rng_seed, step, self.device))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            if self.monitor.update(dt) and self.on_straggler:
                self.on_straggler(step, dt)
            self.history.append({"step": step, "loss": loss, "dt": dt})
            if log_every and step % log_every == 0:
                log(f"step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            if ckpt_every and (step + 1) % ckpt_every == 0:
                self.ckpt.save(step, self.params, self.opt_state,
                               extra={"rng_seed": self.rng_seed})
            if crash_at is not None and step == crash_at:
                self.ckpt.wait()
                raise RuntimeError(f"injected failure at step {step}")
            step += 1
        self.ckpt.save(end - 1, self.params, self.opt_state,
                       extra={"rng_seed": self.rng_seed}, block=True)
        self.ckpt.wait()
        return {"final_loss": self.history[-1]["loss"] if self.history else None,
                "steps_run": len(self.history)}
