"""Elastic scaling + failure handling policy for 1000+ node runs (port of
``repro.launch.elastic``; plain Python, the JAX package's policy as it is).

The coordinator owns the mesh recipe. On node failure or persistent
straggler:

  1. drain: stop issuing steps, wait for the last async checkpoint;
  2. remesh: choose the largest (pod, data, model) mesh that the surviving
     hosts support — the model axis is fixed by the sharding recipe (TP
     degree must divide attention heads / mlp), so capacity loss shrinks
     the *data* axis first, then drops a pod;
  3. resume: restore the latest checkpoint with the new shardings (our
     checkpoints are host-side full tensors keyed by path, so resharding is
     a pure load-time layout choice) and re-enter the training loop with the
     same (seed, step) data cursor — global batch is preserved by raising
     grad-accumulation steps to cover the lost data-parallel rank(s).

This module computes the policy decisions; the mechanics (mesh build, load)
live in launch/mesh.py and checkpoint/. The training launcher prints the
plan a straggler leads to and does not remesh, as the JAX launcher does.
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MeshPlan:
    shape: tuple[int, ...]            # (pod, data, model) or (data, model)
    axes: tuple[str, ...]
    accum_steps: int                  # grad-accum multiplier vs healthy run
    dropped_hosts: int


def plan_mesh(total_chips: int, *, model_parallel: int = 16,
              chips_per_pod: int = 256, global_batch: int = 256,
              healthy_chips: Optional[int] = None) -> MeshPlan:
    """Pick the best mesh for the currently healthy chip count."""
    healthy = healthy_chips if healthy_chips is not None else total_chips
    if healthy < model_parallel:
        raise ValueError(f"cannot satisfy TP degree: {healthy} healthy "
                         f"chips < model_parallel {model_parallel}")
    pods = max(1, healthy // chips_per_pod)
    per_pod = healthy // pods
    data = per_pod // model_parallel
    # shrink until it divides cleanly
    while pods * data * model_parallel > healthy and data > 1:
        data -= 1
    used = pods * data * model_parallel
    healthy_data = (total_chips // max(
        1, (total_chips // chips_per_pod))) // model_parallel
    healthy_ranks = max(1, (total_chips // chips_per_pod) * healthy_data)
    ranks = pods * data
    accum = max(1, -(-healthy_ranks // max(ranks, 1)))
    if pods > 1:
        return MeshPlan((pods, data, model_parallel),
                        ("pod", "data", "model"), accum,
                        total_chips - used)
    return MeshPlan((data, model_parallel), ("data", "model"), accum,
                    total_chips - used)


@dataclasses.dataclass
class FailureEvent:
    step: int
    kind: str            # "node_down" | "straggler"
    detail: str = ""


class ElasticCoordinator:
    """Tracks health events and decides remesh points."""

    def __init__(self, total_chips: int, *, model_parallel: int = 16,
                 chips_per_pod: int = 256, straggler_tolerance: int = 3):
        self.total = total_chips
        self.healthy = total_chips
        self.mp = model_parallel
        self.cpp = chips_per_pod
        self.events: list[FailureEvent] = []
        self._straggler_strikes = 0
        self.tol = straggler_tolerance

    def current_plan(self, global_batch: int = 256) -> MeshPlan:
        return plan_mesh(self.total, model_parallel=self.mp,
                         chips_per_pod=self.cpp, global_batch=global_batch,
                         healthy_chips=self.healthy)

    def node_down(self, step: int, chips_lost: int) -> MeshPlan:
        self.healthy -= chips_lost
        self.events.append(FailureEvent(step, "node_down",
                                        f"-{chips_lost} chips"))
        return self.current_plan()

    def straggler(self, step: int, dt: float) -> Optional[MeshPlan]:
        """Repeated stragglers -> treat the slow host as failed (evict)."""
        self.events.append(FailureEvent(step, "straggler", f"{dt:.2f}s"))
        self._straggler_strikes += 1
        if self._straggler_strikes >= self.tol:
            self._straggler_strikes = 0
            return self.node_down(step, chips_lost=self.cpp // 64)  # 1 host
        return None
