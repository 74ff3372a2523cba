"""Fault tolerance: NaN-step rejection, restart orchestration, elastic
re-mesh, straggler-aware partitioning.

Container reality: one process, fake devices — so what we *prove* here is
the control plane: every decision function is pure and unit-tested, the
restart path is exercised end-to-end by examples/fault_tolerance.py
(train -> kill -> restore -> bit-exact continuation), and the elastic path
restores a 512-chip checkpoint onto a different mesh (tests/test_checkpoint
does 1-device <-> 8-device round trips).

At 1000+ nodes the same pieces compose: heartbeat timeouts mark a pod lost,
the job re-enters ``elastic_remesh`` with the surviving device set, restores
the latest checkpoint with re-resolved shardings, and the deterministic
data pipeline (pure f(seed, step)) replays the exact token stream.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np


# ---------------------------------------------------------------------------
# NaN / divergence guard
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepGuard:
    """Rejects steps whose loss/gnorm is non-finite or explodes.

    Keeps the previous (params, opt_state) alive until the new step's
    metrics are verified — the standard skip-and-continue recipe. Tracks a
    consecutive-rejection budget; exceeding it signals restore-from-
    checkpoint (data corruption / hardware fault rather than transient).
    """

    max_consecutive: int = 5
    gnorm_ceiling: float = 1e4
    rejected: int = 0
    consecutive: int = 0

    def ok(self, metrics: dict) -> bool:
        loss = float(metrics["loss"])
        gnorm = float(metrics["gnorm"])
        good = np.isfinite(loss) and np.isfinite(gnorm) and \
            gnorm < self.gnorm_ceiling
        if good:
            self.consecutive = 0
        else:
            self.rejected += 1
            self.consecutive += 1
        return good

    @property
    def should_restore(self) -> bool:
        return self.consecutive >= self.max_consecutive


# ---------------------------------------------------------------------------
# heartbeats / straggler detection (control-plane logic, pure + testable)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class HeartbeatMonitor:
    """Marks workers dead after ``timeout`` without a beat; flags stragglers
    whose step time exceeds ``straggler_factor`` x median."""

    num_workers: int
    timeout: float = 60.0
    straggler_factor: float = 2.0

    def __post_init__(self):
        now = time.time()
        self.last_beat = {w: now for w in range(self.num_workers)}
        self.step_times: dict[int, float] = {}

    def beat(self, worker: int, step_time: float | None = None,
             now: float | None = None):
        self.last_beat[worker] = now if now is not None else time.time()
        if step_time is not None:
            self.step_times[worker] = step_time

    def dead(self, now: float | None = None) -> list[int]:
        now = now if now is not None else time.time()
        return [w for w, t in self.last_beat.items() if now - t > self.timeout]

    def stragglers(self) -> list[int]:
        if len(self.step_times) < max(2, self.num_workers // 2):
            return []
        med = float(np.median(list(self.step_times.values())))
        return [w for w, t in self.step_times.items()
                if t > self.straggler_factor * med]


def elastic_remesh(alive_workers: int, chips_per_worker: int,
                   model_parallel: int = 16):
    """Largest (data, model) mesh shape fitting the surviving fleet.

    Keeps the model axis fixed (reshaping TP mid-run would re-lay weights);
    shrinks/grows the data axis to the largest power-of-two that fits, which
    keeps global batch divisibility. Returns (shape, axis_names, dropped)."""
    total = alive_workers * chips_per_worker
    data = total // model_parallel
    if data < 1:
        raise RuntimeError(
            f"{total} chips cannot hold model_parallel={model_parallel}")
    p2 = 1
    while p2 * 2 <= data:
        p2 *= 2
    dropped = total - p2 * model_parallel
    return (p2, model_parallel), ("data", "model"), dropped


# ---------------------------------------------------------------------------
# straggler-aware static partitioning (mining jobs)
# ---------------------------------------------------------------------------

def balanced_vertex_partition(degrees: np.ndarray, num_parts: int,
                              alpha: float = 1.0) -> np.ndarray:
    """Assign vertices to workers balancing Σ deg^(1+alpha) (intersection
    cost ~ deg^2 for the mining wavefront): greedy LPT on the cost.

    Deterministic => any worker can recompute any partition (work stealing
    at bucket granularity needs no coordination)."""
    cost = degrees.astype(np.float64) ** (1.0 + alpha)
    order = np.argsort(-cost)
    load = np.zeros(num_parts)
    assign = np.zeros(len(degrees), dtype=np.int32)
    for v in order:
        w = int(np.argmin(load))
        assign[v] = w
        load[w] += cost[v]
    return assign
