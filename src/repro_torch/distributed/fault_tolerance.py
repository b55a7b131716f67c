"""Fault tolerance: checkpoint/restart, elastic shrink, straggler
mitigation.

Counterpart of `repro.distributed.fault_tolerance`, copied (host-side
control flow). On a real cluster the coordinator detects node loss
(missed heartbeats, a collective timeout); here the same control flow is
driven explicitly so the logic is testable on one machine:

  * `CheckpointPolicy` + the manager wrap `repro_torch.training.checkpoint`
    with periodic saves and resume-from-latest.
  * `ElasticMeshManager.shrink()` rebuilds a smaller data axis after a
    node loss (power-of-two sizes): the serving fleet's shard-loss
    recovery (`StreamingKWSServer.recover_shard_loss`) shrinks its shard
    list with it.
  * `StragglerMonitor` tracks per-step durations (EMA + deviation); steps
    slower than `threshold` x EMA are flagged, and after `budget`
    consecutive flags it recommends eviction/re-mesh (policy hook — the
    decision stays with the orchestrator).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional

from repro_torch.training import checkpoint as ckpt

Pytree = Any


@dataclasses.dataclass
class CheckpointPolicy:
    directory: str
    every_steps: int = 100
    keep: int = 3
    async_save: bool = True


class CheckpointManager:
    def __init__(self, policy: CheckpointPolicy):
        self.policy = policy
        self._pending = None

    def maybe_save(self, step: int, tree: Pytree):
        # step 0 is the untrained init: `0 % every_steps == 0` used to
        # save it, burning a `keep` slot and making restore_latest's
        # answer after an early crash a checkpoint with zero training
        # in it. The first real save is at `every_steps`.
        if step == 0 or step % self.policy.every_steps:
            return
        self.wait()
        self._pending = ckpt.save_checkpoint(
            self.policy.directory, step, tree,
            keep=self.policy.keep, async_save=self.policy.async_save,
        )

    def wait(self):
        if self._pending is not None:
            self._pending.join()
            self._pending = None

    def restore_latest(self, template: Pytree, device=None):
        self.wait()
        return ckpt.restore_checkpoint(
            self.policy.directory, template, device=device
        )


class ElasticMeshManager:
    """Rebuilds the mesh with a smaller data axis on node loss.

    The model axis is preserved (model-parallel groups die together on a
    real pod slice); lost capacity comes out of data parallelism, and the
    global batch either shrinks or is re-split (caller's choice via
    `batch_resize`).
    """

    def __init__(self, make_mesh: Callable[[int], Any],
                 initial_data_size: int):
        self.make_mesh = make_mesh
        self.data_size = initial_data_size

    def shrink(self, lost_nodes: int = 1):
        new_size = self.data_size - lost_nodes
        # keep the data axis a divisor-friendly size (power of two here)
        while new_size > 1 and (new_size & (new_size - 1)):
            new_size -= 1
        if new_size < 1:
            raise RuntimeError("no capacity left after failures")
        self.data_size = new_size
        return self.make_mesh(new_size)


@dataclasses.dataclass
class StragglerEvent:
    step: int
    duration: float
    ema: float


class StragglerMonitor:
    """Per-step duration tracking with an EMA baseline.

    ``warmup`` steps (default 1) are discarded entirely before the EMA
    is seeded: the first step of a loop includes its compilation (on the
    card, the kernels' build and first load), so seeding the baseline
    from it poisons the EMA ~100x high and real stragglers are never
    flagged (a 2x-slow step against a 100x-high
    baseline looks fast). The EMA seeds from the first post-warmup
    duration instead.
    """

    def __init__(self, threshold: float = 2.0, budget: int = 3,
                 ema_alpha: float = 0.1, warmup: int = 1):
        if warmup < 0:
            raise ValueError(f"warmup must be >= 0, got {warmup}")
        self.threshold = threshold
        self.budget = budget
        self.alpha = ema_alpha
        self.warmup = warmup
        self._seen = 0
        self.ema: Optional[float] = None
        self.consecutive = 0
        self.events: List[StragglerEvent] = []

    def record(self, step: int, duration: float) -> bool:
        """Returns True when the eviction/re-mesh budget is exhausted."""
        if self._seen < self.warmup:
            # compilation / cold-cache steps: not data, not baseline
            self._seen += 1
            return False
        if self.ema is None:
            self.ema = duration
            return False
        slow = duration > self.threshold * self.ema
        if slow:
            self.consecutive += 1
            self.events.append(StragglerEvent(step, duration, self.ema))
        else:
            self.consecutive = 0
            # only fold healthy steps into the EMA (stragglers would
            # poison the baseline)
            self.ema = (1 - self.alpha) * self.ema + self.alpha * duration
        return self.consecutive >= self.budget

    def timed(self, step: int) -> "_Timed":
        """with monitor.timed(step): ... — records duration on exit."""
        return _Timed(self, step)


class _Timed:
    def __init__(self, monitor: StragglerMonitor, step: int):
        self.monitor = monitor
        self.step = step

    def __enter__(self):
        self.t0 = time.monotonic()
        return self

    def __exit__(self, *exc):
        self.monitor.record(self.step, time.monotonic() - self.t0)
        return False
