"""Slot routing and capacity control for stream serving.

Counterpart of `repro.serving.autoscale`, copied (pure host-side
bookkeeping, no device code). A server's slot axis is split block-wise
over ``n_shards`` shards (`StreamingKWSServer(devices=...)`): global
slots ``[k * slots_per_shard, (k + 1) * slots_per_shard)`` live on
shard ``k``. `StreamRouter.acquire` hands out the lowest free local slot
on the least-loaded shard (ties to the lowest shard id), so concurrent
streams spread round-robin and per-shard batches stay balanced; with
``n_shards=1`` it is a plain free list, lowest slot first.
`StreamRouter.remap` re-places occupied slots onto a new geometry, the
primitive of `StreamingKWSServer.resize` and `recover_shard_loss`.

`Autoscaler` closes the loop from telemetry to capacity: it watches
occupancy (open slots / capacity) and per-tick latency (through a
`repro_torch.distributed.fault_tolerance.StragglerMonitor`) and calls
`StreamingKWSServer.resize` under hysteresis: grow when occupancy holds
above the high watermark (or an open is rejected at capacity), shrink
when it holds below the low watermark AND the latency SLO is healthy
(shrinking packs more streams per shard, so a breached SLO vetoes it).
Every decision is deterministic host-side policy; the resize itself is
the server's bitwise copy of the open streams' state.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, List, Optional

__all__ = [
    "SlotPlacement",
    "StreamRouter",
    "shard_of_slot",
    "AutoscalePolicy",
    "Autoscaler",
]


def shard_of_slot(slot: int, max_streams: int, n_shards: int) -> int:
    """Shard owning a global slot under block-wise sharding."""
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if max_streams % n_shards != 0:
        raise ValueError(
            f"max_streams={max_streams} must divide evenly over "
            f"{n_shards} shard(s)"
        )
    if not 0 <= slot < max_streams:
        raise ValueError(f"slot {slot} outside [0, {max_streams})")
    return slot // (max_streams // n_shards)


@dataclasses.dataclass(frozen=True)
class SlotPlacement:
    """Where a global slot lives."""

    shard: int
    local_slot: int
    slot: int  # global: shard * slots_per_shard + local_slot


class StreamRouter:
    """Balanced slot allocator over ``n_shards`` equal shard blocks."""

    def __init__(self, max_streams: int, n_shards: int = 1):
        if n_shards < 1:
            raise ValueError("n_shards must be >= 1")
        if max_streams % n_shards != 0:
            raise ValueError(
                f"max_streams={max_streams} must divide evenly over "
                f"{n_shards} shard(s)"
            )
        self.max_streams = max_streams
        self.n_shards = n_shards
        self.slots_per_shard = max_streams // n_shards
        self._free: List[List[int]] = [
            list(range(self.slots_per_shard)) for _ in range(n_shards)
        ]
        for f in self._free:
            heapq.heapify(f)

    @property
    def free_count(self) -> int:
        return sum(len(f) for f in self._free)

    def shard_loads(self) -> List[int]:
        """Open slots per shard (the balance the round-robin fill keeps)."""
        return [self.slots_per_shard - len(f) for f in self._free]

    def placement(self, slot: int) -> SlotPlacement:
        shard = shard_of_slot(slot, self.max_streams, self.n_shards)
        return SlotPlacement(
            shard=shard,
            local_slot=slot - shard * self.slots_per_shard,
            slot=slot,
        )

    def acquire(self) -> int:
        """Lowest free local slot on the least-loaded shard (ties to the
        lowest shard id). Raises RuntimeError at capacity."""
        best = None
        for shard, free in enumerate(self._free):
            if not free:
                continue
            load = self.slots_per_shard - len(free)
            if best is None or load < best[0]:
                best = (load, shard)
        if best is None:
            raise RuntimeError("server at capacity")
        shard = best[1]
        local = heapq.heappop(self._free[shard])
        return shard * self.slots_per_shard + local

    def release(self, slot: int) -> None:
        p = self.placement(slot)
        if p.local_slot in self._free[p.shard]:
            raise ValueError(f"slot {slot} already free")
        heapq.heappush(self._free[p.shard], p.local_slot)

    @classmethod
    def remap(
        cls,
        occupied: List[int],
        new_max_streams: int,
        n_shards: int = 1,
    ) -> "tuple[StreamRouter, Dict[int, int]]":
        """Re-place occupied slots onto a fresh router geometry.

        The resize/reshard primitive: given the occupied slots of the
        OLD layout, build a new router at ``new_max_streams`` over
        ``n_shards`` and acquire one slot per occupied old slot, in
        ascending old-slot order (deterministic, so a lifecycle
        oracle can replay it). Returns ``(router, {old_slot:
        new_slot})``; the router is left with every mapped slot
        acquired, so subsequent `acquire` calls continue the balanced
        round-robin fill. Raises ValueError when the occupied slots
        outnumber the new capacity (a shrink below the live stream
        count must be rejected before any state moves).
        """
        if len(occupied) > new_max_streams:
            raise ValueError(
                f"cannot remap {len(occupied)} occupied slot(s) into "
                f"capacity {new_max_streams}"
            )
        if len(set(occupied)) != len(occupied):
            raise ValueError("occupied slots must be unique")
        router = cls(new_max_streams, n_shards)
        mapping = {old: router.acquire() for old in sorted(occupied)}
        return router, mapping


# --------------------------------------------------------------------------
# Occupancy/SLO-driven autoscaling
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class AutoscalePolicy:
    """When to grow/shrink a server's slot capacity.

    grow_at / shrink_at   occupancy watermarks (open / capacity). The
                          band between them is the hysteresis dead
                          zone — a fleet oscillating around one
                          threshold never resizes.
    hysteresis_ticks      consecutive observations beyond a watermark
                          before acting (transient spikes don't flap
                          capacity).
    cooldown_ticks        observations to ignore after any resize
                          (resharding has a real pause cost; back-to-
                          back actions are never warranted).
    factor                grow multiplies capacity by it, shrink
                          divides (the slot axis doubles/halves, so
                          the mesh block layout stays even).
    min_streams /
    max_streams           hard capacity bounds (both must divide over
                          the server's shard count).
    """

    min_streams: int = 8
    max_streams: int = 1024
    grow_at: float = 0.85
    shrink_at: float = 0.30
    hysteresis_ticks: int = 4
    cooldown_ticks: int = 16
    factor: int = 2

    def __post_init__(self):
        if not 0.0 < self.shrink_at < self.grow_at <= 1.0:
            raise ValueError(
                f"need 0 < shrink_at < grow_at <= 1; got "
                f"shrink_at={self.shrink_at}, grow_at={self.grow_at}"
            )
        if self.min_streams < 1 or self.max_streams < self.min_streams:
            raise ValueError(
                f"need 1 <= min_streams <= max_streams; got "
                f"{self.min_streams}, {self.max_streams}"
            )
        if self.factor < 2:
            raise ValueError(f"factor must be >= 2, got {self.factor}")
        if self.hysteresis_ticks < 1 or self.cooldown_ticks < 0:
            raise ValueError("hysteresis_ticks >= 1, cooldown_ticks >= 0")


class Autoscaler:
    """Occupancy/SLO-driven capacity control for a `StreamingKWSServer`.

    Call `observe(tick_seconds)` once per serving tick (tick_seconds
    optional — without it only occupancy drives decisions) and
    `note_rejection()` whenever `open_stream` raised at capacity.
    `observe` returns ``"grow"`` / ``"shrink"`` when it resized the
    server this call, else None.

    Policy:
      * grow  — occupancy >= grow_at for hysteresis_ticks consecutive
                observations, OR any rejected open since the last
                observation (a rejection is a hard signal; it still
                respects the cooldown and the max_streams cap).
      * shrink — occupancy <= shrink_at for hysteresis_ticks AND the
                latency SLO is healthy: the `StragglerMonitor` (see
                `repro_torch.distributed.fault_tolerance`; warm-up steps
                excluded via its ``warmup``) has no active straggler
                streak. Shrinking packs more streams per shard, so a
                breached SLO vetoes it. The shrink target is clamped
                so open streams always fit.
      * both  — only in multiples of the server's shard count, never
                within cooldown_ticks of the previous action.

    History: every applied resize appends to `events` ({step, action,
    from, to, reason}) and becomes `last_decision` — reason is
    ``"rejection"`` or ``"occupancy_watermark"`` for grows,
    ``"occupancy_watermark"`` for shrinks. A shrink the SLO vetoed is
    recorded as `last_decision` (and journaled) with action
    ``"hold"`` / reason ``"slo_veto"`` once per hysteresis trip, so
    "why didn't it shrink?" is answerable. When the server carries a
    `metrics=` registry, every decision (applied or vetoed) is also
    journaled as an ``"autoscale"`` event with before/after capacity
    and counted in ``kws_autoscale_decisions_total{action=...}``.
    """

    def __init__(self, server, policy: Optional[AutoscalePolicy] = None,
                 monitor=None):
        if monitor is None:
            from repro_torch.distributed.fault_tolerance import StragglerMonitor

            monitor = StragglerMonitor()
        self.server = server
        self.policy = policy or AutoscalePolicy()
        self.monitor = monitor
        self.metrics = getattr(server, "metrics", None)
        self._step = 0
        self._above = 0
        self._below = 0
        self._cooldown = 0
        self._rejections = 0
        self.events: List[dict] = []  # {step, action, from, to, reason}
        self.last_decision: Optional[dict] = None

    @property
    def occupancy(self) -> float:
        return len(self.server.active) / self.server.max_streams

    def note_rejection(self) -> None:
        """An `open_stream` was refused at capacity — the strongest
        grow signal there is."""
        self._rejections += 1

    def _record(self, action: str, reason: str, frm: int,
                to: int) -> dict:
        decision = {
            "step": self._step, "action": action, "from": frm,
            "to": to, "reason": reason,
        }
        self.last_decision = decision
        if self.metrics is not None:
            self.metrics.journal.append(
                "autoscale", step=self._step, action=action,
                reason=reason, from_streams=frm, to_streams=to,
                open_streams=len(self.server.active),
            )
            self.metrics.counter(
                "kws_autoscale_decisions_total",
                "autoscaler decisions by outcome",
                action=action,
            ).inc()
        return decision

    def _resize(self, action: str, target: int,
                reason: str) -> Optional[str]:
        if target == self.server.max_streams:
            return None
        frm = self.server.max_streams
        self.server.resize(target)
        self.events.append(self._record(action, reason, frm, target))
        self._above = self._below = 0
        self._rejections = 0
        self._cooldown = self.policy.cooldown_ticks
        return action

    def observe(self, tick_seconds: Optional[float] = None
                ) -> Optional[str]:
        pol = self.policy
        slo_breach = False
        if tick_seconds is not None:
            slo_breach = self.monitor.record(self._step, tick_seconds)
        self._step += 1
        occ = self.occupancy
        if occ >= pol.grow_at:
            self._above += 1
            self._below = 0
        elif occ <= pol.shrink_at:
            self._below += 1
            self._above = 0
        else:
            self._above = self._below = 0
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        n_dev = self.server.n_devices
        cap = self.server.max_streams
        if self._rejections or self._above >= pol.hysteresis_ticks:
            reason = (
                "rejection" if self._rejections
                else "occupancy_watermark"
            )
            target = min(cap * pol.factor, pol.max_streams)
            target -= target % n_dev
            if target > cap:
                return self._resize("grow", target, reason)
            self._rejections = 0  # at the cap: nothing to do, stop
            return None           # re-firing every observation
        slo_unhealthy = slo_breach or self.monitor.consecutive > 0
        if self._below >= pol.hysteresis_ticks:
            if slo_unhealthy:
                # record the veto once per hysteresis trip (the
                # condition re-fires every low-occupancy tick; the
                # FIRST qualifying one is the decision point)
                if self._below == pol.hysteresis_ticks:
                    self._record("hold", "slo_veto", cap, cap)
                return None
            target = max(cap // pol.factor, pol.min_streams)
            # open streams must fit, in whole per-shard blocks
            floor = -(-len(self.server.active) // n_dev) * n_dev
            target = max(target, floor, n_dev)
            target -= target % n_dev
            if 0 < target < cap:
                return self._resize("shrink", target,
                                    "occupancy_watermark")
        return None
