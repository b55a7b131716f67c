"""Slot routing for stream serving: stream_id -> slot.

Copy of the `StreamRouter` of `repro.serving.autoscale` (pure host-side
bookkeeping). A server's slot axis may be split block-wise over
``n_shards`` devices; `acquire` hands out the lowest free local slot on
the least-loaded shard (ties to the lowest shard id), so concurrent
streams spread round-robin and per-device batches stay balanced. With
``n_shards=1`` it is a plain free list, lowest slot first. Resizing and
the autoscaler arrive with the elastic-fleet slice (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import List

__all__ = ["SlotPlacement", "StreamRouter", "shard_of_slot"]


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
