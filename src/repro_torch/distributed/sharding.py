"""Device placement of the stream-parallel serving fleet.

Counterpart of the serving part of `repro.distributed.sharding` (the
LM's parameter sharding rules are not ported). The KWS server's unit of
parallelism is the stream slot: every per-slot state tensor, input slab
and submitted mask leads with the (max_streams,) slot axis, and slots
are independent (no cross-slot reduction anywhere in the tick). Where
the reference splits that axis block-wise over a 1-D ``("stream",)``
mesh, the port splits it over a list of shard devices
(`StreamingKWSServer(devices=...)`): shard ``k`` holds slots ``[k *
max_streams / n, (k + 1) * max_streams / n)`` in tensors of its own on
``devices[k]`` and gets one tick kernel launch a tick. Entries may
repeat, so one card can run several shards.
"""

from __future__ import annotations

from typing import Any, List, Sequence, Union

import torch

from repro_torch.kernels.build import resolve_device

__all__ = ["stream_devices", "surviving_devices"]


def _canonical(device) -> torch.device:
    """``device`` resolved (a CUDA device needs a card) and, for CUDA,
    with its index, so equal placements compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def stream_devices(devices: Union[int, Sequence[Any], None] = None) -> List[torch.device]:
    """The shard devices of a stream-parallel server.

    devices: an int (the first N visible CUDA devices), a sequence of
    devices (``torch.device`` or strings; entries may repeat, one shard
    each), or None for every visible CUDA device. An int larger than the
    visible device count raises, as does a mix of device types: serving
    capacity planning must not silently degrade.
    """
    if devices is None or isinstance(devices, int):
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = visible if devices is None else devices
        if want < 1 or want > visible:
            raise ValueError(
                f"stream_devices(devices={devices}) but only {visible} "
                "device(s) visible"
            )
        return [torch.device("cuda", i) for i in range(want)]
    devs = [_canonical(d) for d in devices]
    if not devs:
        raise ValueError("stream_devices: the device list is empty")
    if len({d.type for d in devs}) > 1:
        raise ValueError(
            f"stream_devices: every shard must be on one device type; got "
            f"{[str(d) for d in devs]}"
        )
    return devs


def surviving_devices(devices: Sequence[torch.device], lost_index: int) -> list:
    """The shard devices minus the lost shard's entry, in shard order: the
    pool a shard-loss recovery rebuilds its (smaller) fleet from
    (`StreamingKWSServer.recover_shard_loss` hands it to
    `ElasticMeshManager`, whose power-of-two shrink takes a prefix)."""
    devs = list(devices)
    if not 0 <= lost_index < len(devs):
        raise ValueError(
            f"lost_index {lost_index} outside mesh of {len(devs)} device(s)"
        )
    return [d for i, d in enumerate(devs) if i != lost_index]
