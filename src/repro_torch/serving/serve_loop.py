"""Streaming KWS serving: the paper's deployment shape.

Counterpart of the KWS side of `repro.serving.serve_loop`:
`StreamingKWSServer` serves N concurrent audio streams, one tick per
16 ms frame. Each tick accepts, per stream, EITHER a precomputed FV_Norm
frame (C,) OR a raw 16 ms audio hop (`pipeline.chunk_samples` samples);
raw audio goes through the pipeline's frontend ("software", or the
"hardware" / "hardware-pallas" chip simulation on the die of the
frontend state) with a per-stream carry, so the server is audio in,
posteriors out.

The whole tick (frontend, both GRU layers, FC, softmax, smoothing and
the masked state advance) is ONE launch of the hand-written CUDA kernel
`repro_torch.kernels.tick_fused` on the card; on the CPU it is the plain
PyTorch tick. State (GRU hidden states, frontend carry, smoothed scores)
lives in one `ServerState`; a stream that did not submit keeps every
byte of its state across the tick. `open_stream`/`close_stream` recycle
slots through a `StreamRouter`, zeroing only the reused slot.

It serves all five classifier backends (float, qat, integer, delta,
delta-int); the ΔGRU backends' per-stream sparsity is
`StreamingKWSServer.sparsity`. A pipeline with a cascade
(`KWSPipelineConfig.cascade`) gates the classifier per stream behind the
stage-1 wake detector inside the same launch; its duty cycle is
`StreamingKWSServer.wake_rate`. `step_batch_async` / `run_batch_async`
return a `repro_torch.serving.ingress.TickHandle` without waiting for the
card (the pipelined ingress of `repro_torch.serving.ingress` builds on
them), and ``metrics=`` instruments the server into a
`repro_torch.serving.metrics.MetricsRegistry`.

The fleet: ``devices=`` splits the slot axis block-wise over shards
(`repro_torch.distributed.sharding.stream_devices`; entries may repeat,
so one card runs several shards). Each shard keeps its slots' state in
tensors of its own on its device and gets one kernel launch a tick, the
counterpart of the reference's one kernel per shard under ``shard_map``.
`resize` grows or shrinks the capacity live, copying the open streams'
state bitwise (`repro_torch.serving.autoscale.Autoscaler` drives it
from occupancy and latency), and `recover_shard_loss` shrinks the fleet
onto the surviving shards after one is lost.

The LM side: `lower_prefill` and `lower_decode_step` trace a backbone's
prefill and one decode step on fake tensors under
`repro_torch.launch.roofline.GraphAnalysis` (the dry run's serving cells:
FLOPs, HBM bytes, peak memory on one device, nothing allocated);
`serve_batch_shape` / `prefill_batch_shape` give their inputs' shapes.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.frontend import tree_leaves
from repro_torch.core.gru_delta import effective_mac_fraction
from repro_torch.distributed.sharding import stream_devices, surviving_devices
from repro_torch.kernels.tick_fused import pack_operands, tick_fused
from repro_torch.serving import cascade as cascade_lib
from repro_torch.serving.autoscale import StreamRouter, shard_of_slot
from repro_torch.serving.ingress import TickHandle
from repro_torch.serving.metrics import MetricsRegistry

__all__ = ["ServerState", "StreamingKWSServer", "serve_batch_shape", "prefill_batch_shape",
           "lower_decode_step", "lower_prefill"]

_TICK_IMPLS = ("auto",)


# --------------------------------------------------------------------------
# LM serving: the dry run's prefill and decode cells
# --------------------------------------------------------------------------

def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def serve_batch_shape(arch_cfg, shape_spec) -> Dict[str, torch.Tensor]:
    """One decode step's input for the given shape, as ``meta`` tensors
    (the reference's ShapeDtypeStructs): a token, or an embedding, a row."""
    b = shape_spec.global_batch
    if arch_cfg.frontend == "embedding":
        return {"embeddings": _meta((b, 1, arch_cfg.d_model), arch_cfg.activation_dtype)}
    return {"tokens": _meta((b, 1), torch.int32)}


def prefill_batch_shape(arch_cfg, shape_spec) -> Dict[str, torch.Tensor]:
    """A prefill's prompt for the given shape, as ``meta`` tensors."""
    b, s = shape_spec.global_batch, shape_spec.seq_len
    if arch_cfg.frontend == "embedding":
        return {"embeddings": _meta((b, s, arch_cfg.d_model), arch_cfg.activation_dtype)}
    return {"tokens": _meta((b, s), torch.int32)}


def _share_of(trees: dict, specs: dict, rules, device) -> dict:
    """Each whole (fake) tree's piece at a coordinate, as zero tensors on
    ``device`` (`sharding.local_shapes`)."""
    from repro_torch.distributed.sharding import local_shapes
    from repro_torch.training.optimizer import tree_map

    return {k: tree_map(lambda t: torch.zeros(tuple(t.shape), dtype=t.dtype, device=device),
                        local_shapes(v, specs[k], rules.mesh)) for k, v in trees.items()}


def lower_decode_step(arch_cfg, shape_spec, device=None, rules=None, coord=None):
    """One decode step at (batch, cache length) = the shape's (global
    batch, seq_len), traced on fake tensors: returns ``(analysis,
    params_shape, cache_shape)``, the step's `GraphAnalysis` with the
    parameters, the cache `init_cache` makes and the step's input held (the
    new cache the step returns counts among its outputs); a config that
    serves its experts quantized has int8 expert banks
    (`models.moe_quant`). Beside the reference's arguments it takes the
    ``device`` of the fake tensors (default: the card); ``rules``
    (optional) runs the sharded step under `make_mesh_context(rules)`,
    every grid coordinate's share on the one device; with ``coord`` too,
    that coordinate's share alone (parameters, cache and batch its pieces
    by `param_specs`, `cache_specs`, `batch_specs`; the collectives lone)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import (
        batch_specs,
        cache_specs,
        make_mesh_context,
        param_specs,
    )
    from repro_torch.kernels.build import resolve_device
    from repro_torch.launch.roofline import GraphAnalysis
    from repro_torch.models.moe_quant import quantize_expert_params
    from repro_torch.models.registry import get_backbone
    from repro_torch.training.train_loop import _mesh_context, fake_like

    device = resolve_device(device)
    backbone = get_backbone(arch_cfg)
    mesh_ctx = _mesh_context(rules)
    b, s = shape_spec.global_batch, shape_spec.seq_len
    with FakeTensorMode():
        params = backbone.init_params(torch.Generator().manual_seed(0), arch_cfg, mesh_ctx,
                                      device=device)
        if arch_cfg.serve_quant:
            params = quantize_expert_params(params)
        cache = backbone.init_cache(arch_cfg, b, s, mesh_ctx, device=device)
        batch = fake_like(serve_batch_shape(arch_cfg, shape_spec), device)
        if coord is not None:
            specs = {"params": param_specs(params, rules), "batch": batch_specs(batch, rules),
                     "cache": cache_specs(cache, rules, b)}
            share = _share_of({"params": params, "batch": batch, "cache": cache}, specs, rules,
                              device)
            params, batch, cache = share["params"], share["batch"], share["cache"]
            mesh_ctx = make_mesh_context(rules, coord, specs)
        cache_len = torch.zeros((), dtype=torch.int32, device=device)
        analysis = GraphAnalysis()
        analysis.hold((params, cache, batch, cache_len))
        with analysis:
            backbone.decode_step(params, cache, cache_len, batch, arch_cfg, mesh_ctx)
    return analysis, params, cache


def lower_prefill(arch_cfg, shape_spec, device=None, rules=None, coord=None):
    """A prefill of the shape's (global batch, seq_len) prompt traced on
    fake tensors: returns ``(analysis, params_shape)``, the parameters and
    the prompt held, on ``device`` (default: the card); ``rules`` and
    ``coord`` as `lower_decode_step`'s (the cache it writes laid out by
    `cache_specs`)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import (
        batch_specs,
        cache_specs,
        make_mesh_context,
        param_specs,
    )
    from repro_torch.kernels.build import resolve_device
    from repro_torch.launch.roofline import GraphAnalysis
    from repro_torch.models.registry import get_backbone
    from repro_torch.training.train_loop import _mesh_context, fake_like

    device = resolve_device(device)
    backbone = get_backbone(arch_cfg)
    mesh_ctx = _mesh_context(rules)
    b, s = shape_spec.global_batch, shape_spec.seq_len
    with FakeTensorMode():
        params = backbone.init_params(torch.Generator().manual_seed(0), arch_cfg, mesh_ctx,
                                      device=device)
        batch = fake_like(prefill_batch_shape(arch_cfg, shape_spec), device)
        if coord is not None:
            cache = backbone.init_cache(arch_cfg, b, s, mesh_ctx, device="meta")
            specs = {"params": param_specs(params, rules), "batch": batch_specs(batch, rules),
                     "cache": cache_specs(cache, rules, b)}
            share = _share_of({"params": params, "batch": batch}, specs, rules, device)
            params, batch = share["params"], share["batch"]
            mesh_ctx = make_mesh_context(rules, coord, specs)
        analysis = GraphAnalysis()
        analysis.hold((params, batch))
        with analysis:
            backbone.prefill(params, batch, arch_cfg, mesh_ctx)
    return analysis, params


@dataclasses.dataclass
class ServerState:
    """All per-slot state of a `StreamingKWSServer`.

    gru    — per-layer classifier state: (max_streams, H) float32 for
             float / qat, int32 Q6.8 codes for integer; for delta /
             delta-int a dict per layer of the seven ΔGRU leaves (h,
             x_ref, h_ref, acc_x, acc_h and the skipped / total counters).
    carry  — frontend carry, (max_streams, C) float32 leaves: the filter
             state {"s1", "s2"}, and for the hardware frontends also the
             SRO phase carry "r" and the frame-edge jitter "j" (which the
             server, drawing no noise, never changes).
    scores — exponentially smoothed posteriors, (max_streams, K).
    det    — the stage-1 wake gate's state for a cascaded pipeline
             (`repro_torch.serving.cascade.init_state`: bool ``awake``,
             int32 ``hang`` / ``woken`` / ``ticks``, each (max_streams,));
             None without a cascade.

    On the card each tick updates these tensors in place (the
    counterpart of the reference's buffer donation); all-zeros is every
    backend's fresh state. A sharded server keeps one per shard, each
    over that shard's block of slots.
    """

    gru: Tuple[torch.Tensor, ...]
    carry: Dict[str, torch.Tensor]
    scores: torch.Tensor
    det: Optional[Dict[str, torch.Tensor]] = None

    def leaves(self):
        """Every state tensor (the detector's too, when there is one)."""
        return tree_leaves((self.gru, self.carry, self.scores, self.det))


def _map_state(fn, *states: ServerState) -> ServerState:
    """A `ServerState` whose every leaf is ``fn`` of the leaves in the same
    place of ``states`` (which share one structure)."""

    def walk(*nodes):
        first = nodes[0]
        if first is None:
            return None
        if isinstance(first, dict):
            return {k: walk(*(n[k] for n in nodes)) for k in first}
        if isinstance(first, (tuple, list)):
            return type(first)(walk(*xs) for xs in zip(*nodes))
        return fn(*nodes)

    return ServerState(*(walk(*(getattr(st, f.name) for st in states))
                         for f in dataclasses.fields(ServerState)))


def _reset_slots(state: ServerState, slots: List[int]) -> None:
    """Zero the given slots' slices of every state tensor, in place (one
    indexed write a tensor); the zero is written in each leaf's own dtype
    (the cascade's awake latch is bool)."""
    idx = slots[0] if len(slots) == 1 else torch.as_tensor(
        slots, dtype=torch.int64, device=state.scores.device)
    for t in state.leaves():
        t[idx] = 0


def _host(t: torch.Tensor) -> np.ndarray:
    """An owned host copy (never a view of a buffer the next tick writes)."""
    return t.detach().to("cpu", copy=True).numpy()


def _check_shapes(slab, mask, want: Tuple[int, ...]) -> None:
    if tuple(np.shape(slab)[:-1]) != want or tuple(np.shape(mask)) != want:
        raise ValueError(
            f"slab must be {want} + (dim,) and mask {want}; got "
            f"{tuple(np.shape(slab))} and {tuple(np.shape(mask))}"
        )


class StreamingKWSServer:
    """Batched frame-synchronous KWS over N concurrent audio streams.

    Each tick: callers push, per active stream, either one FV_Norm (C,)
    or one raw 16 ms audio hop; the kinds may not be mixed within one
    tick. Streams that did not submit are masked out of every state
    update.

    ``device`` defaults to the card (``"cuda"``); with no CUDA device the
    constructor raises, and ``device="cpu"`` runs the plain PyTorch tick.
    ``devices`` (exclusive with ``device``) shards the slot axis: an int
    (the first N visible cards; more than are visible raises) or a list
    of devices, which may repeat (``["cuda:0"] * 4`` is four shards on
    one card). Slot ``s`` lives on shard ``shard_of_slot(s, max_streams,
    n)`` in that shard's own `ServerState` on its device; a tick launches
    the kernel once per shard on the shard's rows. One entry is the
    unsharded server. ``tick_impl`` accepts only ``"auto"``: on the card
    the tick is the CUDA kernel and nothing else (`tick_dispatch` reads
    ``"cuda"``, or ``"cpu"`` for the plain tick). ``params`` are the float
    parameters (or `QuantizedClassifier` codes for ``classifier="integer"``
    / ``"delta-int"``); the server backend-shapes them once and packs the
    kernel's operands once per distinct card.

    Two cadences drive the same launches: `step_batch` (dispatch, then
    wait for the scores) and `step_batch_async` (dispatch and return a
    `TickHandle` whose scores arrive later, so tick N's results are
    fetched while tick N+1 runs). On the card everything of a tick (the
    slab's copy in, the kernels, the scores' copy out) goes on the
    device's current CUDA stream, so tick N's copy-out is ordered before
    tick N+1 rewrites the scores in place. `run_batch` / `run_batch_async`
    run a (T, N, ·) slab as T back-to-back ticks and copy to the host
    once. Results are owned host copies, in global slot order.

    Elastic capacity: `resize` re-lays every state tensor onto a new
    capacity, the open streams' rows copied bitwise and re-placed by
    `StreamRouter.remap`; `recover_shard_loss` drops a lost shard,
    shrinks the shard list (power of two) and reopens the lost shard's
    streams on zeroed slots.

    Observability: ``metrics=`` takes a
    `repro_torch.serving.metrics.MetricsRegistry` (or ``True`` for a
    fresh one, exposed as `srv.metrics`) and records tick dispatch /
    fetch / step latency histograms keyed on the 16 ms budget, tick /
    retrace / compile counters, occupancy gauges, and a journal event for
    the server's build, every retrace, resize and shard loss. These are
    host clock reads and dict updates around the existing calls, so a
    metrics-enabled server gives bit-identical results.
    `metrics_snapshot()` rolls the registry and the server's own
    telemetry into one JSON-able dict.
    """

    def __init__(self, pipeline, params, max_streams: int = 256,
                 smoothing: float = 0.7, state=None, tick_impl: str = "auto",
                 device=None, devices=None, metrics=None):
        if device is not None and devices is not None:
            raise ValueError("pass device= or devices=, not both")
        if tick_impl not in _TICK_IMPLS:
            raise ValueError(
                f"tick_impl must be one of {_TICK_IMPLS}; got {tick_impl!r}"
            )
        # stream_devices is the one count-against-visible validator
        self.shard_devices: List[torch.device] = stream_devices(
            [device] if devices is None else devices
        )
        self.n_devices = len(self.shard_devices)
        self.device = self.shard_devices[0]
        if max_streams % self.n_devices != 0:
            raise ValueError(
                f"max_streams={max_streams} must divide over "
                f"{self.n_devices} devices"
            )
        self.tick_impl = tick_impl
        # what a tick runs: the CUDA kernel, or the plain tick on the CPU
        self.tick_dispatch = "cuda" if self.device.type == "cuda" else "cpu"
        # `_is_raw` dispatches on the trailing dim alone, so a geometry
        # where a raw hop and an FV_Norm frame have the same width would
        # route every tick down the raw-audio path.
        if pipeline.chunk_samples == pipeline.config.fex.num_channels:
            raise ValueError(
                "ambiguous serving geometry: chunk_samples == "
                f"fex.num_channels == {pipeline.chunk_samples}, so raw "
                "audio hops and FV_Norm frames are indistinguishable by "
                "width; change fex.fs_audio / frame_shift_ms / "
                "num_channels so the two differ"
            )
        if self.device.type == "cuda":
            # the QAT path's float32 products are exact only without TF32
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        self.pipeline = pipeline
        self.params = pipeline.prepare_params(params)
        self.max_streams = max_streams
        self.smoothing = smoothing
        self.frontend_state = pipeline.state if state is None else state
        self._operands: Dict[torch.device, Any] = {}
        self._shards: List[ServerState] = [
            self._fresh_state(max_streams // self.n_devices, dev)
            for dev in self.shard_devices
        ]
        self.active: Dict[int, int] = {}  # stream_id -> slot
        # slot allocation is shard placement: the router's round-robin
        # fill keeps the shards' loads balanced (one shard: lowest slot
        # first)
        self.router = StreamRouter(max_streams, self.n_devices)
        # retrace / compile accounting is kept with metrics off too
        self._retraces = 0
        self._compiles = 0
        self._tick_shapes: set = set()
        # metrics: True -> a fresh registry, a MetricsRegistry -> shared,
        # any falsy value (None / False) -> off
        if metrics is True:
            metrics = MetricsRegistry()
        elif not metrics:
            metrics = None
        self.metrics: Optional[MetricsRegistry] = metrics
        if metrics is not None:
            self._m_ticks = metrics.counter(
                "kws_serve_ticks_total",
                "fused serving ticks dispatched (scanned windows count "
                "each scanned tick)",
            )
            self._m_retraces = metrics.counter(
                "kws_serve_retraces_total",
                "dispatches that traced+compiled a new (program, "
                "operand shape) — the ticks that pay jit cost",
            )
            self._m_compiles = metrics.counter(
                "kws_serve_compile_programs_total",
                "full program rebuilds (construction and mesh changes)",
            )
            self._m_dispatch = metrics.histogram(
                "kws_serve_tick_dispatch_ms",
                "host time to dispatch one tick (or one coalesced "
                "window) — slab handoff to handle return, fetch "
                "excluded",
            )
            self._m_fetch = metrics.histogram(
                "kws_serve_tick_fetch_ms",
                "host time blocked in TickHandle.result() fetching "
                "scores to host",
            )
            self._m_tick = metrics.histogram(
                "kws_serve_tick_ms",
                "synchronous step_batch wall time (dispatch + fetch)",
            )
            self._m_open = metrics.gauge(
                "kws_serve_open_streams", "streams currently open"
            )
            self._m_cap = metrics.gauge(
                "kws_serve_capacity", "stream-slot capacity"
            )
            self._m_occ = metrics.gauge(
                "kws_serve_occupancy", "open streams / capacity"
            )
        self._update_occupancy_gauges()
        self._compile_programs()

    def _fresh_state(self, rows: int, device) -> ServerState:
        """All-zeros state of ``rows`` slots on ``device``."""
        pipeline = self.pipeline
        det = None
        if pipeline.config.cascade is not None:
            det = cascade_lib.init_state(rows, device)
        return ServerState(
            gru=tuple(pipeline.streaming_init(rows, device)),
            carry=pipeline.streaming_features_init(rows, device),
            scores=torch.zeros(
                (rows, pipeline.config.gru.num_classes),
                dtype=torch.float32, device=device,
            ),
            det=det,
        )

    def _compile_programs(self) -> None:
        """(Re)build what the ticks launch with for the current shard
        devices: the kernel operands, packed once per distinct card (the
        reference's ``_compile_programs``, which rebuilds its jitted
        programs). Runs at construction and again only when the shard
        devices change (`recover_shard_loss`); a `resize` keeps them. A
        rebuild resets the retrace tracking, so every operand shape
        counts again."""
        self._tick_shapes.clear()
        self._compiles += 1
        if self.metrics is not None:
            self._m_compiles.inc()
            self.metrics.journal.append(
                "compile_programs", n_devices=self.n_devices,
                max_streams=self.max_streams, tick_impl=self.tick_impl,
            )
        self._operands = {
            dev: pack_operands(self.pipeline, self.params,
                               self.frontend_state, dev)
            for dev in dict.fromkeys(self.shard_devices)
            if dev.type == "cuda"
        }

    # ---- observability ----

    @property
    def retrace_count(self) -> int:
        """Dispatches so far of a (program, shape) pair not seen before:
        ``tick_audio`` / ``tick_fv`` for a live tick, ``run_audio`` /
        ``run_fv`` for a replay, keyed by the slab's shape. The reference
        counts the ticks that trace and compile a new XLA program; the
        port compiles nothing per shape (the CUDA kernel is built once per
        process), so here a retrace is the first launch at that shape: the
        first tick after a `resize` to a capacity not served yet counts, a
        resize back to a seen capacity does not, and a rebuild
        (`recover_shard_loss`) makes every shape count again. Tracked
        with metrics off too."""
        return self._retraces

    @property
    def compile_count(self) -> int:
        """Program builds so far: 1 after construction (the kernel
        operands packed for this server), +1 per `recover_shard_loss`,
        which changes the shard devices; a `resize` builds nothing."""
        return self._compiles

    def _note_dispatch(self, program: str, shape) -> None:
        """Record one dispatch of `program` at `shape`; the first (program,
        shape) pair is a retrace."""
        key = (program, tuple(int(d) for d in shape))
        if key in self._tick_shapes:
            return
        self._tick_shapes.add(key)
        self._retraces += 1
        if self.metrics is not None:
            self._m_retraces.inc()
            self.metrics.journal.append(
                "retrace", program=program, shape=list(key[1]),
                max_streams=self.max_streams,
            )

    def _update_occupancy_gauges(self) -> None:
        if self.metrics is None:
            return
        n = len(self.active)
        self._m_open.set(n)
        self._m_cap.set(self.max_streams)
        self._m_occ.set(n / self.max_streams if self.max_streams else 0.0)

    def metrics_snapshot(self) -> Dict[str, Any]:
        """One JSON-able dict of everything observable about the server.

        ``server`` block: identity (tick_impl / dispatch / device count),
        capacity and occupancy, retrace / compile counts, and the mean
        `sparsity` and `wake_rate` over the open slots (None with no
        stream open; these read state on the card, a host sync, so take
        snapshots off the tick path). With ``metrics=`` on, the registry's
        snapshot (counters, gauges, histograms with percentiles, journal,
        span rollups) is merged in.
        """
        slots = sorted(self.active.values())
        server: Dict[str, Any] = {
            "tick_impl": self.tick_impl,
            "tick_dispatch": self.tick_dispatch,
            "n_devices": self.n_devices,
            "max_streams": self.max_streams,
            "open_streams": len(self.active),
            "occupancy": (
                len(self.active) / self.max_streams
                if self.max_streams else 0.0
            ),
            "retraces": self._retraces,
            "compiles": self._compiles,
            "sparsity_mean": (
                float(np.mean(self.sparsity[slots])) if slots else None
            ),
            "wake_rate_mean": (
                float(np.mean(self.wake_rate[slots])) if slots else None
            ),
        }
        snap: Dict[str, Any] = {"server": server}
        if self.metrics is not None:
            snap.update(self.metrics.snapshot())
        return snap

    # ---- state views (global slot order) ----

    @property
    def state(self) -> ServerState:
        """The whole server's state in global slot order. Unsharded, the
        one `ServerState` the ticks update in place; sharded, a gathered
        copy on the first shard's device (writes to it reach no shard).
        Assigning a state in global slot order replaces every shard's."""
        if self.n_devices == 1:
            return self._shards[0]
        return _map_state(
            lambda *xs: torch.cat([x.to(self.device) for x in xs]),
            *self._shards,
        )

    @state.setter
    def state(self, value: ServerState) -> None:
        if self.n_devices == 1:
            self._shards[0] = value
        else:
            self._shards = self._place_state(value)

    @property
    def states(self) -> List[Any]:
        """Per-layer classifier states (the reference's pre-fused name)."""
        return list(self.state.gru)

    @property
    def feat_carry(self) -> Dict[str, torch.Tensor]:
        """Frontend streaming carry (the reference's pre-fused name)."""
        return self.state.carry

    def _rows(self, shard: int) -> slice:
        """Global slots of shard ``shard``."""
        n = self.max_streams // self.n_devices
        return slice(shard * n, (shard + 1) * n)

    @property
    def scores(self) -> np.ndarray:
        """Smoothed per-slot posteriors as an owned host array."""
        return np.concatenate([_host(st.scores) for st in self._shards])

    @property
    def sparsity(self) -> np.ndarray:
        """Per-slot effective-MAC fraction, (max_streams,) float32.

        For the ΔGRU backends it reads the skipped / total counters the
        tick advances per stream (executed / offered over the whole
        classifier, the always-dense FC included; see
        `repro_torch.core.gru_delta.effective_mac_fraction`): 1.0 is
        dense, 0.1 means the engine skipped 90 % of the eligible work.
        Counters reset with the slot on `open_stream` and advance only
        under the submitted mask. Dense backends report all ones. An
        owned host copy, computed on the host from the counters.
        """
        if self.pipeline.classifier.is_delta:
            counters = [{k: st[k].to("cpu") for k in ("skipped", "total")}
                        for st in self.state.gru]
            return effective_mac_fraction(
                counters, self.pipeline.config.gru
            ).numpy()
        return np.ones((self.max_streams,), np.float32)

    @property
    def wake_rate(self) -> np.ndarray:
        """Per-slot stage-1 wake rate, (max_streams,) float32.

        For a cascaded pipeline, the fraction of a stream's submitted
        ticks on which the gate let the classifier advance (the woken /
        ticks counters the tick advances per stream); the mean over open
        slots is the classifier's duty cycle. It composes with `sparsity`,
        which for a cascaded ΔGRU server measures sparsity within the
        woken ticks. Counters reset with the slot on `open_stream` and
        advance only under the submitted mask. Slots with no traffic, and
        every slot of an ungated server, report 1.0. An owned host copy.
        """
        if self.state.det is None:
            return np.ones((self.max_streams,), np.float32)
        det = {k: t.to("cpu") for k, t in self.state.det.items()}
        return cascade_lib.wake_rate(det).numpy()

    # ---- slot lifecycle ----

    def open_stream(self, stream_id: int):
        if stream_id in self.active:
            raise ValueError(f"stream {stream_id} already open")
        slot = self.router.acquire()  # raises RuntimeError at capacity
        self.active[stream_id] = slot
        self._reset(slot)
        self._update_occupancy_gauges()

    def close_stream(self, stream_id: int):
        if stream_id not in self.active:
            raise ValueError(f"stream {stream_id} not open")
        self.router.release(self.active.pop(stream_id))
        self._update_occupancy_gauges()

    def _reset(self, *slots: int) -> None:
        """Zero the global ``slots`` on their shards, and nothing else."""
        local: Dict[int, List[int]] = {}
        for slot in slots:
            p = self.router.placement(slot)
            local.setdefault(p.shard, []).append(p.local_slot)
        for shard, rows in local.items():
            _reset_slots(self._shards[shard], rows)

    # ---- elastic capacity: live resize and shard-loss recovery ----

    def _host_state(self, lost: Optional[int] = None) -> ServerState:
        """Owned host copies of every state leaf in global slot order.
        The copy from the card waits for every tick already enqueued on
        the stream (and for the copies of `TickHandle`s dispatched before
        it), so a resize never tears a tick. Shard ``lost``'s rows are
        zeros and are never read: its device is gone."""
        def gather(*leaves):
            return torch.cat([
                torch.zeros(x.shape, dtype=x.dtype) if k == lost
                else x.to("cpu", copy=True)
                for k, x in enumerate(leaves)
            ])

        return _map_state(gather, *self._shards)

    @staticmethod
    def _relay_state(host_state: ServerState, new_max: int, src, dst) -> ServerState:
        """Re-lay host state onto a new capacity: per leaf zeros at
        ``new_max`` slots with old rows ``src`` copied to new rows ``dst``
        by indexing alone. No arithmetic touches the data, so survivors
        are array-equal in every dtype (float32 scores, int32 Q6.8 codes,
        the bool wake latch, the ΔGRU accumulators and counters)."""
        src = torch.as_tensor(src, dtype=torch.int64)
        dst = torch.as_tensor(dst, dtype=torch.int64)

        def relay(leaf):
            out = torch.zeros((new_max,) + tuple(leaf.shape[1:]), dtype=leaf.dtype)
            out[dst] = leaf[src]
            return out

        return _map_state(relay, host_state)

    def _place_state(self, state: ServerState) -> List[ServerState]:
        """Split a state in global slot order into the shards' blocks, each
        an owned contiguous copy on its shard's device."""
        n = state.scores.shape[0] // self.n_devices
        return [
            _map_state(
                lambda x, k=k, dev=dev: x[k * n:(k + 1) * n].to(dev, copy=True),
                state,
            )
            for k, dev in enumerate(self.shard_devices)
        ]

    def resize(self, new_max_streams: int) -> None:
        """Grow or shrink the stream-slot capacity live.

        Every state tensor is re-laid onto the new capacity: open streams'
        rows are copied bitwise (through the host, then onto each shard's
        device), stream ids keep serving through the move, and the
        `StreamRouter` re-places the survivors in ascending old-slot order
        (`StreamRouter.remap`). Surviving streams are array-equal to an
        un-resized server afterwards, for every backend, the cascade's
        detector state and the ΔGRU counters. The copy waits for the ticks
        already dispatched, so a `TickHandle` taken before the resize
        still returns its tick's results.

        The shard devices do not change, so nothing is rebuilt
        (`compile_count` stays); the first tick at a capacity not served
        yet counts as a retrace. The new capacity must divide over the
        shards and hold every open stream; a shrink below the open count
        raises before any state moves. A `PipelinedIngress` over this
        server must be drained around a resize (its buffers are
        capacity-shaped; it reallocates on the next `stage()`).
        """
        if new_max_streams < 1:
            raise ValueError(
                f"new_max_streams must be >= 1, got {new_max_streams}"
            )
        if new_max_streams % self.n_devices != 0:
            raise ValueError(
                f"new_max_streams={new_max_streams} must divide over "
                f"{self.n_devices} devices"
            )
        if len(self.active) > new_max_streams:
            raise RuntimeError(
                f"cannot shrink to {new_max_streams} slots with "
                f"{len(self.active)} stream(s) open"
            )
        if new_max_streams == self.max_streams:
            return
        occupied = sorted(self.active.values())
        router, mapping = StreamRouter.remap(
            occupied, new_max_streams, self.n_devices
        )
        new_host = self._relay_state(
            self._host_state(), new_max_streams, occupied,
            [mapping[s] for s in occupied],
        )
        self._shards = self._place_state(new_host)
        self.active = {sid: mapping[slot] for sid, slot in self.active.items()}
        self.router = router
        old_max, self.max_streams = self.max_streams, new_max_streams
        if self.metrics is not None:
            self.metrics.journal.append(
                "resize", from_streams=old_max, to_streams=new_max_streams,
                open_streams=len(self.active), n_devices=self.n_devices,
            )
        self._update_occupancy_gauges()

    def recover_shard_loss(self, lost_shard: int) -> Dict[str, Any]:
        """Shrink the fleet onto the surviving shards after losing one.

        The recovery control flow of
        `repro_torch.distributed.fault_tolerance` wired into serving:

          1. every OTHER shard's state is gathered to the host (bitwise;
             the lost shard's rows are never read),
          2. `ElasticMeshManager` shrinks the shard list to a power of two
             taken from the surviving devices (4 -> 2, 2 -> 1: one
             survivor is the unsharded server),
          3. the capacity is rounded UP to whole shard blocks,
          4. survivors are remapped (ascending old-slot order) and their
             state re-laid bitwise onto the new shards,
          5. the kernel operands are packed again for the new device list
             (one more `compile_count`, and every shape retraces),
          6. the lost shard's streams reopen under their own ids on
             zeroed slots, in old-slot order (their state died with the
             device; the caller replays or resumes their audio).

        Returns ``{"lost_shard", "n_devices", "max_streams"`` (after),
        ``"reopened"`` (stream ids that lost their state), ``"survivors"``
        (stream ids kept bit for bit)``}``.
        """
        if self.n_devices == 1:
            raise ValueError("single-device server has no shards to lose")
        if not 0 <= lost_shard < self.n_devices:
            raise ValueError(
                f"lost_shard {lost_shard} outside [0, {self.n_devices})"
            )
        from repro_torch.distributed.fault_tolerance import ElasticMeshManager

        host = self._host_state(lost=lost_shard)
        healthy = surviving_devices(self.shard_devices, lost_shard)
        manager = ElasticMeshManager(
            make_mesh=lambda n: healthy[:n], initial_data_size=self.n_devices
        )
        new_devices = manager.shrink(1)
        new_n = manager.data_size
        new_max = -(-self.max_streams // new_n) * new_n
        survivors = {
            sid: slot for sid, slot in self.active.items()
            if shard_of_slot(slot, self.max_streams, self.n_devices) != lost_shard
        }
        affected = sorted(
            (slot, sid) for sid, slot in self.active.items() if sid not in survivors
        )
        occupied = sorted(survivors.values())
        router, mapping = StreamRouter.remap(occupied, new_max, new_n)
        new_host = self._relay_state(
            host, new_max, occupied, [mapping[s] for s in occupied]
        )
        old_devices, old_max = self.n_devices, self.max_streams
        self.shard_devices = list(new_devices)
        self.n_devices = new_n
        self.device = self.shard_devices[0]
        self.max_streams = new_max
        self._shards = self._place_state(new_host)
        self.active = {sid: mapping[slot] for sid, slot in survivors.items()}
        self.router = router
        self._compile_programs()
        reopened = []
        for _old_slot, sid in affected:
            self.active[sid] = self.router.acquire()
            reopened.append(sid)
        self._reset(*(self.active[sid] for sid in reopened))
        if self.metrics is not None:
            self.metrics.journal.append(
                "shard_loss", lost_shard=lost_shard,
                from_devices=old_devices, to_devices=new_n,
                from_streams=old_max, to_streams=new_max,
                reopened=list(reopened), survivors=sorted(survivors),
            )
        self._update_occupancy_gauges()
        return {
            "lost_shard": lost_shard,
            "n_devices": new_n,
            "max_streams": new_max,
            "reopened": reopened,
            "survivors": sorted(survivors),
        }

    # ---- serving ----

    def _require_open(self, stream_ids) -> None:
        """Reject ticks naming unopened streams before any state changes."""
        unknown = [sid for sid in stream_ids if sid not in self.active]
        if unknown:
            raise ValueError(f"stream(s) {sorted(unknown)} not open")

    def _is_raw(self, dim: int) -> bool:
        """True for raw audio hops, False for FV_Norm frames."""
        if dim == self.pipeline.chunk_samples:
            return True
        if dim == self.pipeline.config.fex.num_channels:
            return False
        raise ValueError(
            "per-stream input must be an FV_Norm frame "
            f"({self.pipeline.config.fex.num_channels},) or a raw audio "
            f"hop ({self.pipeline.chunk_samples},); got trailing dim {dim}"
        )

    def _slab(self, frames: Dict[int, np.ndarray]):
        """{sid: frame} -> (dense slab, mask) on the host."""
        self._require_open(frames)
        dims = {int(np.shape(f)[-1]) for f in frames.values()}
        if len(dims) > 1:
            raise ValueError(
                "all frames in one tick must be the same kind; got "
                f"trailing dims {sorted(dims)}"
            )
        slab = np.zeros((self.max_streams, dims.pop()), np.float32)
        mask = np.zeros((self.max_streams,), bool)
        for sid, frame in frames.items():
            slot = self.active[sid]
            slab[slot] = frame
            mask[slot] = True
        return slab, mask

    def _inputs(self, slab, mask, lead: Tuple[int, ...]):
        """Each shard's (slab, mask) rows on its device. A card gets one
        copy of the rows of its shards; the copy in is ``non_blocking``:
        from pinned host memory (`PipelinedIngress`'s buffers) it runs
        asynchronously, so the caller may rewrite that memory only after
        the tick has completed (the ingress's FIFO guarantees it); from a
        pageable numpy array the copy has consumed the source when it
        returns, so the caller may reuse it at once."""
        _check_shapes(slab, mask, lead + (self.max_streams,))
        inp = torch.as_tensor(slab, dtype=torch.float32)
        m = torch.as_tensor(mask, dtype=torch.bool)
        ax = len(lead)  # the slot axis
        copies = {}
        for dev in dict.fromkeys(self.shard_devices):
            ks = [k for k, d in enumerate(self.shard_devices) if d == dev]
            lo, hi = self._rows(ks[0]).start, self._rows(ks[-1]).stop
            x, y = inp, m
            if (lo, hi) != (0, self.max_streams):
                x, y = x.narrow(ax, lo, hi - lo), y.narrow(ax, lo, hi - lo)
            if dev.type == "cuda":
                x = x.to(dev, non_blocking=True)
                y = y.to(dev, non_blocking=True)
            copies[dev] = (x.contiguous(), y.contiguous(), lo)
        out = []
        for k, dev in enumerate(self.shard_devices):
            x, y, lo = copies[dev]
            r = self._rows(k)
            out.append((x.narrow(ax, r.start - lo, r.stop - r.start),
                        y.narrow(ax, r.start - lo, r.stop - r.start)))
        return out

    def _tick(self, inputs, raw: bool):
        """One tick: one `tick_fused` launch per shard on its rows; returns
        (scores, top) in global slot order on the first shard's device."""
        outs = []
        for k, (inp, mask) in enumerate(inputs):
            st = self._shards[k]
            (gru, carry, scores, det), out_scores, top = tick_fused(
                self.pipeline, raw, self.params,
                (st.gru, st.carry, st.scores, st.det),
                inp, mask, self.frontend_state, self.smoothing,
                operands=self._operands.get(self.shard_devices[k]),
            )
            self._shards[k] = ServerState(gru=tuple(gru), carry=carry,
                                          scores=scores, det=det)
            outs.append((out_scores, top))
        if len(outs) == 1:
            return outs[0]
        return tuple(torch.cat([o[i].to(self.device) for o in outs]) for i in (0, 1))

    def _handle(self, scores: torch.Tensor, top: torch.Tensor) -> TickHandle:
        """A handle over owned host copies of a tick's outputs. On the card
        the copies are ``non_blocking`` into pinned buffers of the handle's
        own, followed by an event on the same stream; on the CPU they are
        made at once."""
        kw = {}
        if self.metrics is not None:
            kw = dict(fetch_hist=self._m_fetch, clock=self.metrics.clock)
        if self.device.type != "cuda":
            return TickHandle(_host(scores), _host(top), **kw)
        host_scores = torch.empty(scores.shape, dtype=scores.dtype, pin_memory=True)
        host_top = torch.empty(top.shape, dtype=top.dtype, pin_memory=True)
        host_scores.copy_(scores, non_blocking=True)
        host_top.copy_(top, non_blocking=True)
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        return TickHandle(host_scores, host_top, event=event, **kw)

    def step_batch(self, slab, mask):
        """Pre-batched tick: the high-throughput ingress path.

        slab: (max_streams, S) raw audio hops or (max_streams, C) FV_Norm
        frames, slot-major (rows of unsubmitted slots are ignored); mask:
        (max_streams,) bool, True where the slot submitted. Returns
        (scores (max_streams, K), top (max_streams,)) as owned host
        arrays; rows of unsubmitted slots hold their previous values.
        This is `step_batch_async` fetched at once.
        """
        m = self.metrics
        if m is None:
            return self.step_batch_async(slab, mask).result()
        t0 = m.clock()
        out = self.step_batch_async(slab, mask).result()
        self._m_tick.observe((m.clock() - t0) * 1e3)
        return out

    def step_batch_async(self, slab, mask) -> TickHandle:
        """Non-blocking tick: dispatch and return a deferred handle.

        The same operands and the same launch as `step_batch`, but the host
        does not wait for the scores: the returned `TickHandle` has them on
        its first `result()`. The slab and mask may be numpy arrays or CPU
        tensors (pinned ones copy asynchronously, see `_inputs`). The
        handle owns its host copies, so it survives any number of later
        ticks and slot resets; the state trajectory equals the `step_batch`
        sequence bit for bit.
        """
        raw = self._is_raw(int(np.shape(slab)[-1]))
        m = self.metrics
        t0 = None if m is None else m.clock()
        inputs = self._inputs(slab, mask, ())
        self._note_dispatch("tick_audio" if raw else "tick_fv", np.shape(slab))
        handle = self._handle(*self._tick(inputs, raw))
        if m is not None:
            self._m_ticks.inc()
            self._m_dispatch.observe((m.clock() - t0) * 1e3)
        return handle

    def step(self, frames: Dict[int, np.ndarray]) -> Dict[int, dict]:
        """frames: stream_id -> FV_Norm (C,) or raw audio hop (S,).

        One 16 ms tick. An empty dict is a no-op: no launch, no state
        change."""
        if not frames:
            return {}
        slab, mask = self._slab(frames)
        scores, top = self.step_batch(slab, mask)
        return {
            sid: {"probs": scores[self.active[sid]],
                  "top": int(top[self.active[sid]])}
            for sid in frames
        }

    def run_batch(self, slab, mask):
        """Offline replay of pre-batched tick slabs.

        slab: (n_ticks, max_streams, S|C); mask: (n_ticks, max_streams).
        The ticks run back to back on the device (the same tick as
        `step_batch`, so the trajectory is bit-identical to that many
        `step_batch` calls) and the results come to the host once.
        Returns (scores_seq (n_ticks, N, K), tops (n_ticks, N)); this is
        `run_batch_async` fetched at once.
        """
        return self.run_batch_async(slab, mask).result()

    def run_batch_async(self, slab, mask) -> TickHandle:
        """Non-blocking window dispatch: `run_batch` returning a handle
        whose `result()` is (scores_seq (n_ticks, N, K), tops (n_ticks,
        N)), with the copy discipline of `step_batch_async`."""
        raw = self._is_raw(int(np.shape(slab)[-1]))
        m = self.metrics
        t0 = None if m is None else m.clock()
        n_ticks = int(np.shape(slab)[0])
        inputs = self._inputs(slab, mask, (n_ticks,))
        self._note_dispatch("run_audio" if raw else "run_fv", np.shape(slab))
        k = self.pipeline.config.gru.num_classes
        scores_seq = torch.empty(
            (n_ticks, self.max_streams, k), dtype=torch.float32,
            device=self.device,
        )
        tops = torch.empty(
            (n_ticks, self.max_streams), dtype=torch.int64, device=self.device
        )
        for t in range(n_ticks):
            scores_seq[t], tops[t] = self._tick(
                [(inp[t], msk[t]) for inp, msk in inputs], raw
            )
        handle = self._handle(scores_seq, tops)
        if m is not None:
            self._m_ticks.inc(n_ticks)
            self._m_dispatch.observe((m.clock() - t0) * 1e3)
        return handle

    def run(self, buffers: Dict[int, np.ndarray]) -> Dict[int, dict]:
        """Offline replay: buffered audio -> per-tick posteriors.

        buffers: stream_id -> raw audio (n_samples,) for open streams;
        each is split into consecutive `pipeline.chunk_samples` hops
        (trailing remainder dropped). A stream is masked out of every
        tick past its own end. Returns, per stream, ``{"probs": (n_ticks,
        K) smoothed posteriors, "top": final argmax}``.
        """
        if not buffers:
            return {}
        self._require_open(buffers)
        hop = self.pipeline.chunk_samples
        ticks = {sid: len(np.asarray(b)) // hop for sid, b in buffers.items()}
        n_ticks = max(ticks.values())
        if n_ticks == 0:
            return {}
        slab = np.zeros((n_ticks, self.max_streams, hop), np.float32)
        mask = np.zeros((n_ticks, self.max_streams), bool)
        for sid, buf in buffers.items():
            slot, t = self.active[sid], ticks[sid]
            slab[:t, slot] = np.asarray(buf, np.float32)[: t * hop].reshape(t, hop)
            mask[:t, slot] = True
        scores_seq, tops = self.run_batch(slab, mask)
        out = {}
        for sid in buffers:
            slot, t = self.active[sid], ticks[sid]
            out[sid] = {
                "probs": scores_seq[:t, slot],
                "top": int(tops[t - 1, slot]) if t else None,
            }
        return out
