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
delta-int) on one device; the ΔGRU backends' per-stream sparsity is
`StreamingKWSServer.sparsity`. A pipeline with a cascade
(`KWSPipelineConfig.cascade`) gates the classifier per stream behind the
stage-1 wake detector inside the same launch; its duty cycle is
`StreamingKWSServer.wake_rate`. `step_batch_async` / `run_batch_async`
return a `repro_torch.serving.ingress.TickHandle` without waiting for the
card (the pipelined ingress of `repro_torch.serving.ingress` builds on
them), and ``metrics=`` instruments the server into a
`repro_torch.serving.metrics.MetricsRegistry`. `resize`, shard-loss
recovery and sharding arrive with the fleet slice (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.frontend import tree_leaves
from repro_torch.core.gru_delta import effective_mac_fraction
from repro_torch.kernels.build import resolve_device
from repro_torch.kernels.tick_fused import pack_operands, tick_fused
from repro_torch.serving import cascade as cascade_lib
from repro_torch.serving.autoscale import StreamRouter
from repro_torch.serving.ingress import TickHandle
from repro_torch.serving.metrics import MetricsRegistry

__all__ = ["ServerState", "StreamingKWSServer"]

_TICK_IMPLS = ("auto",)


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
    backend's fresh state.
    """

    gru: Tuple[torch.Tensor, ...]
    carry: Dict[str, torch.Tensor]
    scores: torch.Tensor
    det: Optional[Dict[str, torch.Tensor]] = None

    def leaves(self):
        """Every state tensor (the detector's too, when there is one)."""
        return tree_leaves((self.gru, self.carry, self.scores, self.det))


def _reset_slot(state: ServerState, slot: int) -> None:
    """Zero one slot's slice of every state tensor, in place; the zero is
    written in each leaf's own dtype (the cascade's awake latch is bool)."""
    for t in state.leaves():
        t[slot] = 0


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
    ``tick_impl`` accepts only ``"auto"``: on the card the tick is the
    CUDA kernel and nothing else (`tick_dispatch` reads ``"cuda"``, or
    ``"cpu"`` for the plain tick). ``params`` are the float parameters (or
    `QuantizedClassifier` codes for ``classifier="integer"`` /
    ``"delta-int"``) on ``device``; the server backend-shapes them once.

    Two cadences drive the same launches: `step_batch` (dispatch, then
    wait for the scores) and `step_batch_async` (dispatch and return a
    `TickHandle` whose scores arrive later, so tick N's results are
    fetched while tick N+1 runs). On the card everything of a tick (the
    slab's copy in, the kernel, the scores' copy out) goes on the
    device's current CUDA stream, so tick N's copy-out is ordered before
    tick N+1 rewrites the scores in place. `run_batch` / `run_batch_async`
    run a (T, N, ·) slab as T back-to-back ticks and copy to the host
    once. Results are owned host copies.

    Observability: ``metrics=`` takes a
    `repro_torch.serving.metrics.MetricsRegistry` (or ``True`` for a
    fresh one, exposed as `srv.metrics`) and records tick dispatch /
    fetch / step latency histograms keyed on the 16 ms budget, tick /
    retrace / compile counters, occupancy gauges, and a journal event for
    the server's build and every retrace. These are host clock reads and
    dict updates around the existing calls, so a metrics-enabled server
    gives bit-identical results. `metrics_snapshot()` rolls the registry
    and the server's own telemetry into one JSON-able dict.
    """

    def __init__(self, pipeline, params, max_streams: int = 256,
                 smoothing: float = 0.7, state=None, tick_impl: str = "auto",
                 device=None, metrics=None):
        if tick_impl not in _TICK_IMPLS:
            raise ValueError(
                f"tick_impl must be one of {_TICK_IMPLS}; got {tick_impl!r}"
            )
        self.device = resolve_device(device)
        self.tick_impl = tick_impl
        # what a tick runs: the CUDA kernel, or the plain tick on the CPU
        self.tick_dispatch = "cuda" if self.device.type == "cuda" else "cpu"
        self.n_devices = 1
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
        self._operands = None
        if self.device.type == "cuda":
            self._operands = pack_operands(
                pipeline, self.params, self.frontend_state, self.device
            )
        det = None
        if pipeline.config.cascade is not None:
            det = cascade_lib.init_state(max_streams, self.device)
        self.state = ServerState(
            gru=tuple(pipeline.streaming_init(max_streams, self.device)),
            carry=pipeline.streaming_features_init(max_streams, self.device),
            scores=torch.zeros(
                (max_streams, pipeline.config.gru.num_classes),
                dtype=torch.float32, device=self.device,
            ),
            det=det,
        )
        self.active: Dict[int, int] = {}  # stream_id -> slot
        self.router = StreamRouter(max_streams)
        # retrace / compile accounting is kept with metrics off too
        self._retraces = 0
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
        # the server's one program build: the kernel operands packed above
        # (the reference's `_compile_programs`)
        self._compiles = 1
        if metrics is not None:
            self._m_compiles.inc()
            metrics.journal.append(
                "compile_programs", n_devices=self.n_devices,
                max_streams=self.max_streams, tick_impl=self.tick_impl,
            )

    # ---- observability ----

    @property
    def retrace_count(self) -> int:
        """Dispatches so far of a (program, shape) pair not seen before:
        ``tick_audio`` / ``tick_fv`` for a live tick, ``run_audio`` /
        ``run_fv`` for a replay, keyed by the slab's shape. The reference
        counts the ticks that trace and compile a new XLA program; the
        port compiles nothing per shape (the CUDA kernel is built once per
        process), so here a retrace is the first launch at that shape.
        Tracked with metrics off too."""
        return self._retraces

    @property
    def compile_count(self) -> int:
        """Program builds so far: 1 after construction (the kernel
        operands packed for this server; no later rebuild exists yet)."""
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

    @property
    def scores(self) -> np.ndarray:
        """Smoothed per-slot posteriors as an owned host array."""
        return _host(self.state.scores)

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
        _reset_slot(self.state, slot)
        self._update_occupancy_gauges()

    def close_stream(self, stream_id: int):
        if stream_id not in self.active:
            raise ValueError(f"stream {stream_id} not open")
        self.router.release(self.active.pop(stream_id))
        self._update_occupancy_gauges()

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
        """The slab and mask on the device. The copy in is ``non_blocking``:
        from pinned host memory (`PipelinedIngress`'s buffers) it runs
        asynchronously, so the caller may rewrite that memory only after
        the tick has completed (the ingress's FIFO guarantees it); from a
        pageable numpy array the copy has consumed the source when it
        returns, so the caller may reuse it at once."""
        _check_shapes(slab, mask, lead + (self.max_streams,))
        inp = torch.as_tensor(slab, dtype=torch.float32)
        m = torch.as_tensor(mask, dtype=torch.bool)
        if self.device.type == "cuda":
            inp = inp.to(self.device, non_blocking=True)
            m = m.to(self.device, non_blocking=True)
        return inp.contiguous(), m.contiguous()

    def _tick(self, inp, mask, raw: bool):
        st = self.state
        (gru, carry, scores, det), out_scores, top = tick_fused(
            self.pipeline, raw, self.params,
            (st.gru, st.carry, st.scores, st.det),
            inp, mask, self.frontend_state, self.smoothing,
            operands=self._operands,
        )
        self.state = ServerState(gru=tuple(gru), carry=carry, scores=scores,
                                 det=det)
        return out_scores, top

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
        inp, msk = self._inputs(slab, mask, ())
        self._note_dispatch("tick_audio" if raw else "tick_fv", np.shape(slab))
        handle = self._handle(*self._tick(inp, msk, raw))
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
        inp, msk = self._inputs(slab, mask, (n_ticks,))
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
            scores_seq[t], tops[t] = self._tick(inp[t], msk[t], raw)
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
