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
`StreamingKWSServer.sparsity`. The cascade, async ingress, metrics,
`resize` and sharding arrive with later slices (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.frontend import tree_leaves
from repro_torch.core.gru_delta import effective_mac_fraction
from repro_torch.kernels.build import resolve_device
from repro_torch.kernels.tick_fused import pack_operands, tick_fused
from repro_torch.serving.autoscale import StreamRouter

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

    On the card each tick updates these tensors in place (the
    counterpart of the reference's buffer donation); all-zeros is every
    backend's fresh state.
    """

    gru: Tuple[torch.Tensor, ...]
    carry: Dict[str, torch.Tensor]
    scores: torch.Tensor


def _reset_slot(state: ServerState, slot: int) -> None:
    """Zero one slot's slice of every state tensor, in place."""
    for t in tree_leaves((state.gru, state.carry, state.scores)):
        t[slot] = 0


def _host(t: torch.Tensor) -> np.ndarray:
    """An owned host copy (never a view of a buffer the next tick writes)."""
    return t.detach().to("cpu", copy=True).numpy()


class StreamingKWSServer:
    """Batched frame-synchronous KWS over N concurrent audio streams.

    Each tick: callers push, per active stream, either one FV_Norm (C,)
    or one raw 16 ms audio hop; the kinds may not be mixed within one
    tick. Streams that did not submit are masked out of every state
    update.

    ``device`` defaults to the card (``"cuda"``); with no CUDA device the
    constructor raises, and ``device="cpu"`` runs the plain PyTorch tick.
    ``tick_impl`` accepts only ``"auto"``: on the card the tick is the
    CUDA kernel and nothing else. ``params`` are the float parameters (or
    `QuantizedClassifier` codes for ``classifier="integer"`` /
    ``"delta-int"``) on ``device``; the server backend-shapes them once.

    `step_batch` and `run_batch` return owned host copies. `run_batch`
    runs its ticks as a loop on the device and copies to the host once.
    """

    def __init__(self, pipeline, params, max_streams: int = 256,
                 smoothing: float = 0.7, state=None, tick_impl: str = "auto",
                 device=None):
        if tick_impl not in _TICK_IMPLS:
            raise ValueError(
                f"tick_impl must be one of {_TICK_IMPLS}; got {tick_impl!r}"
            )
        self.device = resolve_device(device)
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
        self.state = ServerState(
            gru=tuple(pipeline.streaming_init(max_streams, self.device)),
            carry=pipeline.streaming_features_init(max_streams, self.device),
            scores=torch.zeros(
                (max_streams, pipeline.config.gru.num_classes),
                dtype=torch.float32, device=self.device,
            ),
        )
        self.active: Dict[int, int] = {}  # stream_id -> slot
        self.router = StreamRouter(max_streams)

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

    # ---- slot lifecycle ----

    def open_stream(self, stream_id: int):
        if stream_id in self.active:
            raise ValueError(f"stream {stream_id} already open")
        slot = self.router.acquire()  # raises RuntimeError at capacity
        self.active[stream_id] = slot
        _reset_slot(self.state, slot)

    def close_stream(self, stream_id: int):
        if stream_id not in self.active:
            raise ValueError(f"stream {stream_id} not open")
        self.router.release(self.active.pop(stream_id))

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
        inp = torch.as_tensor(slab, dtype=torch.float32).to(self.device)
        m = torch.as_tensor(mask, dtype=torch.bool).to(self.device)
        want = lead + (self.max_streams,)
        if tuple(inp.shape[:-1]) != want or tuple(m.shape) != want:
            raise ValueError(
                f"slab must be {want} + (dim,) and mask {want}; got "
                f"{tuple(inp.shape)} and {tuple(m.shape)}"
            )
        return inp.contiguous(), m.contiguous()

    def _tick(self, inp, mask, raw: bool):
        st = self.state
        (gru, carry, scores), out_scores, top = tick_fused(
            self.pipeline, raw, self.params, (st.gru, st.carry, st.scores),
            inp, mask, self.frontend_state, self.smoothing,
            operands=self._operands,
        )
        self.state = ServerState(gru=tuple(gru), carry=carry, scores=scores)
        return out_scores, top

    def step_batch(self, slab, mask):
        """Pre-batched tick: the high-throughput ingress path.

        slab: (max_streams, S) raw audio hops or (max_streams, C) FV_Norm
        frames, slot-major (rows of unsubmitted slots are ignored); mask:
        (max_streams,) bool, True where the slot submitted. Returns
        (scores (max_streams, K), top (max_streams,)) as owned host
        arrays; rows of unsubmitted slots hold their previous values.
        """
        raw = self._is_raw(int(np.shape(slab)[-1]))
        inp, m = self._inputs(slab, mask, ())
        scores, top = self._tick(inp, m, raw)
        return _host(scores), _host(top)

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
        Returns (scores_seq (n_ticks, N, K), tops (n_ticks, N)).
        """
        raw = self._is_raw(int(np.shape(slab)[-1]))
        n_ticks = int(np.shape(slab)[0])
        inp, m = self._inputs(slab, mask, (n_ticks,))
        k = self.pipeline.config.gru.num_classes
        scores_seq = torch.empty(
            (n_ticks, self.max_streams, k), dtype=torch.float32,
            device=self.device,
        )
        tops = torch.empty(
            (n_ticks, self.max_streams), dtype=torch.int64, device=self.device
        )
        for t in range(n_ticks):
            scores_seq[t], tops[t] = self._tick(inp[t], m[t], raw)
        return _host(scores_seq), _host(tops)

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
