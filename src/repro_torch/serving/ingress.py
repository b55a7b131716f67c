"""Async double-buffered ingress for the streaming KWS server.

Counterpart of `repro.serving.ingress`. `StreamingKWSServer.step_batch`
is one launch of the tick kernel with a slab copy in front and a score
copy behind; waiting for the scores before the next tick is even staged
leaves the card idle while the host stages and the host idle while the
card computes. This module overlaps the two without touching the tick:

  * `TickHandle` — the deferred result of one dispatched tick. On the
    card it holds pinned host buffers that a ``non_blocking`` copy fills
    behind the tick, and a CUDA event recorded after that copy:
    `ready()` polls the event, `result()` waits for it. The buffers are
    the handle's own, so it stays valid however many later ticks rewrite
    the server's state in place. On the CPU the results are host copies
    already and the handle is ready at once.
  * `PipelinedIngress` — preallocated ping-pong host staging. `stage()`
    hands out a (slab, mask) pair to assemble the next tick into while
    the previous tick is still in flight; `commit()` dispatches it via
    `StreamingKWSServer.step_batch_async`. On the card the slabs and
    masks are pinned host tensors (handed to the caller as numpy views),
    so their host-to-device copy is asynchronous too; a buffer is
    rewritten only after the tick that read it has completed (the
    `depth`-deep FIFO: `result()` waits on an event recorded after that
    tick's copies). `window=K` coalesces K committed ticks into one
    `run_batch_async` dispatch.
  * `TickCoalescer` — micro-batched arrival merging: per-stream frames
    arriving within one 16 ms window coalesce into a single staged tick,
    flushed when every open stream has submitted, when the window
    deadline passes (`poll`), or when a stream submits a second frame.

The pipelined path gives the same results as the synchronous
`step_batch` sequence, bit for bit: it launches the same kernel on the
same operands in the same order on the server's one CUDA stream; only
the host's fetch moves later (tests/test_torch_serve_async.py).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "TickHandle",
    "PipelinedIngress",
    "TickCoalescer",
    "CoalescedTick",
]


class TickHandle:
    """Deferred result of one asynchronously dispatched serving tick.

    ``scores`` and ``top`` are host arrays or CPU tensors owned by the
    handle; with ``event`` (a `torch.cuda.Event` recorded after the
    device-to-host copies that fill them, on the card) they are complete
    only once the event has. `result()` waits for the event, returns
    owned numpy copies and caches them.

    `meta` is caller-owned freight (a submit timestamp, the {stream_id:
    slot} map of a coalesced tick); `done_at` records the host clock at
    the earliest moment the tick was observed complete: the first
    ``ready() == True`` poll, or the end of the first `result()` when
    nobody polled. `fetch_hist`, when given, is a
    `repro_torch.serving.metrics.Histogram` that receives the
    milliseconds the first `result()` spent blocked (the server wires its
    ``kws_serve_tick_fetch_ms`` here when metrics are on).
    """

    __slots__ = ("_scores", "_top", "_event", "_host", "meta", "done_at",
                 "_fetch_hist", "_clock")

    def __init__(self, scores, top, meta: Any = None, fetch_hist=None,
                 clock: Callable[[], float] = time.perf_counter,
                 event=None):
        self._scores = scores
        self._top = top
        self._event = event
        self._host: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.meta = meta
        self.done_at: Optional[float] = None
        self._fetch_hist = fetch_hist
        self._clock = clock

    def ready(self) -> bool:
        """True when the tick and its copies have finished (non-blocking).
        The first True poll stamps `done_at`."""
        if self._host is not None:
            return True
        ok = self._event is None or self._event.query()
        if ok and self.done_at is None:
            self.done_at = self._clock()
        return ok

    def result(self) -> Tuple[np.ndarray, np.ndarray]:
        """(scores (N, K), top (N,)) as owned host arrays; blocks until
        the tick has executed. Idempotent: later calls return the cached
        arrays, so fetching a handle after further ticks (or slot resets)
        ran is always safe."""
        if self._host is None:
            t0 = self._clock()
            if self._event is not None:
                self._event.synchronize()
            self._host = tuple(
                np.array(x.numpy() if torch.is_tensor(x) else x)
                for x in (self._scores, self._top)
            )
            self._scores = self._top = self._event = None
            t1 = self._clock()
            if self.done_at is None:
                self.done_at = t1
            if self._fetch_hist is not None:
                self._fetch_hist.observe((t1 - t0) * 1e3)
        return self._host

    @property
    def scores(self) -> np.ndarray:
        return self.result()[0]

    @property
    def top(self) -> np.ndarray:
        return self.result()[1]


class PipelinedIngress:
    """Double-buffered slab staging over the server's async dispatch.

    `depth` preallocated (slab, mask) host buffer pairs cycle round-robin
    (reallocated by the first `stage()` after a `resize`, which needs the
    pipeline drained);
    at most `depth` dispatches are in flight. `stage()` returns the next
    pair (numpy views; on the card views of pinned host tensors) for the
    caller to assemble a tick into, forcing the dispatch that consumed
    this buffer `depth` cycles ago to completion first: that bounds the
    pipeline and guarantees the buffer is no longer being read by the
    card. `commit()` dispatches without blocking. Completed handles
    accumulate in FIFO order; collect them with `retired()` or force
    everything with `drain()`.

    depth=1 is the synchronous cadence; depth=2 is classic double
    buffering (host staging of tick N+1 overlaps the card's tick N).

    With window=1 (default) every `commit()` dispatches one tick via
    `step_batch_async` and `handle.meta` is that tick's meta. With
    window=K, K consecutively committed ticks coalesce into ONE dispatch
    (`run_batch_async`, the same K ticks back to back): the window's
    handle materializes (K, N, C) scores / (K, N) tops, `handle.meta` is
    the list of the K metas in commit order, and a tick's scores arrive
    only when its window flushes. `commit()` returns the handle on the
    window-filling commit and None otherwise; `flush()` dispatches a
    partial window (only the ticks staged so far).
    """

    def __init__(self, server, dim: int, depth: int = 2,
                 window: int = 1):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        server._is_raw(int(dim))  # canonical kind validation, up front
        self.server = server
        self.dim = int(dim)
        self.depth = depth
        self.window = window
        self._allocate(server.max_streams)
        # (buffer index, handle, traces) in dispatch order; len <= depth
        self._fifo: collections.deque = collections.deque()
        self._retired: List[TickHandle] = []
        self._cursor = 0
        self._fill = 0  # ticks staged+committed into the cursor buffer
        self._metas: List[Any] = []
        self._staged = False
        # observability rides the server's registry: one TickTrace per
        # staged tick (stage -> commit -> dispatch -> retire marks; a
        # window of K ticks shares the dispatch / retire timestamps of
        # its one dispatch), plus in-flight / pending-window gauges. All
        # host clock reads around the existing calls.
        self.metrics = getattr(server, "metrics", None)
        self._seq = 0
        self._cur_trace = None
        self._traces: List[Any] = []  # committed, awaiting dispatch
        if self.metrics is not None:
            self._m_in_flight = self.metrics.gauge(
                "kws_ingress_in_flight",
                "device dispatches in flight (<= depth)",
            )
            self._m_pending = self.metrics.gauge(
                "kws_ingress_pending_ticks",
                "ticks committed into the current window, undispatched",
            )
            self._m_dispatches = self.metrics.counter(
                "kws_ingress_dispatches_total",
                "device dispatches issued by the pipelined ingress",
            )

    def _allocate(self, n: int) -> None:
        """The `depth` (slab, mask) buffer pairs for ``n`` slots: pinned on
        the card, so the slab's copy to the card is asynchronous; the FIFO
        keeps a buffer from being rewritten before the tick that read it
        has completed."""
        pin = self.server.device.type == "cuda"
        self._slab_t = [
            torch.zeros((self.window, n, self.dim), dtype=torch.float32,
                        pin_memory=pin)
            for _ in range(self.depth)
        ]
        self._mask_t = [
            torch.zeros((self.window, n), dtype=torch.bool, pin_memory=pin)
            for _ in range(self.depth)
        ]
        self._slabs = [t.numpy() for t in self._slab_t]
        self._masks = [t.numpy() for t in self._mask_t]

    @property
    def in_flight(self) -> int:
        return len(self._fifo)

    @property
    def pending_ticks(self) -> int:
        """Ticks committed into the current window but not dispatched."""
        return self._fill

    def stage(self) -> Tuple[np.ndarray, np.ndarray]:
        """Next (slab, mask) staging pair, mask cleared. Blocks only when
        the pipeline is full (forces the oldest in-flight dispatch)."""
        if self._staged:
            raise RuntimeError("stage() called again before commit()")
        n = self.server.max_streams
        if n != self._slabs[0].shape[1]:
            # the server was resized (autoscaler, shard-loss recovery):
            # the buffers are the old capacity. Reallocating is safe only
            # with the pipeline empty (in-flight dispatches and a
            # half-filled window still hold old-capacity slabs), so
            # callers drain() around a resize and the next stage() picks
            # the new capacity up here.
            if self._fifo or self._fill:
                raise RuntimeError(
                    "server capacity changed mid-pipeline: drain() the "
                    "ingress before staging into the resized server"
                )
            self._allocate(n)
        i = self._cursor
        if self._fill == 0:
            # about to write row 0 of buffer i: the dispatch that
            # consumed it (if any) is the FIFO front — buffers cycle
            # round-robin and retire in dispatch order
            while self._fifo and self._fifo[0][0] == i:
                self._retire(*self._fifo.popleft()[1:])
        self._staged = True
        if self.metrics is not None:
            tr = self.metrics.trace(("tick", self._seq))
            self._seq += 1
            tr.mark("stage")
            self._cur_trace = tr
        mask = self._masks[i][self._fill]
        mask[:] = False
        return self._slabs[i][self._fill], mask

    def commit(self, meta: Any = None) -> Optional[TickHandle]:
        """Commit the staged tick; dispatches (non-blocking) when the
        window is full. Returns the window's handle on the dispatching
        commit, None while the window is still filling."""
        if not self._staged:
            raise RuntimeError("commit() without a prior stage()")
        self._staged = False
        self._metas.append(meta)
        if self._cur_trace is not None:
            self._cur_trace.mark("commit")
            self._traces.append(self._cur_trace)
            self._cur_trace = None
            self._m_pending.set(self._fill + 1)
        self._fill += 1
        if self._fill == self.window:
            return self._dispatch()
        return None

    def flush(self) -> Optional[TickHandle]:
        """Dispatch the partially filled window now (no-op when empty).
        A partial window runs only the ticks actually staged."""
        if self._staged:
            raise RuntimeError("flush() with a stage() pending commit()")
        if self._fill == 0:
            return None
        return self._dispatch()

    def _dispatch(self) -> TickHandle:
        i, k = self._cursor, self._fill
        if self.window == 1:
            handle = self.server.step_batch_async(
                self._slab_t[i][0], self._mask_t[i][0]
            )
            handle.meta = self._metas[0]
        else:
            handle = self.server.run_batch_async(
                self._slab_t[i][:k], self._mask_t[i][:k]
            )
            handle.meta = list(self._metas)
        traces, self._traces = self._traces, []
        if traces:
            # one dispatch serves the whole window: its ticks share the
            # dispatch timestamp (and, at retire, done_at)
            t = self.metrics.clock()
            for tr in traces:
                tr.mark("dispatch", t)
        if self.metrics is not None:
            self._m_dispatches.inc()
            self._m_in_flight.set(len(self._fifo) + 1)
            self._m_pending.set(0)
        self._fifo.append((i, handle, traces))
        self._cursor = (i + 1) % self.depth
        self._fill = 0
        self._metas = []
        return handle

    def _retire(self, h: TickHandle, traces) -> None:
        """Force one in-flight dispatch to completion and collect it."""
        h.result()
        if traces:
            for tr in traces:
                tr.mark("retire", h.done_at)
        if self.metrics is not None:
            self._m_in_flight.set(len(self._fifo))
        self._retired.append(h)

    def retired(self) -> List[TickHandle]:
        """Handles forced to completion so far, in dispatch order (clears
        the internal list)."""
        out, self._retired = self._retired, []
        return out

    def drain(self) -> List[TickHandle]:
        """Flush the pending window, force every in-flight dispatch, and
        return ALL completed handles (previously retired + just drained),
        in dispatch order."""
        self.flush()
        while self._fifo:
            self._retire(*self._fifo.popleft()[1:])
        return self.retired()


@dataclasses.dataclass
class CoalescedTick:
    """Meta freight of one coalesced tick's handle: which streams
    submitted (and the slot each occupied AT DISPATCH TIME — the
    mapping to index the handle's score rows with, immune to later
    close/reopen), plus the window's host timestamps."""

    sids: Dict[int, int]
    staged_at: float
    flushed_at: Optional[float] = None


class TickCoalescer:
    """Merge sub-window per-stream arrivals into single dispatched ticks.

    Live traffic rarely arrives slab-shaped: each stream's 16 ms hop
    lands on its own schedule. Dispatching a full-slab tick per arrival
    wastes the batch; waiting for stragglers forever stalls it. The
    coalescer stages arrivals into one pending tick and flushes it when

      * every open stream has submitted (the tick is full),
      * the window deadline (`window_ms` after the first arrival)
        passes — checked by `poll()`, or
      * a stream submits a SECOND frame (which belongs to the next
        tick: the pending one flushes first, then the new frame opens
        the next window).

    Flushing dispatches through a per-kind `PipelinedIngress`, so
    coalescing composes with double buffering: the flushed tick's
    handle materializes while the next window fills. Completed handles
    (meta = `CoalescedTick`) are collected via `retired()` / `drain()`.

    `clock` is injectable for deterministic tests; `now` may also be
    passed explicitly to `add`/`poll`/`flush`.
    """

    def __init__(self, server, window_ms: float = 16.0, depth: int = 2,
                 clock: Callable[[], float] = time.monotonic):
        if window_ms <= 0:
            raise ValueError(f"window_ms must be > 0, got {window_ms}")
        self.server = server
        self.window_s = window_ms * 1e-3
        self.depth = depth
        self.clock = clock
        self._ingress: Dict[int, PipelinedIngress] = {}
        self._pending = None  # (ingress, slab, mask, CoalescedTick, deadline)
        self._retired: List[TickHandle] = []
        # per-reason flush counters on the server's registry: "full"
        # (every open stream submitted), "deadline" (window_ms passed),
        # "second_frame" (a stream's next-tick frame forced the flush),
        # "manual" (caller flush()/drain())
        self.metrics = getattr(server, "metrics", None)

    @property
    def pending_streams(self) -> int:
        """Streams staged in the currently open window (0 = no window)."""
        return 0 if self._pending is None else len(self._pending[3].sids)

    def add(self, stream_id: int, frame, now: Optional[float] = None
            ) -> List[TickHandle]:
        """Stage one stream's frame; returns any handles this call
        retired (a second-frame or tick-full flush may complete older
        ticks)."""
        now = self.clock() if now is None else now
        if stream_id not in self.server.active:
            raise ValueError(f"stream {stream_id} not open")
        frame = np.asarray(frame, np.float32)
        dim = int(frame.shape[-1])
        self.server._is_raw(dim)  # canonical kind/width validation
        if self._pending is not None and self._pending[0].dim != dim:
            raise ValueError(
                "all frames in one tick must be the same kind; pending "
                f"window holds dim {self._pending[0].dim}, got {dim} "
                "(flush() the window before switching kinds)"
            )
        if self._pending is not None and stream_id in self._pending[3].sids:
            # a stream's second frame belongs to the NEXT tick
            self._flush("second_frame", now)
        if self._pending is None:
            ing = self._ingress.get(dim)
            if ing is None:
                ing = PipelinedIngress(self.server, dim, depth=self.depth)
                self._ingress[dim] = ing
            slab, mask = ing.stage()
            meta = CoalescedTick(sids={}, staged_at=now)
            self._pending = (ing, slab, mask, meta, now + self.window_s)
        ing, slab, mask, meta, _deadline = self._pending
        slot = self.server.active[stream_id]
        slab[slot] = frame
        mask[slot] = True
        meta.sids[stream_id] = slot
        if len(meta.sids) >= len(self.server.active):
            self._flush("full", now)
        return self.retired()

    def poll(self, now: Optional[float] = None) -> List[TickHandle]:
        """Flush the pending window iff its deadline has passed; returns
        handles retired so far either way."""
        now = self.clock() if now is None else now
        if self._pending is not None and now >= self._pending[4]:
            self._flush("deadline", now)
        return self.retired()

    def flush(self, now: Optional[float] = None) -> Optional[TickHandle]:
        """Dispatch the pending window as one tick (no-op when empty)."""
        return self._flush("manual", now)

    def _flush(self, reason: str, now: Optional[float] = None
               ) -> Optional[TickHandle]:
        if self._pending is None:
            return None
        now = self.clock() if now is None else now
        ing, _slab, _mask, meta, _deadline = self._pending
        self._pending = None
        meta.flushed_at = now
        handle = ing.commit(meta=meta)
        if self.metrics is not None:
            self.metrics.counter(
                "kws_coalescer_flushes_total",
                "coalesced-tick flushes by trigger",
                reason=reason,
            ).inc()
        self._retired.extend(ing.retired())
        return handle

    def retired(self) -> List[TickHandle]:
        """Completed handles collected so far (clears the list)."""
        for ing in self._ingress.values():
            self._retired.extend(ing.retired())
        out, self._retired = self._retired, []
        return out

    def drain(self) -> List[TickHandle]:
        """Flush the pending window and force every in-flight tick."""
        self.flush()
        for ing in self._ingress.values():
            self._retired.extend(ing.drain())
        return self.retired()
