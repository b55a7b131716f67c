"""Serving observability: metrics registry, trace spans, event journal.

The port's own copy of `repro.serving.metrics` (pure Python; the port
imports nothing of the JAX package), with the same metric kinds, bucket
edges, journal and exposition text:

  * `MetricsRegistry` — get-or-create families of monotonic `Counter`s,
    `Gauge`s and fixed-bucket `Histogram`s (default bucket edges keyed
    on the paper's 16 ms tick budget, `DEFAULT_MS_BUCKETS`), each
    optionally labeled. `snapshot()` returns one JSON-able dict;
    `render_prometheus()` emits the Prometheus text exposition format.
  * `EventJournal` — an append-only structured event log (`append(kind,
    **fields)` stamps a monotonically increasing ``seq`` and the
    registry clock). Bounded drop-oldest capacity; ``seq`` keeps
    counting after old events are trimmed, so consumers can detect the
    gap. `StreamingKWSServer` journals its program build and its
    shape-keyed first launches ("retraces") here.
  * `TickTrace` — per-tick span timestamps: named marks ("stage",
    "commit", "dispatch", "retire") recorded by the async ingress as a
    tick moves through the pipeline. Completed traces live in a bounded
    ring (`registry.traces`); `span_percentiles` rolls consecutive-mark
    durations into p50/p99 summaries.

Everything is host-side Python: no device code, no forced syncs, no
change to any tick's operands or launch order, which is what makes a
metrics-enabled `StreamingKWSServer` bit-identical to a metrics-off one
(tests/test_torch_metrics.py). The registry is single-process and not
thread-safe, matching the single-threaded serving loop it instruments.
"""

from __future__ import annotations

import bisect
import collections
import time
from typing import Any, Callable, Dict, Iterable, List, Optional, Tuple

__all__ = [
    "TICK_BUDGET_MS",
    "DEFAULT_MS_BUCKETS",
    "Counter",
    "Gauge",
    "Histogram",
    "EventJournal",
    "TickTrace",
    "MetricsRegistry",
    "span_percentiles",
]

# the paper's frame shift: one serving tick every 16 ms — the latency
# budget every histogram is read against
TICK_BUDGET_MS = 16.0

# default histogram bucket upper edges (milliseconds), keyed on the
# tick budget: sub-budget edges resolve where inside the 16 ms window a
# tick lands, the 16.0 edge IS the budget (SLO breaches are everything
# above it), and the coarse tail catches compile spikes
DEFAULT_MS_BUCKETS = (
    0.25, 0.5, 1.0, 2.0, 4.0, 8.0, 12.0, 16.0,
    24.0, 32.0, 64.0, 128.0, 256.0, 1024.0,
)


class Counter:
    """Monotonic counter. `inc` rejects negative increments — a counter
    that can go down is a gauge wearing the wrong name."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter increment must be >= 0, got {n}")
        self.value += n


class Gauge:
    """Point-in-time value (occupancy, queue depth, capacity)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram with exact-percentile sample retention.

    ``buckets`` are ascending upper edges with Prometheus ``le``
    semantics: an observation lands in the first bucket whose edge is
    >= the value (an observation exactly ON an edge belongs to that
    edge's bucket), and everything above the last edge lands in the
    implicit +Inf bucket. `counts` holds per-bucket (NOT cumulative)
    counts, len(buckets) + 1 long.

    Besides the buckets, the last ``keep_samples`` raw observations are
    retained (drop-oldest ring) so `percentiles()` is exact over the
    retained window — the serving benchmarks read their p50/p99 from
    here instead of keeping private latency lists.
    """

    __slots__ = ("buckets", "counts", "sum", "count", "samples")

    def __init__(self, buckets: Iterable[float] = DEFAULT_MS_BUCKETS,
                 keep_samples: int = 8192):
        edges = tuple(float(b) for b in buckets)
        if not edges or any(
            b >= a for a, b in zip(edges[1:], edges[:-1])
        ):
            raise ValueError(
                f"buckets must be non-empty and strictly ascending; "
                f"got {edges}"
            )
        self.buckets = edges
        self.counts = [0] * (len(edges) + 1)
        self.sum = 0.0
        self.count = 0
        self.samples: collections.deque = collections.deque(
            maxlen=keep_samples
        )

    def observe(self, v: float) -> None:
        v = float(v)
        # bisect_left: v == edge -> that edge's bucket (le includes ==)
        self.counts[bisect.bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1
        self.samples.append(v)

    @property
    def last(self) -> Optional[float]:
        """Most recent observation (None before the first)."""
        return self.samples[-1] if self.samples else None

    def percentiles(self) -> Optional[Dict[str, float]]:
        """Exact p50/p99/mean/max over the retained samples (None when
        empty). Exactness holds for the retained window; past
        ``keep_samples`` observations the window slides."""
        if not self.samples:
            return None
        s = sorted(self.samples)
        n = len(s)

        def q(p):
            return s[min(n - 1, int(round(p * (n - 1))))]

        return {
            "p50": float(q(0.50)),
            "p99": float(q(0.99)),
            "mean": float(self.sum / self.count) if self.count == n
            else float(sum(s) / n),
            "max": float(s[-1]),
        }


class EventJournal:
    """Append-only structured event log.

    Every event gets a monotonically increasing ``seq`` and the
    registry clock's timestamp, then the caller's fields verbatim (keep
    them JSON-able — ints, floats, strings, lists). Capacity is a
    drop-oldest bound; ``seq`` keeps increasing across trims, so a
    reader that sees seq jump knows events were dropped, never
    reordered.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 capacity: int = 4096):
        self.clock = clock
        self.events: collections.deque = collections.deque(
            maxlen=capacity
        )
        self._seq = 0

    def append(self, kind: str, **fields: Any) -> Dict[str, Any]:
        ev = {"seq": self._seq, "t": self.clock(), "kind": kind,
              **fields}
        self._seq += 1
        self.events.append(ev)
        return ev

    def __len__(self) -> int:
        return len(self.events)

    def snapshot(self) -> List[Dict[str, Any]]:
        return [dict(ev) for ev in self.events]


class TickTrace:
    """Named span timestamps of one tick's trip through the pipeline.

    Marks record in insertion order (the order the pipeline reaches
    them: stage -> commit -> dispatch -> retire); consecutive marks
    define the spans `span_percentiles` aggregates.
    """

    __slots__ = ("id", "marks", "_clock")

    def __init__(self, trace_id: Any, clock: Callable[[], float]):
        self.id = trace_id
        self.marks: Dict[str, float] = {}
        self._clock = clock

    def mark(self, name: str, t: Optional[float] = None) -> None:
        self.marks[name] = self._clock() if t is None else float(t)


def span_percentiles(traces: Iterable[TickTrace]
                     ) -> Dict[str, Dict[str, float]]:
    """Roll per-tick traces into per-span duration percentiles.

    For each trace, consecutive marks (insertion order) become spans
    named ``"<a>_to_<b>"``, plus ``"total"`` (first mark to last); the
    result maps span name -> {count, p50_ms, p99_ms, mean_ms} over
    every trace that carried that span. Durations are milliseconds.
    """
    durs: Dict[str, List[float]] = {}
    for tr in traces:
        items = list(tr.marks.items())
        if len(items) < 2:
            continue
        for (a, ta), (b, tb) in zip(items, items[1:]):
            durs.setdefault(f"{a}_to_{b}", []).append((tb - ta) * 1e3)
        durs.setdefault("total", []).append(
            (items[-1][1] - items[0][1]) * 1e3
        )
    out = {}
    for name, vals in durs.items():
        s = sorted(vals)
        n = len(s)

        def q(p, s=s, n=n):
            return s[min(n - 1, int(round(p * (n - 1))))]

        out[name] = {
            "count": n,
            "p50_ms": float(q(0.50)),
            "p99_ms": float(q(0.99)),
            "mean_ms": float(sum(s) / n),
        }
    return out


class _Family:
    """One metric name: its kind, help text, and labeled children."""

    __slots__ = ("name", "kind", "help", "children", "buckets",
                 "keep_samples")

    def __init__(self, name, kind, help_text, buckets=None,
                 keep_samples=None):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.buckets = buckets
        self.keep_samples = keep_samples
        self.children: Dict[Tuple[Tuple[str, str], ...], Any] = {}

    def child(self, labels: Dict[str, Any]):
        key = tuple(sorted((str(k), str(v)) for k, v in labels.items()))
        got = self.children.get(key)
        if got is None:
            if self.kind == "counter":
                got = Counter()
            elif self.kind == "gauge":
                got = Gauge()
            else:
                got = Histogram(self.buckets, self.keep_samples)
            self.children[key] = got
        return got


def _escape_label(v: str) -> str:
    return v.replace("\\", r"\\").replace('"', r"\"").replace(
        "\n", r"\n"
    )


def _labels_str(key: Tuple[Tuple[str, str], ...]) -> str:
    if not key:
        return ""
    inner = ",".join(f'{k}="{_escape_label(v)}"' for k, v in key)
    return "{" + inner + "}"


class MetricsRegistry:
    """Process-local metric families + journal + trace ring.

    `counter` / `gauge` / `histogram` get-or-create: the first call for
    a name fixes its kind (and, for histograms, its buckets); a later
    call with the same name returns the existing family (extra label
    sets create new children) and a kind conflict raises. ``clock`` is
    injectable for deterministic tests and stamps the journal, traces,
    and nothing else — metric values are whatever callers observe.
    """

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 journal_capacity: int = 4096,
                 trace_capacity: int = 4096,
                 keep_samples: int = 8192):
        self.clock = clock
        self.keep_samples = keep_samples
        self.journal = EventJournal(clock=clock,
                                    capacity=journal_capacity)
        self.traces: collections.deque = collections.deque(
            maxlen=trace_capacity
        )
        self._families: Dict[str, _Family] = {}

    # ---- metric families ----

    def _family(self, name, kind, help_text, buckets=None) -> _Family:
        fam = self._families.get(name)
        if fam is None:
            fam = _Family(
                name, kind, help_text, buckets=buckets,
                keep_samples=self.keep_samples,
            )
            self._families[name] = fam
        elif fam.kind != kind:
            raise ValueError(
                f"metric {name!r} already registered as {fam.kind}, "
                f"requested {kind}"
            )
        return fam

    def counter(self, name: str, help_text: str = "",
                **labels: Any) -> Counter:
        return self._family(name, "counter", help_text).child(labels)

    def gauge(self, name: str, help_text: str = "",
              **labels: Any) -> Gauge:
        return self._family(name, "gauge", help_text).child(labels)

    def histogram(self, name: str, help_text: str = "",
                  buckets: Iterable[float] = DEFAULT_MS_BUCKETS,
                  **labels: Any) -> Histogram:
        return self._family(
            name, "histogram", help_text, buckets=tuple(buckets)
        ).child(labels)

    # ---- traces ----

    def trace(self, trace_id: Any = None) -> TickTrace:
        """New per-tick trace, appended to the bounded ring."""
        tr = TickTrace(trace_id, self.clock)
        self.traces.append(tr)
        return tr

    # ---- export ----

    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able dict of everything: metric values (histograms
        with per-bucket counts AND exact percentiles over the retained
        samples; raw samples stay out — they are bounded but big),
        journal events, and per-span duration rollups of the trace
        ring. `json.loads(json.dumps(snapshot()))` round-trips equal.
        """
        counters, gauges, hists = [], [], []
        for fam in self._families.values():
            for key, child in fam.children.items():
                entry = {
                    "name": fam.name,
                    "help": fam.help,
                    "labels": {k: v for k, v in key},
                }
                if fam.kind == "counter":
                    counters.append({**entry, "value": child.value})
                elif fam.kind == "gauge":
                    gauges.append({**entry, "value": child.value})
                else:
                    hists.append({
                        **entry,
                        "buckets": [float(b) for b in child.buckets],
                        "counts": list(child.counts),
                        "sum": float(child.sum),
                        "count": int(child.count),
                        "percentiles": child.percentiles(),
                    })
        return {
            "counters": counters,
            "gauges": gauges,
            "histograms": hists,
            "journal": self.journal.snapshot(),
            "spans": span_percentiles(self.traces),
        }

    def render_prometheus(self) -> str:
        """Prometheus text exposition (v0.0.4) of every metric family.

        Histograms render cumulative ``_bucket{le=...}`` series (the
        +Inf bucket equals ``_count``) plus ``_sum`` / ``_count``;
        journal events and traces are not metrics and do not render.
        """
        lines: List[str] = []
        for fam in self._families.values():
            if fam.help:
                lines.append(f"# HELP {fam.name} {fam.help}")
            lines.append(f"# TYPE {fam.name} {fam.kind}")
            for key, child in fam.children.items():
                ls = _labels_str(key)
                if fam.kind in ("counter", "gauge"):
                    lines.append(f"{fam.name}{ls} {child.value}")
                    continue
                cum = 0
                for edge, c in zip(child.buckets, child.counts):
                    cum += c
                    le = _labels_str(key + (("le", repr(float(edge))),))
                    lines.append(f"{fam.name}_bucket{le} {cum}")
                inf = _labels_str(key + (("le", "+Inf"),))
                lines.append(f"{fam.name}_bucket{inf} {child.count}")
                lines.append(f"{fam.name}_sum{ls} {child.sum}")
                lines.append(f"{fam.name}_count{ls} {child.count}")
        return "\n".join(lines) + "\n"
