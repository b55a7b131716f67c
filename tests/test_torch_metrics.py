"""The port's observability layer (`repro_torch.serving.metrics` and the
server's instrumentation) against the reference.

Mirrors tests/test_metrics.py: a metrics-enabled server gives the same
bits as a metrics-off twin for every backend, cascaded and pipelined
(`np.testing.assert_array_equal`); the registry's units behave as the
reference's; resize, shard loss and the autoscaler journal their events
in the reference's order and with its fields; the snapshot's ``server``
block has the reference server's keys; and the Prometheus text equals
the reference registry's for the same observations under an injected
clock.
"""

import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.fex import fit_norm_stats
from repro.core.pipeline import KWSPipeline as JPipeline
from repro.core.pipeline import KWSPipelineConfig as JConfig
from repro.serving import metrics as jm
from repro.serving.serve_loop import StreamingKWSServer as JServer
from repro_torch import convert
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.serving import metrics as tm
from repro_torch.serving.autoscale import AutoscalePolicy, Autoscaler
from repro_torch.serving.cascade import CascadeConfig
from repro_torch.serving.ingress import PipelinedIngress, TickCoalescer
from repro_torch.serving.metrics import (
    Counter,
    EventJournal,
    Gauge,
    Histogram,
    MetricsRegistry,
    TickTrace,
    span_percentiles,
)
from repro_torch.serving.serve_loop import StreamingKWSServer

MAX_STREAMS = 8
CLASSIFIERS = ("float", "qat", "integer", "delta", "delta-int")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((4, 8000)).astype(np.float32) * 0.05)
    _, raw = JPipeline(JConfig(use_norm=False)).features(audio)
    stats = fit_norm_stats(jq.log_compress_lut(raw, 12, 10))
    params = JPipeline(JConfig()).init_params(jax.random.PRNGKey(3))
    tstats = convert.norm_stats_from_numpy(np.asarray(stats.mu), np.asarray(stats.sigma), "cpu")
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return stats, params, tstats, tparams


def _pipe(setup, classifier="qat", cascade=None):
    return KWSPipeline(KWSPipelineConfig(classifier=classifier, cascade=cascade),
                       norm_stats=setup[2])


def _ticks(pipe, n, kind="fv", seed=0):
    rng = np.random.default_rng(seed)
    dim = pipe.chunk_samples if kind == "audio" else 16
    return [((rng.standard_normal((MAX_STREAMS, dim)) * 0.05).astype(np.float32),
             rng.random(MAX_STREAMS) > 0.25) for _ in range(n)]


def _twin_servers(pipe, params, n_open=MAX_STREAMS):
    on = StreamingKWSServer(pipe, params, max_streams=MAX_STREAMS, device="cpu", metrics=True)
    off = StreamingKWSServer(pipe, params, max_streams=MAX_STREAMS, device="cpu")
    for sid in range(n_open):
        on.open_stream(sid)
        off.open_stream(sid)
    return on, off


def _assert_states_identical(a, b):
    la, lb = a.state.leaves(), b.state.leaves()
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y)


# ---------------- the gate: metrics on == metrics off ----------------

@pytest.mark.parametrize("classifier", CLASSIFIERS)
def test_metrics_bit_identical_all_backends(setup, classifier):
    pipe = _pipe(setup, classifier)
    on, off = _twin_servers(pipe, setup[3])
    sync = _ticks(pipe, 2, "fv", seed=1) + _ticks(pipe, 2, "audio", seed=2)
    for slab, mask in sync:
        gs, gt = on.step_batch(slab, mask)
        rs, rt = off.step_batch(slab, mask)
        np.testing.assert_array_equal(gs, rs)
        np.testing.assert_array_equal(gt, rt)
    deferred = _ticks(pipe, 3, "fv", seed=3)
    handles = [on.step_batch_async(s, m) for s, m in deferred]
    for h, (s, m) in zip(handles, deferred):
        rs, rt = off.step_batch(s, m)
        gs, gt = h.result()
        np.testing.assert_array_equal(gs, rs)
        np.testing.assert_array_equal(gt, rt)
    window = _ticks(pipe, 3, "fv", seed=4)
    scores_seq, tops = on.run_batch_async(np.stack([s for s, _ in window]),
                                          np.stack([m for _, m in window])).result()
    for t, (s, m) in enumerate(window):
        rs, rt = off.step_batch(s, m)
        np.testing.assert_array_equal(scores_seq[t], rs)
        np.testing.assert_array_equal(tops[t], rt)
    _assert_states_identical(on, off)
    assert on.metrics.counter("kws_serve_ticks_total").value == 2 + 2 + 3 + 3
    assert on.metrics.histogram("kws_serve_tick_ms").count == len(sync)


@pytest.mark.parametrize("wake_threshold", [0.0, 0.15])
def test_metrics_bit_identical_cascaded(setup, wake_threshold):
    pipe = _pipe(setup, "qat", CascadeConfig(wake_threshold=wake_threshold, hangover_frames=1))
    on, off = _twin_servers(pipe, setup[3])
    gains = np.logspace(-3, 0, MAX_STREAMS).astype(np.float32)[:, None]
    for slab, mask in _ticks(pipe, 5, "audio", seed=5):
        gs, gt = on.step_batch(slab * gains * 20, mask)
        rs, rt = off.step_batch(slab * gains * 20, mask)
        np.testing.assert_array_equal(gs, rs)
        np.testing.assert_array_equal(gt, rt)
    _assert_states_identical(on, off)
    np.testing.assert_array_equal(on.wake_rate, off.wake_rate)
    assert on.metrics_snapshot()["server"]["wake_rate_mean"] == float(np.mean(off.wake_rate))


def test_metrics_bit_identical_pipelined_ingress(setup):
    pipe = _pipe(setup)
    on, off = _twin_servers(pipe, setup[3])
    ing_on, ing_off = PipelinedIngress(on, 16, depth=2), PipelinedIngress(off, 16, depth=2)
    for s, m in _ticks(pipe, 6, "fv", seed=9):
        for ing in (ing_on, ing_off):
            slab, mask = ing.stage()
            slab[:] = s
            mask[:] = m
            ing.commit()
    for ha, hb in zip(ing_on.drain(), ing_off.drain(), strict=True):
        np.testing.assert_array_equal(ha.scores, hb.scores)
        np.testing.assert_array_equal(ha.top, hb.top)
    _assert_states_identical(on, off)


# ---------------- registry units ----------------

def test_histogram_bucket_edges_le_inclusive():
    assert tm.DEFAULT_MS_BUCKETS == jm.DEFAULT_MS_BUCKETS
    assert tm.TICK_BUDGET_MS == jm.TICK_BUDGET_MS
    h = Histogram(buckets=(1.0, 2.0, 4.0))
    for v, bucket in [(0.5, 0), (1.0, 0), (1.5, 1), (2.0, 1), (4.0, 2), (4.0001, 3), (100.0, 3)]:
        before = list(h.counts)
        h.observe(v)
        assert h.counts[bucket] == before[bucket] + 1, (v, bucket)
    assert h.counts == [2, 2, 1, 2] and h.count == 7 and h.last == 100.0
    p = h.percentiles()
    assert p["max"] == 100.0 and p["p50"] == 2.0


def test_histogram_validation_and_sample_window():
    for bad in ((2.0, 1.0), (1.0, 1.0), ()):
        with pytest.raises(ValueError, match="ascending"):
            Histogram(buckets=bad)
    h = Histogram(buckets=(10.0,), keep_samples=4)
    assert h.last is None and h.percentiles() is None
    for v in [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]:
        h.observe(v)
    assert h.count == 6 and list(h.samples) == [3.0, 4.0, 5.0, 6.0]
    assert h.percentiles()["max"] == 6.0


def test_counter_monotonic_and_gauge():
    c = Counter()
    c.inc()
    c.inc(3)
    assert c.value == 4
    with pytest.raises(ValueError, match=">= 0"):
        c.inc(-1)
    g = Gauge()
    g.set(7)
    assert g.value == 7.0 and isinstance(g.value, float)


def test_registry_get_or_create_and_kind_conflict():
    reg = MetricsRegistry()
    c1 = reg.counter("x_total", "help")
    assert reg.counter("x_total") is c1
    with pytest.raises(ValueError, match="already registered"):
        reg.gauge("x_total")
    a = reg.counter("y_total", reason="full")
    assert a is not reg.counter("y_total", reason="deadline")
    assert reg.counter("y_total", reason="full") is a


def test_journal_seq_monotonic_across_trim():
    t = [0.0]
    journal = EventJournal(clock=lambda: t[0], capacity=4)
    for i in range(10):
        t[0] = float(i)
        journal.append("ev", i=i)
    assert len(journal) == 4
    snap = journal.snapshot()
    assert [e["seq"] for e in snap] == [6, 7, 8, 9] and [e["i"] for e in snap] == [6, 7, 8, 9]
    snap[0]["i"] = 999
    assert journal.snapshot()[0]["i"] == 6


def test_server_journals_its_build_and_retraces(setup):
    """compile_count is 1 after construction; a retrace is the first
    launch of a (program, shape) pair, journaled in order."""
    pipe = _pipe(setup)
    srv = StreamingKWSServer(pipe, setup[3], max_streams=MAX_STREAMS, device="cpu", metrics=True)
    off = StreamingKWSServer(pipe, setup[3], max_streams=MAX_STREAMS, device="cpu")
    for s in (srv, off):
        s.open_stream(0)
        assert s.compile_count == 1 and s.retrace_count == 0
        for slab, mask in _ticks(pipe, 2, "fv") + _ticks(pipe, 1, "audio"):
            s.step_batch(slab, mask)
        s.run_batch(np.zeros((2, MAX_STREAMS, 16), np.float32), np.ones((2, MAX_STREAMS), bool))
        assert s.retrace_count == 3
    kinds = [(e["kind"], e.get("program")) for e in srv.metrics.journal.snapshot()]
    assert kinds == [("compile_programs", None), ("retrace", "tick_fv"),
                     ("retrace", "tick_audio"), ("retrace", "run_fv")]
    assert srv.metrics.counter("kws_serve_retraces_total").value == 3
    assert srv.metrics.counter("kws_serve_compile_programs_total").value == 1


def test_journal_orders_resize_events(setup):
    """resize() journals one "resize" event with before / after capacity;
    a resize back to a seen shape journals but does not retrace."""
    pipe = _pipe(setup)
    srv = StreamingKWSServer(pipe, setup[3], max_streams=MAX_STREAMS, device="cpu", metrics=True)
    srv.open_stream(0)
    for n in (MAX_STREAMS, 2 * MAX_STREAMS, MAX_STREAMS):
        if n != srv.max_streams:
            srv.resize(n)
        srv.step_batch(np.zeros((n, 16), np.float32), np.ones(n, bool))
    ev = srv.metrics.journal.snapshot()
    assert [e["kind"] for e in ev] == [
        "compile_programs", "retrace", "resize", "retrace", "resize"]
    seqs = [e["seq"] for e in ev]
    assert seqs == sorted(seqs) and len(set(seqs)) == len(seqs)
    grows = [e for e in ev if e["kind"] == "resize"]
    assert [(e["from_streams"], e["to_streams"], e["open_streams"], e["n_devices"])
            for e in grows] == [(8, 16, 1, 1), (16, 8, 1, 1)]
    assert srv.retrace_count == 2 and srv.compile_count == 1
    assert srv.metrics.gauge("kws_serve_capacity").value == MAX_STREAMS


def test_journal_orders_shard_loss_events(setup):
    """The rebuild ("compile_programs") happens mid-recovery, before the
    "shard_loss" summary; the first tick after it retraces again."""
    pipe = _pipe(setup)
    srv = StreamingKWSServer(pipe, setup[3], max_streams=MAX_STREAMS,
                             devices=["cpu"] * 4, metrics=True)
    for sid in range(MAX_STREAMS):
        srv.open_stream(sid)
    srv.step_batch(np.zeros((MAX_STREAMS, 16), np.float32), np.ones(MAX_STREAMS, bool))
    r0 = srv.retrace_count
    info = srv.recover_shard_loss(0)
    srv.step_batch(np.zeros((srv.max_streams, 16), np.float32), np.ones(srv.max_streams, bool))
    journal = srv.metrics.journal.snapshot()
    assert [e["kind"] for e in journal] == [
        "compile_programs", "retrace", "compile_programs", "shard_loss", "retrace"]
    assert journal[2]["n_devices"] == 2
    loss = journal[3]
    assert (loss["lost_shard"], loss["from_devices"], loss["to_devices"]) == (0, 4, 2)
    assert (loss["from_streams"], loss["to_streams"]) == (MAX_STREAMS, srv.max_streams)
    assert loss["reopened"] == info["reopened"] == [0, 4]
    assert loss["survivors"] == info["survivors"]
    assert srv.retrace_count == r0 + 1 and srv.compile_count == 2
    assert srv.metrics.counter("kws_serve_compile_programs_total").value == 2


def _auto(setup, n_open, **policy):
    srv = StreamingKWSServer(_pipe(setup), setup[3], max_streams=policy.get("min_streams", 8),
                             device="cpu", metrics=True)
    for sid in range(n_open):
        srv.open_stream(sid)
    return srv, Autoscaler(srv, AutoscalePolicy(**policy), monitor=StragglerMonitor(warmup=0))


def test_autoscaler_grow_reasons_and_counter(setup):
    srv, auto = _auto(setup, n_open=8, min_streams=8, max_streams=32,
                      hysteresis_ticks=2, cooldown_ticks=0)
    assert auto.last_decision is None
    assert auto.observe() is None
    assert auto.observe() == "grow"
    assert auto.last_decision == {"step": 2, "action": "grow", "from": 8, "to": 16,
                                  "reason": "occupancy_watermark"}
    auto.note_rejection()
    assert auto.observe() == "grow"
    assert auto.last_decision["reason"] == "rejection"
    assert srv.max_streams == 32
    assert srv.metrics.counter("kws_autoscale_decisions_total", action="grow").value == 2
    kinds = [e["kind"] for e in srv.metrics.journal.snapshot()]
    assert kinds.index("resize") < kinds.index("autoscale")
    scale = [e for e in srv.metrics.journal.snapshot() if e["kind"] == "autoscale"]
    assert [(e["action"], e["reason"], e["from_streams"], e["to_streams"], e["open_streams"])
            for e in scale] == [("grow", "occupancy_watermark", 8, 16, 8),
                                ("grow", "rejection", 16, 32, 8)]


def test_autoscaler_slo_veto_recorded_once_per_trip(setup):
    srv, auto = _auto(setup, n_open=1, min_streams=4, max_streams=16, shrink_at=0.3,
                      grow_at=0.9, hysteresis_ticks=2, cooldown_ticks=0)
    srv.resize(16)
    auto.observe(0.001)
    assert auto.observe(0.1) is None
    assert auto.last_decision == {"step": 2, "action": "hold", "from": 16, "to": 16,
                                  "reason": "slo_veto"}
    assert auto.observe(0.1) is None
    vetos = [e for e in srv.metrics.journal.snapshot() if e["kind"] == "autoscale"]
    assert len(vetos) == 1 and vetos[0]["reason"] == "slo_veto"
    assert srv.metrics.counter("kws_autoscale_decisions_total", action="hold").value == 1
    assert auto.observe(0.001) == "shrink"
    assert auto.last_decision["action"] == "shrink"
    assert auto.last_decision["reason"] == "occupancy_watermark"
    assert srv.max_streams < 16


def _exercised_server(setup):
    pipe = _pipe(setup)
    srv = StreamingKWSServer(pipe, setup[3], max_streams=MAX_STREAMS, device="cpu", metrics=True)
    for sid in range(MAX_STREAMS):
        srv.open_stream(sid)
    ing = PipelinedIngress(srv, 16, depth=2)
    for s, m in _ticks(pipe, 5, "fv", seed=17):
        slab, mask = ing.stage()
        slab[:] = s
        mask[:] = m
        ing.commit()
    ing.drain()
    return srv


def test_metrics_snapshot_json_round_trip(setup):
    srv = _exercised_server(setup)
    snap = srv.metrics_snapshot()
    assert set(snap) >= {"server", "counters", "gauges", "histograms", "journal", "spans"}
    sb = snap["server"]
    assert sb["open_streams"] == MAX_STREAMS and sb["occupancy"] == 1.0
    assert sb["retraces"] == srv.retrace_count >= 1 and sb["compiles"] == 1
    assert sb["tick_impl"] == "auto" and sb["tick_dispatch"] == "cpu" and sb["n_devices"] == 1
    assert json.loads(json.dumps(snap)) == snap
    assert snap["spans"]["stage_to_commit"]["count"] == 5
    assert snap["spans"]["dispatch_to_retire"]["count"] == 5
    assert snap["spans"]["total"]["count"] == 5
    # the reference server's block has the same keys
    stats, params = setup[:2]
    jsrv = JServer(JPipeline(JConfig(classifier="qat"), norm_stats=stats), params,
                   max_streams=MAX_STREAMS, tick_impl="xla")
    assert set(jsrv.metrics_snapshot()["server"]) == set(sb)
    off = StreamingKWSServer(_pipe(setup), setup[3], max_streams=MAX_STREAMS, device="cpu",
                             metrics=False)
    assert off.metrics is None
    snap_off = off.metrics_snapshot()
    assert set(snap_off) == {"server"} and json.loads(json.dumps(snap_off)) == snap_off
    assert snap_off["server"]["sparsity_mean"] is None


def _observe_all(mod, clock):
    """The same observations into a registry of module ``mod``."""
    reg = mod.MetricsRegistry(clock=clock)
    reg.counter("kws_serve_ticks_total", "ticks").inc(7)
    reg.counter("kws_coalescer_flushes_total", "flushes", reason="full").inc(2)
    reg.counter("kws_coalescer_flushes_total", "flushes", reason="deadline").inc()
    reg.gauge("kws_serve_occupancy", "occupancy").set(0.375)
    h = reg.histogram("kws_serve_tick_ms", "tick ms")
    for v in (0.1, 0.25, 0.7261, 3.0, 16.0, 17.5, 2000.0):
        h.observe(v)
    reg.histogram("kws_custom_ms", "custom", buckets=(1.0, 2.0), stage="a").observe(1.5)
    reg.journal.append("retrace", program="tick_fv", shape=[8, 16])
    tr = reg.trace(("tick", 0))
    tr.mark("stage")
    tr.mark("commit")
    return reg


def test_prometheus_text_and_snapshot_equal_the_reference_registry():
    t = [5.0]

    def clock():
        t[0] += 0.001
        return t[0]

    mine = _observe_all(tm, clock)
    t[0] = 5.0
    theirs = _observe_all(jm, clock)
    assert mine.render_prometheus() == theirs.render_prometheus()
    assert mine.snapshot() == theirs.snapshot()


_SAMPLE_RE = re.compile(
    r"^([a-zA-Z_:][a-zA-Z0-9_:]*)"
    r'(\{[a-zA-Z_][a-zA-Z0-9_]*="[^"]*"'
    r'(,[a-zA-Z_][a-zA-Z0-9_]*="[^"]*")*\})?'
    r" (-?[0-9.e+\-]+|NaN)$"
)


def test_prometheus_exposition_parses(setup):
    text = _exercised_server(setup).metrics.render_prometheus()
    assert text.endswith("\n")
    families, samples = {}, {}
    for line in text.strip().split("\n"):
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split(" ")
            families[name] = kind
        elif not line.startswith("# HELP "):
            m = _SAMPLE_RE.match(line)
            assert m, f"unparseable sample line: {line!r}"
            samples.setdefault(m.group(1), []).append(line)
    assert families["kws_serve_ticks_total"] == "counter"
    assert families["kws_serve_tick_dispatch_ms"] == "histogram"
    assert families["kws_serve_occupancy"] == "gauge"
    for name, kind in families.items():
        if kind != "histogram":
            continue
        buckets = samples.get(name + "_bucket", [])
        counts = [float(ln.rsplit(" ", 1)[1]) for ln in buckets]
        assert counts == sorted(counts)
        inf = [ln for ln in buckets if 'le="+Inf"' in ln][0]
        assert float(inf.rsplit(" ", 1)[1]) == float(samples[name + "_count"][0].rsplit(" ", 1)[1])


def test_prometheus_label_escaping():
    reg = MetricsRegistry()
    reg.counter("esc_total", "", path='a"b\\c\nd').inc()
    assert r'path="a\"b\\c\nd"' in reg.render_prometheus()


def test_ingress_trace_marks_ordered(setup):
    srv = _exercised_server(setup)
    traces = list(srv.metrics.traces)
    assert len(traces) == 5
    for tr in traces:
        assert list(tr.marks) == ["stage", "commit", "dispatch", "retire"]
        ts = list(tr.marks.values())
        assert ts == sorted(ts)
    assert srv.metrics.counter("kws_ingress_dispatches_total").value == 5
    assert srv.metrics.gauge("kws_ingress_in_flight").value == 0.0


def test_span_percentiles_rollup():
    t = [0.0]
    reg = MetricsRegistry(clock=lambda: t[0])
    for k in range(3):
        tr = reg.trace(("tick", k))
        tr.mark("stage", t=0.0)
        tr.mark("commit", t=0.001 * (k + 1))
        tr.mark("retire", t=0.010)
    spans = span_percentiles(reg.traces)
    assert spans["stage_to_commit"]["count"] == 3
    np.testing.assert_allclose(spans["stage_to_commit"]["mean_ms"], 2.0)
    np.testing.assert_allclose(spans["total"]["mean_ms"], 10.0)
    assert spans == jm.span_percentiles(reg.traces)
    lone = TickTrace("x", lambda: 0.0)
    lone.mark("stage")
    assert span_percentiles([lone]) == {}


def test_coalescer_flush_reason_counters(setup):
    pipe = _pipe(setup)
    srv = StreamingKWSServer(pipe, setup[3], max_streams=MAX_STREAMS, device="cpu", metrics=True)
    for sid in range(2):
        srv.open_stream(sid)
    clock = [100.0]
    co = TickCoalescer(srv, clock=lambda: clock[0], window_ms=16.0)
    f = np.ones(16, np.float32)

    def flushes(reason):
        return srv.metrics.counter("kws_coalescer_flushes_total", reason=reason).value

    co.add(0, f)
    co.add(1, f)
    assert flushes("full") == 1
    co.add(0, f)
    clock[0] += 0.017
    co.poll()
    assert flushes("deadline") == 1
    co.add(0, f)
    co.add(0, 2 * f)
    assert flushes("second_frame") == 1
    co.flush()
    assert flushes("manual") == 1
    co.drain()


def test_tick_handle_done_at_stamped_on_first_ready_poll(setup):
    pipe = _pipe(setup)
    srv = StreamingKWSServer(pipe, setup[3], max_streams=MAX_STREAMS, device="cpu", metrics=True)
    for sid in range(MAX_STREAMS):
        srv.open_stream(sid)
    slab, mask = _ticks(pipe, 1, "fv", seed=23)[0]
    h = srv.step_batch_async(slab, mask)
    while not h.ready():
        pass
    assert h.done_at is not None
    d0 = h.done_at
    h.result()
    assert h.done_at == d0
    h2 = srv.step_batch_async(slab, mask)
    h2.result()
    assert h2.done_at is not None
    assert srv.metrics.histogram("kws_serve_tick_fetch_ms").count >= 2
    assert srv.metrics.gauge("kws_serve_open_streams").value == MAX_STREAMS
    srv.close_stream(0)
    assert srv.metrics.gauge("kws_serve_occupancy").value == (MAX_STREAMS - 1) / MAX_STREAMS
