"""The port's elastic fleet against the reference's sharded server.

The oracle is the reference's ``tick_impl="xla"`` server on the emulated
8-device CPU mesh of tests/conftest.py (``devices=4``); the port runs
four shards on the CPU (``devices=["cpu"] * 4``), each with its own state
tensors and its own tick, beside an unsharded, never-resized port twin.
Through live ticks, a grow, a shrink back and a shard loss, every state
leaf (GRU / ΔGRU memories, accumulators and counters, the frontend
carry, the detector state), `top`, `sparsity` and `wake_rate` are
array-equal to the reference's, and per stream id to the twin's; scores
within 1e-6, and the float backend within F1's 2e-6 (R3: width-matched,
four slots a shard on both sides). `recover_shard_loss`'s summary, the
`Autoscaler`'s decisions on one seeded open / close / rejection trace,
the retrace / compile counts and the validation errors equal the
reference's; `StreamRouter.remap` equals the reference's on random
occupancies.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.fex import fit_norm_stats
from repro.core.gru_delta import DeltaConfig as JDelta
from repro.core.pipeline import KWSPipeline as JPipeline
from repro.core.pipeline import KWSPipelineConfig as JConfig
from repro.distributed.fault_tolerance import StragglerMonitor as JMonitor
from repro.serving.autoscale import AutoscalePolicy as JPolicy
from repro.serving.autoscale import Autoscaler as JAutoscaler
from repro.serving.autoscale import StreamRouter as JRouter
from repro.serving.cascade import CascadeConfig as JCascade
from repro.serving.serve_loop import StreamingKWSServer as JServer
from repro_torch import convert
from repro_torch.core.gru_delta import DeltaConfig
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.distributed.fault_tolerance import StragglerMonitor
from repro_torch.distributed.sharding import stream_devices, surviving_devices
from repro_torch.serving.autoscale import AutoscalePolicy, Autoscaler, StreamRouter, shard_of_slot
from repro_torch.serving.cascade import CascadeConfig
from repro_torch.serving.serve_loop import StreamingKWSServer

from _hypothesis_compat import given, settings, st

N_DEV = len(jax.devices())
pytestmark = pytest.mark.skipif(
    N_DEV < 4, reason="needs the 8-device emulated CPU platform of tests/conftest.py")

MAX_STREAMS = 16
GROWN = 2 * MAX_STREAMS
SHARDS = 4
SCORE_ATOL = 1e-6
FLOAT_ATOL = 2e-6
THETA = 0.15
CASCADE = dict(wake_threshold=0.3, hangover_frames=1)
# (classifier, cascade): the five backends and a cascaded one
CASES = [(c, None) for c in ("float", "qat", "integer", "delta", "delta-int")] + [
    ("qat", CASCADE)]


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((4, 8000)).astype(np.float32) * 0.05)
    _, raw = JPipeline(JConfig(use_norm=False)).features(audio)
    stats = fit_norm_stats(jq.log_compress_lut(raw, 12, 10))
    params = JPipeline(JConfig()).init_params(jax.random.PRNGKey(5))
    tstats = convert.norm_stats_from_numpy(np.asarray(stats.mu), np.asarray(stats.sigma), "cpu")
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return stats, params, tstats, tparams


def _pipes(setup, classifier, cascade=None):
    stats, _, tstats, _ = setup
    delta = THETA if classifier.startswith("delta") else None
    jd = None if delta is None else JDelta(delta, delta)
    td = None if delta is None else DeltaConfig(delta, delta)
    jc = None if cascade is None else JCascade(**cascade)
    tc = None if cascade is None else CascadeConfig(**cascade)
    return (JPipeline(JConfig(classifier=classifier, delta=jd, cascade=jc), norm_stats=stats),
            KWSPipeline(KWSPipelineConfig(classifier=classifier, delta=td, cascade=tc),
                        norm_stats=tstats))


def _servers(setup, classifier, cascade=None, max_streams=MAX_STREAMS, **kw):
    """(reference on 4 mesh devices, the port on 4 CPU shards, the port
    unsharded)."""
    jpipe, tpipe = _pipes(setup, classifier, cascade)
    jsrv = JServer(jpipe, setup[1], max_streams=max_streams, devices=SHARDS,
                   tick_impl="xla", **kw)
    tsrv = StreamingKWSServer(tpipe, setup[3], max_streams=max_streams,
                              devices=["cpu"] * SHARDS, **kw)
    twin = StreamingKWSServer(tpipe, setup[3], max_streams=max_streams, device="cpu")
    return jsrv, tsrv, twin


def _reference_state(jsrv):
    st = jax.tree_util.tree_map(np.asarray, jsrv.state)
    return convert.server_state_from_numpy(st.gru, st.carry, st.scores, st.det, "cpu")


def _close(a, b, flt, scores=False):
    if flt or scores:
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                   atol=FLOAT_ATOL if flt else SCORE_ATOL)
    else:
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _pairs(got, want):
    """(port leaf, reference leaf) pairs, dicts matched by key."""
    if got is None:
        assert want is None
        return []
    if isinstance(got, dict):
        assert set(got) == set(want)
        return [p for k in got for p in _pairs(got[k], want[k])]
    if isinstance(got, (tuple, list)):
        assert len(got) == len(want)
        return [p for a, b in zip(got, want) for p in _pairs(a, b)]
    return [(got, want)]


def _assert_like_reference(jsrv, tsrv, flt):
    """Every state leaf in global slot order, sparsity and wake_rate."""
    want, got = _reference_state(jsrv), tsrv.state
    for field in ("gru", "carry", "det"):
        for a, b in _pairs(getattr(got, field), getattr(want, field)):
            _close(a, b, flt)
    _close(got.scores, want.scores, flt, scores=True)
    np.testing.assert_array_equal(tsrv.sparsity, jsrv.sparsity)
    np.testing.assert_array_equal(tsrv.wake_rate, jsrv.wake_rate)
    assert tsrv.active == jsrv.active


def _slot_leaves(srv, sid):
    slot = srv.active[sid]
    return [t[slot] for t in srv.state.leaves()]


def _assert_like_twin(tsrv, twin, flt):
    for sid in twin.active:
        for a, b in zip(_slot_leaves(tsrv, sid), _slot_leaves(twin, sid)):
            _close(a, b, flt)


@pytest.mark.parametrize("classifier,cascade", CASES,
                         ids=[c if k is None else f"{c}-cascade" for c, k in CASES])
def test_resize_shards_and_shard_loss(setup, classifier, cascade):
    flt = classifier == "float"
    jsrv, tsrv, twin = _servers(setup, classifier, cascade)
    servers = (jsrv, tsrv, twin)
    for srv in servers:
        for sid in range(10):
            srv.open_stream(sid)
    rng = np.random.default_rng(30)

    def tick(raw=False):
        """One tick of every open stream: raw audio hops (half loud, half
        near silence) or FV_Norm frames on the Q6.8 grid (the plain
        frontend on the CPU is the slow part, so most ticks are FV)."""
        frames = {}
        for sid in sorted(tsrv.active):
            scale = 0.3 if rng.random() < 0.5 else 0.003
            if raw:
                frames[sid] = (rng.standard_normal(256) * scale).astype(np.float32)
            else:
                frames[sid] = np.array(jq.fake_quant(
                    jnp.asarray(rng.standard_normal(16) * 600 * scale), jq.ACT_Q6_8))
        outs = [srv.step(frames) for srv in servers]
        for sid in frames:
            np.testing.assert_allclose(outs[1][sid]["probs"], outs[0][sid]["probs"],
                                       rtol=0, atol=FLOAT_ATOL if flt else SCORE_ATOL)
            np.testing.assert_allclose(outs[1][sid]["probs"], outs[2][sid]["probs"],
                                       rtol=0, atol=FLOAT_ATOL if flt else 0)
            if not flt:
                assert outs[1][sid]["top"] == outs[0][sid]["top"] == outs[2][sid]["top"]

    tick(raw=True)
    tick()
    _assert_like_reference(jsrv, tsrv, flt)
    for srv in (jsrv, tsrv):
        srv.resize(GROWN)
        assert srv.max_streams == srv.router.max_streams == GROWN
    assert tsrv.active == jsrv.active
    assert all(t.shape[0] == GROWN // SHARDS for st in tsrv._shards for t in st.leaves())
    tick()
    for srv in servers:  # the grown capacity is usable; the twin has room too
        for sid in range(100, 106):
            srv.open_stream(sid)
    tick()
    for srv in servers:
        for sid in range(100, 106):
            srv.close_stream(sid)
    for srv in (jsrv, tsrv):
        srv.resize(MAX_STREAMS)
    tick()
    _assert_like_reference(jsrv, tsrv, flt)
    _assert_like_twin(tsrv, twin, flt)
    assert (tsrv.retrace_count, tsrv.compile_count) == (jsrv.retrace_count, jsrv.compile_count)

    pre = {sid: _slot_leaves(tsrv, sid) for sid in tsrv.active}
    lost = {sid for sid, slot in tsrv.active.items()
            if shard_of_slot(slot, MAX_STREAMS, SHARDS) == 1}
    info = tsrv.recover_shard_loss(1)
    assert info == jsrv.recover_shard_loss(1)
    assert set(info["reopened"]) == lost and info["n_devices"] == 2
    assert tsrv.n_devices == len(tsrv._shards) == 2
    for sid in info["survivors"]:
        for a, b in zip(_slot_leaves(tsrv, sid), pre[sid]):
            assert torch.equal(a, b)
    for sid in info["reopened"]:
        assert not any(t.any() for t in _slot_leaves(tsrv, sid))
        twin.close_stream(sid)  # the twin replays the reopened streams afresh
        twin.open_stream(sid)
    _assert_like_reference(jsrv, tsrv, flt)
    tick(raw=True)
    tick()
    _assert_like_reference(jsrv, tsrv, flt)
    _assert_like_twin(tsrv, twin, flt)
    assert (tsrv.retrace_count, tsrv.compile_count) == (jsrv.retrace_count, jsrv.compile_count)
    assert tsrv.compile_count == 2


def test_sharded_slabs_and_replay(setup):
    """`step_batch` and `run_batch` slabs on four shards: array-equal to
    the unsharded port server (slot for slot) and to the reference."""
    jsrv, tsrv, twin = _servers(setup, "integer")
    for srv in (jsrv, tsrv, twin):
        for sid in range(13):
            srv.open_stream(sid)
    rng = np.random.default_rng(31)
    for dim in (256, 16):  # a raw-audio tick, then an FV_Norm one
        slab = (rng.standard_normal((MAX_STREAMS, dim)) * 0.1).astype(np.float32)
        mask = rng.random(MAX_STREAMS) < 0.7
        ws, wt = jsrv.step_batch(slab, mask)
        (ss, st_), (us, ut) = tsrv.step_batch(slab, mask), twin.step_batch(slab, mask)
        np.testing.assert_array_equal(ss, us)
        np.testing.assert_array_equal(st_, ut)
        np.testing.assert_allclose(ss, np.asarray(ws), rtol=0, atol=SCORE_ATOL)
        np.testing.assert_array_equal(st_, np.asarray(wt))
    slab = (rng.standard_normal((3, MAX_STREAMS, 256)) * 0.1).astype(np.float32)
    mask = rng.random((3, MAX_STREAMS)) < 0.7
    ws, wt = jsrv.run_batch(slab, mask)
    (ss, st_), (us, ut) = tsrv.run_batch(slab, mask), twin.run_batch(slab, mask)
    np.testing.assert_array_equal(ss, us)
    np.testing.assert_array_equal(st_, ut)
    np.testing.assert_allclose(ss, np.asarray(ws), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(st_, np.asarray(wt))
    for a, b in zip(tsrv.state.leaves(), twin.state.leaves()):
        assert torch.equal(a, b)
    _assert_like_reference(jsrv, tsrv, False)
    assert tsrv.retrace_count == jsrv.retrace_count == 3
    # the accessors read the global slot order
    assert [torch.equal(a, b) for a, b in zip(tsrv.states, twin.state.gru)] == [True, True]
    assert all(torch.equal(tsrv.feat_carry[k], twin.state.carry[k]) for k in ("s1", "s2"))


def _raises_like(fn_port, fn_ref):
    with pytest.raises(Exception) as want:
        fn_ref()
    with pytest.raises(type(want.value)) as got:
        fn_port()
    assert str(got.value) == str(want.value)


def test_resize_and_recovery_validation(setup):
    jsrv, tsrv, twin = _servers(setup, "qat")
    for srv in (jsrv, tsrv):
        for sid in range(10):
            srv.open_stream(sid)
    _raises_like(lambda: tsrv.resize(MAX_STREAMS + 1), lambda: jsrv.resize(MAX_STREAMS + 1))
    _raises_like(lambda: tsrv.resize(0), lambda: jsrv.resize(0))
    _raises_like(lambda: tsrv.resize(SHARDS), lambda: jsrv.resize(SHARDS))
    _raises_like(lambda: tsrv.recover_shard_loss(SHARDS), lambda: jsrv.recover_shard_loss(SHARDS))
    _raises_like(lambda: twin.recover_shard_loss(0),
                 lambda: JServer(_pipes(setup, "qat")[0], setup[1], max_streams=4,
                                 tick_impl="xla").recover_shard_loss(0))
    shards = list(tsrv._shards)
    tsrv.resize(MAX_STREAMS)  # the same capacity is a no-op
    assert all(a is b for a, b in zip(tsrv._shards, shards))
    _raises_like(
        lambda: StreamingKWSServer(_pipes(setup, "qat")[1], setup[3], max_streams=10,
                                   devices=["cpu"] * SHARDS),
        lambda: JServer(_pipes(setup, "qat")[0], setup[1], max_streams=10, devices=SHARDS))
    with pytest.raises(ValueError, match="not both"):
        StreamingKWSServer(_pipes(setup, "qat")[1], setup[3], device="cpu", devices=["cpu"])
    with pytest.raises(ValueError, match="one device type"):
        stream_devices(["cpu", "meta"])
    if torch.cuda.device_count() < 4:
        with pytest.raises(ValueError, match=r"devices=4\) but only"):
            stream_devices(4)
    assert stream_devices(["cpu"] * 3) == [torch.device("cpu")] * 3
    assert surviving_devices(["a", "b", "c"], 1) == ["a", "c"]
    with pytest.raises(ValueError, match="outside"):
        surviving_devices(["a"], 1)
    one = StreamingKWSServer(_pipes(setup, "qat")[1], setup[3], max_streams=4, devices=["cpu"])
    assert one.n_devices == 1 and one.router.n_shards == 1


def test_handle_in_flight_across_resize(setup):
    """A handle dispatched before a resize returns its own tick's
    results, and the resized server goes on as its synchronous twin."""
    _, tsrv, _ = _servers(setup, "delta-int")
    _, twin, _ = _servers(setup, "delta-int")
    for srv in (tsrv, twin):
        for sid in range(MAX_STREAMS):
            srv.open_stream(sid)
    rng = np.random.default_rng(32)
    mask = np.ones(MAX_STREAMS, bool)
    fv1, fv2 = (rng.standard_normal((2, MAX_STREAMS, 16)) * 2).astype(np.float32)
    s1, t1 = twin.step_batch(fv1, mask)
    handle = tsrv.step_batch_async(fv1, mask)
    tsrv.resize(GROWN)
    s_b, t_b = handle.result()
    np.testing.assert_array_equal(s1, s_b)
    np.testing.assert_array_equal(t1, t_b)
    out_a = twin.step({sid: fv2[sid] for sid in range(MAX_STREAMS)})
    out_b = tsrv.step({sid: fv2[sid] for sid in range(MAX_STREAMS)})
    for sid in range(MAX_STREAMS):
        np.testing.assert_array_equal(out_a[sid]["probs"], out_b[sid]["probs"])


@settings(max_examples=40, deadline=None)
@given(
    n_shards=st.sampled_from((1, 2, 4)),
    blocks=st.integers(min_value=1, max_value=6),
    grow=st.integers(min_value=-3, max_value=4),
    data=st.data(),
)
def test_remap_equals_the_reference(n_shards, blocks, grow, data):
    old_max = blocks * n_shards
    occupied = data.draw(st.lists(st.integers(0, old_max - 1), unique=True, max_size=old_max))
    new_max = max(1, blocks + grow) * n_shards
    if len(occupied) > new_max:
        with pytest.raises(ValueError, match="cannot remap"):
            StreamRouter.remap(occupied, new_max, n_shards)
        return
    (tr, tm), (jr, jm) = (cls.remap(occupied, new_max, n_shards) for cls in (StreamRouter, JRouter))
    assert tm == jm
    assert tr.shard_loads() == jr.shard_loads() and tr.free_count == jr.free_count
    assert [tr.acquire() for _ in range(tr.free_count)] == [
        jr.acquire() for _ in range(jr.free_count)]


def test_remap_rejects_duplicates():
    with pytest.raises(ValueError, match="unique"):
        StreamRouter.remap([1, 1], MAX_STREAMS, SHARDS)


def _autoscale_trace(server, auto_cls, policy_cls, monitor_cls, seed=33):
    """Ramp, peak and drain of stream opens and closes, one observation a
    step with a seeded latency (spikes trip the SLO veto); a refused open
    is a rejection. Returns the decisions and each step's (sid -> slot)."""
    policy = policy_cls(min_streams=4, max_streams=32, grow_at=0.75, shrink_at=0.3,
                        hysteresis_ticks=2, cooldown_ticks=3)
    auto = auto_cls(server, policy, monitor=monitor_cls(threshold=2.0, budget=3, warmup=0))
    rng = np.random.default_rng(seed)
    placements, nxt = [], 0
    for step in range(60):
        p_open = 0.9 if step < 20 else 0.5 if step < 35 else 0.05
        for _ in range(2):
            if rng.random() < p_open:
                try:
                    server.open_stream(nxt)
                    nxt += 1
                except RuntimeError:
                    auto.note_rejection()
            elif server.active and rng.random() < 0.7:
                server.close_stream(sorted(server.active)[int(rng.integers(len(server.active)))])
        latency = 0.05 if 40 <= step < 44 else 0.001 * (1 + 0.1 * rng.random())
        auto.observe(latency)
        placements.append(dict(server.active))
    return auto, placements


def test_autoscaler_decisions_equal_the_reference(setup):
    jpipe, tpipe = _pipes(setup, "qat")
    jsrv = JServer(jpipe, setup[1], max_streams=4, devices=2, tick_impl="xla")
    tsrv = StreamingKWSServer(tpipe, setup[3], max_streams=4, devices=["cpu"] * 2)
    tauto, tplace = _autoscale_trace(tsrv, Autoscaler, AutoscalePolicy, StragglerMonitor)
    jauto, jplace = _autoscale_trace(jsrv, JAutoscaler, JPolicy, JMonitor)
    assert tauto.events == jauto.events
    assert tauto.last_decision == jauto.last_decision
    actions = {e["action"] for e in tauto.events}
    assert {"grow", "shrink"} <= actions
    assert any(e["reason"] == "rejection" for e in tauto.events)
    assert tplace == jplace
    assert tsrv.max_streams == jsrv.max_streams
    _assert_like_reference(jsrv, tsrv, False)


@pytest.mark.parametrize("kw,match", [
    (dict(grow_at=0.3, shrink_at=0.8), "shrink_at"), (dict(min_streams=0), "min_streams"),
    (dict(factor=1), "factor"), (dict(hysteresis_ticks=0), "hysteresis")])
def test_autoscale_policy_validation(kw, match):
    _raises_like(lambda: AutoscalePolicy(**kw), lambda: JPolicy(**kw))
    with pytest.raises(ValueError, match=match):
        AutoscalePolicy(**kw)
