"""The port's StreamingKWSServer (CPU tier) against the reference's XLA
tick, for the qat and integer classifiers.

Raw-audio and FV_Norm slabs, rotating partial masks, an all-idle tick,
the `run_batch` replay, slot reuse and the lifecycle errors, in the
pattern of tests/test_tick_fused.py. GRU state, frontend carry and `top`
must be array-equal; smoothed scores agree within 1e-6 absolute, since
the float tail (exp, the smoothing sum) rounds differently from XLA's
(R1 measured 7.5e-9 between two layouts of the reference itself).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.fex import fit_norm_stats
from repro.core.pipeline import KWSPipeline as JPipeline
from repro.core.pipeline import KWSPipelineConfig as JConfig
from repro.serving.serve_loop import StreamingKWSServer as JServer
from repro_torch import convert
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.serving.serve_loop import StreamingKWSServer

CLASSIFIERS = ("qat", "integer")
SCORE_ATOL = 1e-6


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((4, 8000)).astype(np.float32) * 0.05)
    _, raw = JPipeline(JConfig(use_norm=False)).features(audio)
    stats = fit_norm_stats(jq.log_compress_lut(raw, 12, 10))
    params = JPipeline(JConfig()).init_params(jax.random.PRNGKey(7))
    return stats, params


def _pair(setup, classifier, max_streams):
    stats, params = setup
    jsrv = JServer(
        JPipeline(JConfig(classifier=classifier), norm_stats=stats), params,
        max_streams=max_streams, tick_impl="xla",
    )
    tstats = convert.norm_stats_from_numpy(
        np.asarray(stats.mu), np.asarray(stats.sigma), "cpu"
    )
    tsrv = StreamingKWSServer(
        KWSPipeline(KWSPipelineConfig(classifier=classifier), norm_stats=tstats),
        convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu"),
        max_streams=max_streams, device="cpu",
    )
    return jsrv, tsrv


def _assert_states_equal(jsrv, tsrv):
    for a, b in zip(jsrv.state.gru, tsrv.state.gru):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    for k in ("s1", "s2"):
        np.testing.assert_array_equal(
            tsrv.state.carry[k].numpy(), np.asarray(jsrv.state.carry[k])
        )
    np.testing.assert_allclose(
        tsrv.scores, jsrv.scores, rtol=0, atol=SCORE_ATOL
    )


def _assert_tick_equal(j_out, t_out):
    np.testing.assert_allclose(t_out[0], j_out[0], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(t_out[1], np.asarray(j_out[1]))


def _raw_slab(rng, n, hop=256, gain=0.05):
    return (rng.standard_normal((n, hop)) * gain).astype(np.float32)


@pytest.mark.parametrize("classifier", CLASSIFIERS)
def test_live_raw_ticks_partial_masks_and_idle(setup, classifier):
    jsrv, tsrv = _pair(setup, classifier, max_streams=7)
    open_ids = (0, 1, 2, 3, 4)
    for srv in (jsrv, tsrv):
        for sid in open_ids:
            srv.open_stream(sid)
    rng = np.random.default_rng(1)
    n = 7
    for t in range(5):
        slab = _raw_slab(rng, n, gain=0.05 * (1 + t))
        mask = np.zeros(n, bool)
        for sid in open_ids:
            mask[tsrv.active[sid]] = (t + sid) % 3 != 0
        _assert_tick_equal(jsrv.step_batch(slab, mask), tsrv.step_batch(slab, mask))
    idle = np.zeros((n, 256), np.float32), np.zeros(n, bool)
    before = [t.clone() for t in tsrv.state.gru]
    _assert_tick_equal(jsrv.step_batch(*idle), tsrv.step_batch(*idle))
    for a, b in zip(before, tsrv.state.gru):
        assert torch.equal(a, b)
    _assert_states_equal(jsrv, tsrv)


@pytest.mark.parametrize("classifier", CLASSIFIERS)
def test_fv_norm_slabs(setup, classifier):
    jsrv, tsrv = _pair(setup, classifier, max_streams=6)
    for srv in (jsrv, tsrv):
        for sid in range(6):
            srv.open_stream(sid)
    rng = np.random.default_rng(2)
    for t in range(4):
        fv = np.array(jq.fake_quant(
            jnp.asarray(rng.standard_normal((6, 16)).astype(np.float32) * 2),
            jq.ACT_Q6_8,
        ))
        mask = np.arange(6) % (t + 2) != 0
        _assert_tick_equal(jsrv.step_batch(fv, mask), tsrv.step_batch(fv, mask))
    _assert_states_equal(jsrv, tsrv)


@pytest.mark.parametrize("classifier", CLASSIFIERS)
def test_run_batch_8_ticks(setup, classifier):
    jsrv, tsrv = _pair(setup, classifier, max_streams=5)
    for srv in (jsrv, tsrv):
        for sid in range(4):
            srv.open_stream(sid)
    rng = np.random.default_rng(3)
    slab = (rng.standard_normal((8, 5, 256)) * 0.08).astype(np.float32)
    mask = rng.random((8, 5)) < 0.75
    mask[5] = False  # an all-idle tick inside the replay
    j_scores, j_tops = jsrv.run_batch(slab, mask)
    t_scores, t_tops = tsrv.run_batch(slab, mask)
    assert t_scores.shape == (8, 5, 12) and t_tops.shape == (8, 5)
    np.testing.assert_allclose(t_scores, np.asarray(j_scores), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(t_tops, np.asarray(j_tops))
    _assert_states_equal(jsrv, tsrv)


@pytest.mark.parametrize("classifier", CLASSIFIERS)
def test_slot_reuse_and_run(setup, classifier):
    jsrv, tsrv = _pair(setup, classifier, max_streams=13)
    rng = np.random.default_rng(4)
    for srv in (jsrv, tsrv):
        for sid in (10, 11, 12):
            srv.open_stream(sid)
    frames = {sid: _raw_slab(rng, 1)[0] for sid in (10, 11, 12)}
    j_out, t_out = jsrv.step(frames), tsrv.step(frames)
    for sid in frames:
        assert t_out[sid]["top"] == j_out[sid]["top"]
    for srv in (jsrv, tsrv):
        srv.close_stream(11)
        srv.open_stream(42)  # reuses slot 1, zeroed
    assert tsrv.active[42] == jsrv.active[42] == 1
    assert not tsrv.state.gru[0][1].any() and not tsrv.state.carry["s1"][1].any()
    buffers = {42: _raw_slab(rng, 1, hop=700)[0], 10: _raw_slab(rng, 1, hop=512)[0]}
    j_run, t_run = jsrv.run(buffers), tsrv.run(buffers)
    for sid in buffers:
        assert t_run[sid]["top"] == j_run[sid]["top"]
        np.testing.assert_allclose(
            t_run[sid]["probs"], np.asarray(j_run[sid]["probs"]), rtol=0,
            atol=SCORE_ATOL,
        )
    _assert_states_equal(jsrv, tsrv)
    assert tsrv.step({}) == {}


def test_lifecycle_and_input_errors(setup):
    _, tsrv = _pair(setup, "qat", max_streams=2)
    tsrv.open_stream(0)
    with pytest.raises(ValueError, match="stream 0 already open"):
        tsrv.open_stream(0)
    with pytest.raises(ValueError, match="stream 5 not open"):
        tsrv.close_stream(5)
    with pytest.raises(ValueError, match=r"stream\(s\) \[7\] not open"):
        tsrv.step({7: np.zeros(256, np.float32)})
    tsrv.open_stream(1)
    with pytest.raises(RuntimeError, match="capacity"):
        tsrv.open_stream(2)
    with pytest.raises(ValueError, match="same kind"):
        tsrv.step({0: np.zeros(256, np.float32), 1: np.zeros(16, np.float32)})
    with pytest.raises(ValueError, match="trailing dim 17"):
        tsrv.step_batch(np.zeros((2, 17), np.float32), np.ones(2, bool))
    with pytest.raises(ValueError, match="slab must be"):
        tsrv.step_batch(np.zeros((3, 16), np.float32), np.ones(3, bool))
    tsrv.close_stream(1)
    with pytest.raises(ValueError, match="stream 1 not open"):
        tsrv.close_stream(1)


def test_tick_impl_accepts_only_auto(setup):
    stats, params = setup
    pipe = KWSPipeline(KWSPipelineConfig())
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    for impl in ("xla", "fused-pallas", "plain"):
        with pytest.raises(ValueError, match=r"tick_impl must be one of \('auto',\)"):
            StreamingKWSServer(pipe, tp, max_streams=2, tick_impl=impl, device="cpu")


def test_default_device_is_the_card(setup):
    stats, params = setup
    tstats = convert.norm_stats_from_numpy(
        np.asarray(stats.mu), np.asarray(stats.sigma), "cpu"
    )
    pipe = KWSPipeline(KWSPipelineConfig(), norm_stats=tstats)
    tp = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    if torch.cuda.is_available():
        assert StreamingKWSServer(pipe, tp, max_streams=2).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match='device="cpu"'):
            StreamingKWSServer(pipe, tp, max_streams=2)
