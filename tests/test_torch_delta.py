"""The port's ΔGRU engine, its K4 plain version and the delta / delta-int /
float servers (CPU tier) against the reference.

The oracle is the reference's XLA tier: jitted `delta_classifier_forward`
/ `int_delta_classifier_forward`, the pure-jnp `gather_delta_matmul` /
`gather_delta_intgemm`, and `tick_impl="xla"` servers. Weights and states
are carried across through numpy (`repro_torch.convert`). Every ΔGRU
state leaf (memories, accumulators, counters), FV-driven `top` and
`sparsity` must be array-equal; smoothed scores agree within 1e-6, as in
tests/test_torch_serving.py. The float backend is not width-stable in the
reference (R3): it is held width-matched to FLOAT_ATOL.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gru as jgru
from repro.core import gru_delta as jgd
from repro.core import quant as jq
from repro.core.fex import fit_norm_stats
from repro.core.pipeline import KWSPipeline as JPipeline
from repro.core.pipeline import KWSPipelineConfig as JConfig
from repro.kernels.intgemm import intgemm_ref as j_intgemm_ref
from repro.kernels.tick_fused import kernel as jk
from repro.serving.quantize import quantize_classifier as j_quantize
from repro.serving.serve_loop import StreamingKWSServer as JServer
from repro_torch import convert
from repro_torch.core import gru as tgru
from repro_torch.core import gru_delta as tgd
from repro_torch.core import gru_int as tgi
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.kernels.intgemm import intgemm_ref
from repro_torch.kernels.tick_fused import gather, tick_reference
from repro_torch.serving.cascade import CascadeConfig
from repro_torch.serving.serve_loop import ServerState, StreamingKWSServer

CFG = jgru.GRUConfig()
TCFG = tgru.GRUConfig()
SCORE_ATOL = 1e-6
# float backend, width-matched (R3 in ROADMAP): the largest difference
# measured on the CPU over 24 raw-audio ticks, 3 weight seeds, 7 and 33
# slots, was 2.4e-7 on the GRU states and 3e-8 on the scores; the bound
# leaves 8x room for other BLAS builds
FLOAT_ATOL = 2e-6
THETAS = {
    "0": (0.0, 0.0, None),
    "0.15": (0.15, 0.15, None),
    "0.25": (0.25, 0.25, None),
    "per-layer": (0.0, 0.0, ((0.1, 0.2), (0.3, 0.05))),
}


def _delta(name):
    tx, th, per_layer = THETAS[name]
    return (jgd.DeltaConfig(tx, th, per_layer), tgd.DeltaConfig(tx, th, per_layer))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_delta_states_equal(t_states, j_states):
    assert len(t_states) == len(j_states)
    for tl, jl in zip(t_states, j_states):
        assert set(tl) == set(jl)
        for k in jl:
            assert tl[k].dtype == (torch.int32 if k in ("skipped", "total")
                                   or jl[k].dtype == jnp.int32 else torch.float32)
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]), err_msg=k)


@pytest.fixture(scope="module")
def params():
    jp = jgru.init_gru_classifier(jax.random.PRNGKey(0), CFG)
    jcodes = j_quantize(jp, CFG)
    return (jp, convert.params_from_numpy(_np(jp), "cpu"), jcodes,
            convert.quantized_from_numpy(_np(jcodes), "cpu"))


def _grid_fv(shape, seed, scale=1.5):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * scale
    return np.array(jq.fake_quant(jnp.asarray(x), jq.ACT_Q6_8))


# --------------------------------------------------------------------------
# DeltaConfig
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(THETAS))
def test_delta_config_code_thresholds(name):
    jcfg, tcfg = _delta(name)
    assert tcfg.code_thresholds(2) == jcfg.code_thresholds(2)
    assert tcfg.per_layer == jcfg.per_layer
    assert hash(tcfg) == hash(tgd.DeltaConfig(*THETAS[name]))


def test_delta_config_validation():
    assert tgd.DeltaConfig(0.15, 0.1).code_thresholds(3) == ((38, 26),) * 3
    assert tgd.DeltaConfig(per_layer=[[0.5, 1], (0, 2)]).per_layer == ((0.5, 1.0), (0.0, 2.0))
    for bad in (dict(theta_x=-0.1), dict(theta_h=-1e-9), dict(per_layer=((0.1, -0.2),))):
        with pytest.raises(ValueError, match=">= 0"):
            tgd.DeltaConfig(**bad)
        with pytest.raises(ValueError, match=">= 0"):
            jgd.DeltaConfig(**bad)
    with pytest.raises(ValueError, match="1 entries for 2 GRU layers"):
        tgd.DeltaConfig(per_layer=((0.1, 0.1),)).code_thresholds(2)


# --------------------------------------------------------------------------
# the engine, both domains
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(THETAS))
def test_forward_both_domains_match(params, name):
    jp, tp, jcodes, tcodes = params
    jcfg, tcfg = _delta(name)
    th = jcfg.code_thresholds(2)
    assert tcfg.code_thresholds(2) == th
    fv = _grid_fv((4, 7, 16), 1)
    jl, js = jax.jit(lambda p, x: jgd.delta_classifier_forward(
        p, x, CFG, th, return_states=True))(jp, fv)
    tl, ts = tgd.delta_classifier_forward(tp, torch.from_numpy(fv), TCFG, th,
                                          return_states=True)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    _assert_delta_states_equal(ts, js)
    codes = np.array(jq.quantize_int(jnp.asarray(fv), jq.ACT_Q6_8))
    jl_i, js_i = jax.jit(lambda p, x: jgd.int_delta_classifier_forward(
        p, x, CFG, th, return_states=True))(jcodes, codes)
    tl_i, ts_i = tgd.int_delta_classifier_forward(
        tcodes, torch.from_numpy(codes), TCFG, th, return_states=True)
    np.testing.assert_array_equal(tl_i.numpy(), np.asarray(jl_i))
    _assert_delta_states_equal(ts_i, js_i)
    # the two domains fire identically and their values agree
    np.testing.assert_array_equal(tl.numpy(), tl_i.numpy() * np.float32(2**-8))
    np.testing.assert_array_equal(
        tgd.effective_mac_fraction(ts, TCFG).numpy(),
        np.asarray(jgd.effective_mac_fraction(js, CFG)),
    )
    if name == "0":  # θ = 0 is the dense base backend bit for bit
        np.testing.assert_array_equal(
            tl.numpy(), tgru.gru_classifier_forward(tp, torch.from_numpy(fv), TCFG).numpy())
        np.testing.assert_array_equal(
            tl_i.numpy(),
            tgi.int_gru_classifier_forward(tcodes, torch.from_numpy(codes), TCFG).numpy())


@pytest.mark.parametrize("name", ["0", "0.15", "per-layer"])
@pytest.mark.parametrize("classifier", ["delta", "delta-int"])
def test_pipeline_streaming_step_matches(params, classifier, name):
    jp, tp, _, _ = params
    jcfg, tcfg = _delta(name)
    jpipe = JPipeline(JConfig(classifier=classifier, delta=jcfg))
    tpipe = KWSPipeline(KWSPipelineConfig(classifier=classifier, delta=tcfg))
    assert tpipe.classifier.delta == tcfg
    fv = np.random.default_rng(3).standard_normal((5, 6, 16)).astype(np.float32)  # off-grid
    snapped = np.array(jq.fake_quant(jnp.asarray(fv), jq.ACT_Q6_8))  # what the engine sees
    js, ts = jpipe.streaming_init(5), tpipe.streaming_init(5, device="cpu")
    dense = "qat" if classifier == "delta" else "integer"
    dpipe = KWSPipeline(KWSPipelineConfig(classifier=dense))
    ds = dpipe.streaming_init(5, device="cpu")
    step = jax.jit(jpipe.streaming_step)
    for t in range(6):
        js, jl = step(jp, js, fv[:, t])
        ts, tl = tpipe.streaming_step(tp, ts, torch.from_numpy(fv[:, t]))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        if name == "0":
            ds, dl = dpipe.streaming_step(tp, ds, torch.from_numpy(snapped[:, t]))
            np.testing.assert_array_equal(tl.numpy(), dl.numpy())
            for st, h in zip(ts, ds):
                np.testing.assert_array_equal(st["h"].numpy(), h.numpy())
    _assert_delta_states_equal(ts, js)


def test_backends_bind_the_pipeline_config():
    base = KWSPipeline(KWSPipelineConfig(classifier="delta")).classifier
    assert base.delta == tgd.DeltaConfig()
    cfg = tgd.DeltaConfig(0.2, 0.1)
    bound = KWSPipeline(KWSPipelineConfig(classifier="delta-int", delta=cfg)).classifier
    assert bound.delta == cfg and bound.name == "delta-int"
    assert KWSPipeline(KWSPipelineConfig(classifier="delta-int")).classifier is not bound
    dense = KWSPipeline(KWSPipelineConfig(classifier="qat", delta=cfg)).classifier
    assert dense.with_config(KWSPipelineConfig(delta=cfg)) is dense
    # a cascade binds beside the ΔGRU thresholds and leaves the backend bound
    casc = CascadeConfig(wake_threshold=0.1)
    gated = KWSPipeline(KWSPipelineConfig(classifier="delta", delta=cfg, cascade=casc))
    assert gated.config.cascade is casc and gated.classifier.delta == cfg


@pytest.mark.parametrize("classifier", ["float", "qat", "integer", "delta", "delta-int"])
def test_backend_says_whether_it_is_delta(classifier):
    """`is_delta` is the one place that decides delta-ness: it agrees with
    the state shape `is_delta_states` recognises and with the tick's
    sparse step."""
    pipe = KWSPipeline(KWSPipelineConfig(classifier=classifier))
    want = classifier.startswith("delta")
    assert pipe.classifier.is_delta is want
    assert tgd.is_delta_states(pipe.streaming_init(2, "cpu")) is want
    assert (gather.make_sparse_step(pipe) is not None) is want


# --------------------------------------------------------------------------
# K4 plain version
# --------------------------------------------------------------------------

def _k4_case(kind, rng):
    b, i, n = 9, 48, 144
    w_codes = rng.integers(-128, 128, (i, n)).astype(np.int8)
    fire = rng.random((b, i)) < 0.25
    row_mask = None
    if kind == "row-mask":
        row_mask = rng.random(b) < 0.5
    elif kind == "none-fired":
        fire[:] = False
    elif kind == "one-column":
        fire[:] = False
        fire[[1, 4], 17] = True
    elif kind == "every-column":
        fire[:] = True
    d = np.where(fire, rng.integers(-2000, 2000, (b, i)), 0).astype(np.int32)
    d[d == 0] = np.where(fire[d == 0], 1, 0)  # a fired delta is never 0
    if kind == "saturate":
        d = np.where(fire, 16383, 0).astype(np.int32)
        d[:, :30] = 16383
        w_codes[:] = 127
    return d, w_codes, row_mask


@pytest.mark.parametrize(
    "kind", ["random", "row-mask", "none-fired", "one-column", "every-column", "saturate"])
def test_k4_plain_matches_reference(kind):
    d, w_codes, row_mask = _k4_case(kind, np.random.default_rng(len(kind)))
    jm = None if row_mask is None else jnp.asarray(row_mask)
    tm = None if row_mask is None else torch.from_numpy(row_mask)
    # code domain: int24 clip of the whole contribution
    want = np.asarray(jk.gather_delta_intgemm(jnp.asarray(d), jnp.asarray(w_codes), jm))
    got = gather.gather_delta_intgemm(torch.from_numpy(d), torch.from_numpy(w_codes), tm)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    rows = d if row_mask is None else np.where(row_mask[:, None], d, 0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_intgemm_ref(rows, w_codes)))
    np.testing.assert_array_equal(
        got.numpy(), intgemm_ref(torch.from_numpy(rows), torch.from_numpy(w_codes)).numpy())
    if kind == "saturate":
        assert got.numpy().max() == 2**23 - 1
    if kind == "none-fired":
        assert not got.numpy().any()
    # float domain: Q6.8 deltas against the fake-quantized weights
    df = (d.astype(np.float32) * np.float32(2**-8)).clip(-64, 64)
    wf = w_codes.astype(np.float32) * np.float32(2**-7)
    want_f = np.asarray(jk.gather_delta_matmul(jnp.asarray(df), jnp.asarray(wf), jm))
    got_f = gather.gather_delta_matmul(torch.from_numpy(df), torch.from_numpy(wf), tm)
    assert got_f.dtype == torch.float32
    np.testing.assert_array_equal(got_f.numpy(), want_f)
    if kind != "saturate":  # in range the grid sums are exact: dense agrees
        rows_f = df if row_mask is None else np.where(row_mask[:, None], df, 0)
        np.testing.assert_array_equal(got_f.numpy(), rows_f @ wf)


@pytest.mark.parametrize("classifier", ["qat", "float", "delta", "delta-int"])
def test_sparse_step_tick_equals_dense_tick(params, classifier):
    _, tp, _, _ = params
    delta = tgd.DeltaConfig(0.15, 0.15) if classifier.startswith("delta") else None
    pipe = KWSPipeline(KWSPipelineConfig(classifier=classifier, delta=delta))
    step_fn = gather.make_sparse_step(pipe)
    if not classifier.startswith("delta"):
        assert step_fn is None
        return
    p = pipe.prepare_params(tp)
    n = 11
    state = (tuple(pipe.streaming_init(n, "cpu")), pipe.streaming_features_init(n, "cpu"),
             torch.zeros((n, 12)), None)
    rng = np.random.default_rng(5)
    sparse_state = state
    for t in range(4):
        fv = torch.from_numpy(_grid_fv((n, 16), 20 + t))
        mask = torch.from_numpy(rng.random(n) < 0.6)
        state, s_d, top_d = tick_reference(pipe, False, p, state, fv, mask, None, 0.7)
        sparse_state, s_s, top_s = tick_reference(
            pipe, False, p, sparse_state, fv, mask, None, 0.7, step_fn=step_fn)
        assert torch.equal(s_d, s_s) and torch.equal(top_d, top_s)
        for a, b in zip(state[0], sparse_state[0]):
            for k in a:
                assert torch.equal(a[k], b[k]), k


# --------------------------------------------------------------------------
# servers
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def stats_params():
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((4, 8000)).astype(np.float32) * 0.05)
    _, raw = JPipeline(JConfig(use_norm=False)).features(audio)
    stats = fit_norm_stats(jq.log_compress_lut(raw, 12, 10))
    params = JPipeline(JConfig()).init_params(jax.random.PRNGKey(7))
    return stats, params


def _pair(stats_params, classifier, max_streams, theta=None):
    stats, params = stats_params
    jd = td = None
    if theta is not None:
        jd, td = jgd.DeltaConfig(theta, theta), tgd.DeltaConfig(theta, theta)
    jsrv = JServer(
        JPipeline(JConfig(classifier=classifier, delta=jd), norm_stats=stats), params,
        max_streams=max_streams, tick_impl="xla",
    )
    tstats = convert.norm_stats_from_numpy(np.asarray(stats.mu), np.asarray(stats.sigma), "cpu")
    tsrv = StreamingKWSServer(
        KWSPipeline(KWSPipelineConfig(classifier=classifier, delta=td), norm_stats=tstats),
        convert.params_from_numpy(_np(params), "cpu"), max_streams=max_streams, device="cpu",
    )
    return jsrv, tsrv


def _assert_server_equal(jsrv, tsrv, atol=None):
    """Array-equal state (within ``atol`` for the float backend) and
    scores within SCORE_ATOL (or ``atol``)."""
    t_leaves = jax.tree_util.tree_leaves(
        (list(tsrv.state.gru), tsrv.state.carry), is_leaf=torch.is_tensor)
    j_leaves = jax.tree_util.tree_leaves((list(jsrv.state.gru), jsrv.state.carry))
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        if atol is None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        else:
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0, atol=atol)
    np.testing.assert_allclose(tsrv.scores, jsrv.scores, rtol=0, atol=atol or SCORE_ATOL)
    np.testing.assert_array_equal(tsrv.sparsity, jsrv.sparsity)


def _assert_tick_equal(j_out, t_out, atol=None):
    np.testing.assert_allclose(t_out[0], j_out[0], rtol=0, atol=atol or SCORE_ATOL)
    j_top, t_top = np.asarray(j_out[1]), t_out[1]
    if atol is None:
        np.testing.assert_array_equal(t_top, j_top)
        return
    # float: top is held where the two best scores are further apart
    # than the tolerance
    best2 = np.sort(np.asarray(j_out[0]), axis=-1)[..., -2:]
    clear = best2[..., 1] - best2[..., 0] > 2 * atol
    np.testing.assert_array_equal(t_top[clear], j_top[clear])


def _drive(jsrv, tsrv, n, atol=None):
    """Raw ticks with rotating partial masks, an all-idle tick, FV_Norm
    ticks (off the grid) and a run_batch replay with an idle tick."""
    open_ids = range(n - 2)
    for srv in (jsrv, tsrv):
        for sid in open_ids:
            srv.open_stream(sid)
    rng = np.random.default_rng(11)
    gains = np.logspace(-2, -0.5, n).astype(np.float32)[:, None]
    for t in range(4):
        slab = (rng.standard_normal((n, 256)) * gains).astype(np.float32)
        mask = np.zeros(n, bool)
        for sid in open_ids:
            mask[tsrv.active[sid]] = (t + sid) % 3 != 0
        _assert_tick_equal(jsrv.step_batch(slab, mask), tsrv.step_batch(slab, mask), atol)
    idle = np.zeros((n, 256), np.float32), np.zeros(n, bool)
    before = [dict(st) if isinstance(st, dict) else st.clone() for st in tsrv.state.gru]
    _assert_tick_equal(jsrv.step_batch(*idle), tsrv.step_batch(*idle), atol)
    for a, b in zip(before, tsrv.state.gru):
        assert all(torch.equal(a[k], b[k]) for k in a) if isinstance(a, dict) else torch.equal(a, b)
    for t in range(2):
        fv = (rng.standard_normal((n, 16)) * 0.5).astype(np.float32)
        mask = np.arange(n) % (t + 2) != 0
        _assert_tick_equal(jsrv.step_batch(fv, mask), tsrv.step_batch(fv, mask), atol)
    slab = (rng.standard_normal((3, n, 256)) * gains).astype(np.float32)
    mask = rng.random((3, n)) < 0.75
    mask[1] = False
    j_out, t_out = jsrv.run_batch(slab, mask), tsrv.run_batch(slab, mask)
    _assert_tick_equal(j_out, t_out, atol)
    _assert_server_equal(jsrv, tsrv, atol)


@pytest.mark.parametrize("theta", [0.0, 0.15])
@pytest.mark.parametrize("classifier", ["delta", "delta-int"])
def test_delta_server_matches_and_slot_reuse(stats_params, classifier, theta):
    jsrv, tsrv = _pair(stats_params, classifier, max_streams=7, theta=theta)
    _drive(jsrv, tsrv, 7)
    sp = tsrv.sparsity
    assert sp.dtype == np.float32 and sp.shape == (7,)
    if theta > 0:
        assert sp.max() < 1.0
    for srv in (jsrv, tsrv):
        srv.close_stream(2)
        srv.open_stream(42)  # reuses slot 2: every leaf zeroed, counters too
    slot = tsrv.active[42]
    assert slot == jsrv.active[42] == 2
    for st in tsrv.state.gru:
        assert all(not t[slot].any() for t in st.values())
    assert tsrv.sparsity[slot] == 1.0
    buffers = {42: (np.random.default_rng(12).standard_normal(600) * 0.1).astype(np.float32)}
    j_run, t_run = jsrv.run(buffers), tsrv.run(buffers)
    assert t_run[42]["top"] == j_run[42]["top"]
    np.testing.assert_allclose(t_run[42]["probs"], np.asarray(j_run[42]["probs"]),
                               rtol=0, atol=SCORE_ATOL)
    _assert_server_equal(jsrv, tsrv)


@pytest.mark.parametrize("classifier", ["delta", "delta-int"])
def test_delta_server_resumes_from_reference_state(stats_params, classifier):
    jsrv, tsrv = _pair(stats_params, classifier, max_streams=5, theta=0.15)
    rng = np.random.default_rng(13)
    for srv in (jsrv, tsrv):
        for sid in range(5):
            srv.open_stream(sid)
    for _ in range(3):  # the reference alone runs the first ticks
        jsrv.step_batch((rng.standard_normal((5, 256)) * 0.1).astype(np.float32),
                        np.ones(5, bool))
    st = _np(jsrv.state)
    tsrv.state = ServerState(
        gru=tuple(convert.delta_states_from_numpy(st.gru, "cpu")),
        carry={k: torch.tensor(np.array(v)) for k, v in st.carry.items()},
        scores=torch.tensor(np.array(st.scores)),
    )
    np.testing.assert_array_equal(tsrv.sparsity, jsrv.sparsity)
    for t in range(3):
        slab = (rng.standard_normal((5, 256)) * 0.1).astype(np.float32)
        mask = rng.random(5) < 0.7
        _assert_tick_equal(jsrv.step_batch(slab, mask), tsrv.step_batch(slab, mask))
    _assert_server_equal(jsrv, tsrv)


def test_float_server_width_matched(stats_params):
    jsrv, tsrv = _pair(stats_params, "float", max_streams=7)
    _drive(jsrv, tsrv, 7, atol=FLOAT_ATOL)


@pytest.mark.parametrize("classifier", ["float", "qat", "integer"])
def test_dense_servers_report_dense_sparsity(stats_params, classifier):
    stats, params = stats_params
    tstats = convert.norm_stats_from_numpy(np.asarray(stats.mu), np.asarray(stats.sigma), "cpu")
    tsrv = StreamingKWSServer(
        KWSPipeline(KWSPipelineConfig(classifier=classifier), norm_stats=tstats),
        convert.params_from_numpy(_np(params), "cpu"), max_streams=4, device="cpu",
    )
    tsrv.open_stream(0)
    tsrv.step({0: np.zeros(256, np.float32)})
    sp = tsrv.sparsity
    assert sp.dtype == np.float32 and sp.shape == (4,) and (sp == 1.0).all()
