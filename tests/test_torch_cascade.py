"""The port's stage-1 cascade (`repro_torch.serving.cascade` and the gated
branch of the serving tick) against the reference's XLA tier.

- Config validation, `always_on`, hashing, the pipeline binding.
- `detector_scores`: the energy score array-equal; the linear score and
  its sigmoid array-equal to the reference's compiled tick form (the dot a
  fused multiply-add chain, XLA's CPU exp; ROADMAP queue 3, P8), and
  within 4e-7 of the reference's standalone `detector_scores`, whose dot
  XLA compiles alone and sums in another order (the recorded size).
- `gate_step` and `wake_rate` array-equal on seeded score trajectories;
  `fit_linear_detector` array-equal to the reference's fit (the port's
  gradient in the order of the reference's compiled jit(grad)) over
  seeds 0-4 at 100 and 200 full-batch steps and 1, 5, 12, 16 and 20
  channels, both separating; at one channel also over 1-17 frames, at
  16 channels over 3, 7, 13 and 150 frames; its gradient equal to the
  reference's compiled ``jit(grad)`` at one channel and 1-64 rows, at 16
  channels and 1-64, 600, 602, 992 and 994 rows, and at the (width, rows)
  cells where F11 was found. ``python tests/test_torch_cascade.py``
  prints, for widths 1-33 and 1-602 rows, how many draws give a gradient
  unequal to the reference's (ROADMAP queue 3, F5 and F11).
- Servers against the reference's ``tick_impl="xla"`` servers:
  `always_on()` against the ungated server for every backend, the
  reference's LOUD / SILENCE cases, and energy / linear gates on
  raw-audio partial masks with the software and the hardware frontend.
  Detector state, GRU state, `top`, `sparsity` and `wake_rate`
  array-equal; smoothed scores within 1e-6 (the float tail, R1), the
  float backend's GRU state within 2e-6 (F1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.fex import fit_norm_stats
from repro.core.frontend import hardware_state as j_hardware_state
from repro.core.gru_delta import DeltaConfig as JDelta
from repro.core.pipeline import KWSPipeline as JPipeline
from repro.core.pipeline import KWSPipelineConfig as JConfig
from repro.core.tdfex import draw_chip as j_draw_chip
from repro.serving import cascade as jc
from repro.serving.serve_loop import StreamingKWSServer as JServer
from repro_torch import convert
from repro_torch.core.classifier import get_classifier
from repro_torch.core.frontend import FrontendState
from repro_torch.core.gru_delta import DeltaConfig
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.serving import cascade as tc
from repro_torch.serving.serve_loop import StreamingKWSServer

CLASSIFIERS = ("float", "qat", "integer", "delta", "delta-int")
SCORE_ATOL = 1e-6
FLOAT_ATOL = 2e-6  # F1: the float backend's GRU state, width-matched
# the reference's standalone linear score (its dot compiled alone) against
# the tick's order, which the port follows
STANDALONE_LINEAR_ATOL = 4e-7
# on the Q6.8 grid; energy score 0.0 (silence) vs 2.0 (speech-like)
SILENCE_FV = np.full((16,), -1.0, np.float32)
LOUD_FV = np.full((16,), 2.0, np.float32)


def _both(**kw):
    """The same cascade config in both packages."""
    return jc.CascadeConfig(**kw), tc.CascadeConfig(**kw)


# ---------------- config and detector mechanics ----------------

def test_cascade_config_validation():
    with pytest.raises(ValueError, match="detector"):
        tc.CascadeConfig(detector="fft")
    with pytest.raises(ValueError, match="wake_threshold"):
        tc.CascadeConfig(wake_threshold=-0.1)
    with pytest.raises(ValueError, match="release"):
        tc.CascadeConfig(wake_threshold=0.1, release_threshold=0.2)
    with pytest.raises(ValueError, match="release"):
        tc.CascadeConfig(wake_threshold=0.1, release_threshold=-0.05)
    with pytest.raises(ValueError, match="hangover"):
        tc.CascadeConfig(hangover_frames=-1)
    with pytest.raises(ValueError, match="score_decay"):
        tc.CascadeConfig(score_decay=1.5)
    with pytest.raises(ValueError, match="linear_w"):
        tc.CascadeConfig(detector="linear", wake_threshold=0.5)
    assert tc.DETECTORS == jc.DETECTORS


def test_always_on_and_release():
    assert tc.CascadeConfig.always_on().always_open
    assert tc.CascadeConfig().always_open
    assert not tc.CascadeConfig(wake_threshold=0.1).always_open
    assert tc.CascadeConfig(wake_threshold=0.3).release == 0.3
    assert tc.CascadeConfig(wake_threshold=0.3, release_threshold=0.1).release == 0.1
    cc = tc.CascadeConfig(detector="linear", wake_threshold=0.5,
                          linear_w=np.ones(16, np.float32))
    assert isinstance(cc.linear_w, tuple)
    assert hash(cc) == hash(dataclasses.replace(cc))


def test_pipeline_binds_cascade_config():
    cc = tc.CascadeConfig(wake_threshold=0.25)
    cfg = KWSPipelineConfig(classifier="qat", cascade=cc)
    assert cfg.cascade is cc
    assert KWSPipelineConfig().cascade is None
    # the cascade composes around the backend, it does not replace it
    assert KWSPipeline(cfg).classifier is get_classifier("qat")


def _tick_form(cfg):
    """The reference's detector as its serving tick compiles it: fed by a
    fusion (here the Q6.8 snap), so XLA fuses the dot as in the tick."""
    return jax.jit(lambda x: jc.detector_scores(jnp.round(x * 256.0) / 256.0, cfg))


@pytest.mark.parametrize("n", [1, 7, 8, 13, 64])
def test_energy_scores_array_equal(n):
    jcfg, tcfg = _both()
    fv = (np.random.default_rng(n).standard_normal((n, 16)) * 2).astype(np.float32)
    snapped = np.round(fv * 256) / 256
    want = np.asarray(_tick_form(jcfg)(fv))
    np.testing.assert_array_equal(tc.detector_scores(torch.from_numpy(snapped), tcfg).numpy(), want)
    # off the grid too: the eager reference sums left to right as well
    np.testing.assert_array_equal(tc.detector_scores(torch.from_numpy(fv), tcfg).numpy(),
                                  np.asarray(jc.detector_scores(jnp.asarray(fv), jcfg)))
    both = np.stack([SILENCE_FV, LOUD_FV])
    np.testing.assert_array_equal(tc.detector_scores(torch.from_numpy(both), tcfg).numpy(),
                                  np.asarray([0.0, 2.0], np.float32))


@pytest.mark.parametrize("n", [1, 7, 8, 13, 64])
def test_linear_scores_array_equal_to_the_tick_form(n):
    rng = np.random.default_rng(10 + n)
    jcfg, tcfg = _both(detector="linear", wake_threshold=0.5,
                       linear_w=tuple(rng.standard_normal(16)), linear_b=-0.3)
    fv = (rng.standard_normal((n, 16)) * 2).astype(np.float32)
    snapped = np.round(fv * 256) / 256
    got = tc.detector_scores(torch.from_numpy(snapped), tcfg).numpy()
    np.testing.assert_array_equal(got, np.asarray(_tick_form(jcfg)(fv)))
    standalone = np.asarray(jc.detector_scores(jnp.asarray(snapped), jcfg))
    np.testing.assert_allclose(got, standalone, rtol=0, atol=STANDALONE_LINEAR_ATOL)


def test_xla_sigmoid_array_equal():
    rng = np.random.default_rng(4)
    z = np.concatenate([rng.standard_normal(20000) * 6, rng.uniform(-100, 100, 4000),
                        [0.0, -0.0, 87.9, -87.9, 88.9, -88.9, 200.0, -200.0, 1e-40]]).astype(np.float32)
    want = np.asarray(jax.jit(jax.nn.sigmoid)(z))
    np.testing.assert_array_equal(tc.xla_sigmoid(torch.from_numpy(z)).numpy(), want)


def test_detector_scores_nonnegative():
    fv = torch.from_numpy(np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32) * 10)
    assert (tc.detector_scores(fv, tc.CascadeConfig()) >= 0).all()
    sc = tc.detector_scores(fv, tc.CascadeConfig(detector="linear",
                                                 linear_w=tuple(np.linspace(-2, 2, 16))))
    assert ((sc >= 0) & (sc <= 1)).all()


def _gate_run(kw, scores):
    jcfg, tcfg = _both(**kw)
    js, ts = jc.init_state(scores.shape[1]), tc.init_state(scores.shape[1], "cpu")
    gates = []
    for row in scores:
        js, jg = jc.gate_step(js, jnp.asarray(row), jcfg)
        ts, tg = tc.gate_step(ts, torch.from_numpy(row), tcfg)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        for key in js:
            assert ts[key].dtype == {"awake": torch.bool}.get(key, torch.int32)
            np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
        gates.append(tg.numpy())
    np.testing.assert_array_equal(tc.wake_rate(ts).numpy(), np.asarray(jc.wake_rate(js)))
    return ts, gates


def test_gate_step_hysteresis_and_hangover():
    kw = dict(wake_threshold=0.5, release_threshold=0.2, hangover_frames=1)
    scores = np.asarray([[0.6], [0.3], [0.1], [0.1], [0.1]], np.float32)
    ts, gates = _gate_run(kw, scores)
    assert [bool(g[0]) for g in gates] == [True, True, True, False, False]
    assert int(ts["woken"][0]) == 3 and int(ts["ticks"][0]) == 5
    assert float(tc.wake_rate(ts)[0]) == pytest.approx(0.6)


@pytest.mark.parametrize("kw", [dict(wake_threshold=0.15),
                                dict(wake_threshold=0.1, release_threshold=0.05, hangover_frames=3),
                                dict(wake_threshold=0.5, hangover_frames=2)])
def test_gate_step_random_trajectories(kw):
    scores = np.random.default_rng(5).random((8, 8)).astype(np.float32) * 0.6
    # a score exactly on a threshold: >= wakes, < releases, compared as float32
    scores[3, 0] = np.float32(kw["wake_threshold"])
    _gate_run(kw, scores)


def test_wake_rate_unity_without_traffic():
    np.testing.assert_array_equal(tc.wake_rate(tc.init_state(3, "cpu")).numpy(), np.ones(3, np.float32))


def test_init_state_defaults_to_the_card():
    """No device means the card, as at every entry point of the port: it
    raises where there is none rather than running on the CPU."""
    if torch.cuda.is_available():
        assert all(t.device.type == "cuda" for t in tc.init_state(3).values())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tc.init_state(3)


# The port's fit against the reference's jit(grad): exact. The port's
# gradient follows the reference's compiled step operation for operation
# (XLA's exp, log and log1p, the dot and reduction orders; ROADMAP queue 3,
# F3, closed); under autograd the fit differed by up to 4.2e-7 (weights)
# and 4.8e-8 (bias).
FIT_W_ATOL = 0.0
FIT_B_ATOL = 0.0


def _detector_frames(seed, channels=16):
    rng = np.random.default_rng(seed)
    speech = rng.normal(0.8, 0.4, (300, channels)).astype(np.float32)
    silence = rng.normal(-0.8, 0.4, (300, channels)).astype(np.float32)
    return speech, silence


# Widths on both sides of XLA's 8-column GEMV tiles: no tail (16), a tail
# alone (5), one tile and a tail (12), two tiles and a tail (20); and one
# channel, where XLA contracts the product with + b and peels the weight
# gradient's first 8 rows.
@pytest.mark.parametrize("channels", [1, 5, 12, 16, 20])
@pytest.mark.parametrize("steps", [100, 200])
@pytest.mark.parametrize("seed", range(5))
def test_fit_linear_detector_over_seeds(seed, steps, channels):
    speech, silence = _detector_frames(seed, channels)
    jw, jb = jc.fit_linear_detector(speech, silence, steps=steps)
    tw, tb = tc.fit_linear_detector(speech, silence, steps=steps)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=FIT_W_ATOL)
    assert tb == pytest.approx(jb, abs=FIT_B_ATOL)


def _compiled_fit_grad(xs, ys):
    """The reference's fit step, ``jax.jit(jax.grad(loss))`` over xs / ys
    taken as constants, as `repro.serving.cascade.fit_linear_detector`
    builds it."""
    xs, ys = jnp.asarray(xs), jnp.asarray(ys)

    def loss(wb):
        w, b = wb
        z = xs @ w + b
        return jnp.mean(jax.nn.softplus(z) - ys * z)

    return jax.jit(jax.grad(loss))


def _fit_grad_mismatches(n, channels, draws):
    """How many of ``draws`` seeded (w, b) give a dL/dw / a dL/db of the
    port's `_fit_grad` unequal to the reference's compiled one, on seeded
    (n, channels) rows, the first half labelled 1."""
    rng = np.random.default_rng(n * 100 + channels)
    xs = rng.normal(0, 1, (n, channels)).astype(np.float32)
    ys = (np.arange(n) < n // 2).astype(np.float32)
    grad = _compiled_fit_grad(xs, ys)
    bad_w = bad_b = 0
    for _ in range(draws):
        w = rng.normal(size=channels).astype(np.float32)
        b = np.float32(rng.normal())
        jw, jb = grad((jnp.asarray(w), jnp.float32(b)))
        tw, tb = tc._fit_grad(torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(w),
                              torch.tensor(b))
        bad_w += bool((np.asarray(jw) != tw.numpy()).any())
        bad_b += float(jb) != float(tb)
    return bad_w, bad_b


# One channel on both sides of 32 rows: up to 32 XLA fuses the weight
# gradient's dot into the elementwise work (a fused chain from row 0),
# past them it peels the column-major GEMV's first 8 rows.
@pytest.mark.parametrize("n", [1, 2, 5, 8, 16, 17, 31, 32, 33, 34, 64])
def test_fit_grad_at_one_channel_equals_the_compiled_gradient(n):
    assert _fit_grad_mismatches(n, 1, draws=20) == (0, 0)


# F11, repaired: the cells where the gradient at C >= 2 was not the
# reference's (C = 2 from 6 rows; C >= 8 at row counts off 8; C = 8k + 1 at
# multiples of 8 too; one row at every width), now equal on every draw.
F11_CELLS = ([(c, n) for c in (2, 8, 9, 12, 17, 20, 24) for n in (1, 2, 3, 6, 14, 34, 602)]
             + [(c, n) for c in (2, 9, 17) for n in (8, 16, 24, 32, 48, 96, 104)])


@pytest.mark.parametrize("channels,n", F11_CELLS)
def test_fit_grad_equals_the_compiled_gradient(channels, n):
    assert _fit_grad_mismatches(n, channels, draws=20) == (0, 0)


# The die's width at every row count: the last N % 8 rows of z's GEMV sum
# their lanes as a halving tree, one row is a chain from b.
@pytest.mark.parametrize("n", list(range(1, 65)) + [600, 602, 992, 994])
def test_fit_grad_at_the_dies_width_equals_the_compiled_gradient(n):
    assert _fit_grad_mismatches(n, 16, draws=10) == (0, 0)


@pytest.mark.parametrize("frames", [1, 8, 16, 17])
def test_fit_linear_detector_at_one_channel_over_few_frames(frames):
    speech, silence = _detector_frames(frames, 1)
    jw, jb = jc.fit_linear_detector(speech[:frames], silence[:frames], steps=100)
    tw, tb = tc.fit_linear_detector(speech[:frames], silence[:frames], steps=100)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=FIT_W_ATOL)
    assert tb == pytest.approx(jb, abs=FIT_B_ATOL)


# the die's width over frame counts that are not multiples of 4 (N = 2 x
# frames rows, off XLA's 8-row tiles)
@pytest.mark.parametrize("frames", [3, 7, 13, 150])
def test_fit_linear_detector_at_the_dies_width_over_any_frame_count(frames):
    speech, silence = _detector_frames(frames, 16)
    jw, jb = jc.fit_linear_detector(speech[:frames], silence[:frames], steps=100)
    tw, tb = tc.fit_linear_detector(speech[:frames], silence[:frames], steps=100)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=FIT_W_ATOL)
    assert tb == pytest.approx(jb, abs=FIT_B_ATOL)


def test_fit_linear_detector_within_tolerance_of_the_reference():
    speech, silence = _detector_frames(0)
    jw, jb = jc.fit_linear_detector(speech, silence, steps=100)
    tw, tb = tc.fit_linear_detector(speech, silence, steps=100)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=FIT_W_ATOL)
    assert tb == pytest.approx(jb, abs=FIT_B_ATOL)
    cc = tc.CascadeConfig(detector="linear", linear_w=tw, linear_b=tb)
    assert tc.detector_scores(torch.from_numpy(speech), cc).mean() > 0.9
    assert tc.detector_scores(torch.from_numpy(silence), cc).mean() < 0.1
    with pytest.raises(ValueError, match="channel mismatch"):
        tc.fit_linear_detector(speech, silence[:, :8])


# ---------------- servers against the reference ----------------

@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((4, 8000)).astype(np.float32) * 0.05)
    _, raw = JPipeline(JConfig(use_norm=False)).features(audio)
    stats = fit_norm_stats(jq.log_compress_lut(raw, 12, 10))
    params = JPipeline(JConfig()).init_params(jax.random.PRNGKey(7))
    tstats = convert.norm_stats_from_numpy(np.asarray(stats.mu), np.asarray(stats.sigma), "cpu")
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    return stats, params, tstats, tparams


@pytest.fixture(scope="module")
def die(setup):
    """A reference die (jax.random) with beta / alpha and the fitted norm
    stats, in both packages."""
    stats = setup[0]
    tdcfg = JConfig(frontend="hardware").tdfex_config
    chip = j_draw_chip(jax.random.PRNGKey(3), tdcfg)
    rng = np.random.default_rng(1)
    beta = (tdcfg.beta_nominal + 3 * rng.standard_normal(16)).astype(np.float32)
    alpha = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    jstate = j_hardware_state(tdcfg, chip, jnp.asarray(beta), jnp.asarray(alpha), stats)
    tstate = convert.frontend_state_from_numpy(
        "cpu", gain_mismatch=np.asarray(chip.gain_mismatch),
        cf_mismatch=np.asarray(chip.cf_mismatch), beta=beta, alpha=alpha,
        coeffs=np.asarray(jstate.coeffs), mu=np.asarray(stats.mu), sigma=np.asarray(stats.sigma),
    )
    return jstate, tstate


def _pair(setup, classifier, cascade=None, theta=0.0, max_streams=4, frontend="software",
          die=None):
    """A reference server and the port's, same weights and config; the
    cascade is a dict of `CascadeConfig` arguments or None."""
    stats, params, tstats, tparams = setup
    jcasc = tcasc = None
    if cascade is not None:
        jcasc, tcasc = _both(**cascade)
    jstate = tstate = None
    if frontend != "software":
        jstate, tstate = die
    jpipe = JPipeline(JConfig(frontend=frontend, classifier=classifier,
                              delta=JDelta(theta, theta), cascade=jcasc),
                      state=jstate, norm_stats=stats if jstate is None else None)
    tpipe = KWSPipeline(KWSPipelineConfig(frontend=frontend, classifier=classifier,
                                          delta=DeltaConfig(theta, theta), cascade=tcasc),
                        state=tstate, norm_stats=tstats if tstate is None else None)
    return (JServer(jpipe, params, max_streams=max_streams, tick_impl="xla"),
            StreamingKWSServer(tpipe, tparams, max_streams=max_streams, device="cpu"))


def _assert_same(jsrv, tsrv, flt=False):
    """Detector state, GRU state, sparsity and wake_rate array-equal (the
    float backend's GRU state within FLOAT_ATOL); scores within 1e-6."""
    pairs = []
    for ja, tb in zip(jsrv.state.gru, tsrv.state.gru, strict=True):
        pairs += [(ja[k], tb[k]) for k in ja] if isinstance(ja, dict) else [(ja, tb)]
    for a, b in pairs:
        if flt:
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=FLOAT_ATOL)
        else:
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    assert (jsrv.state.det is None) == (tsrv.state.det is None)
    if jsrv.state.det is not None:
        for key, leaf in jsrv.state.det.items():
            assert tsrv.state.det[key].dtype == (torch.bool if key == "awake" else torch.int32)
            np.testing.assert_array_equal(tsrv.state.det[key].numpy(), np.asarray(leaf))
    np.testing.assert_array_equal(tsrv.sparsity, jsrv.sparsity)
    np.testing.assert_array_equal(tsrv.wake_rate, jsrv.wake_rate)
    np.testing.assert_allclose(tsrv.scores, jsrv.scores, rtol=0, atol=SCORE_ATOL)


def _step(jsrv, tsrv, slab, mask, flt=False):
    (js, jt), (ts, tt) = jsrv.step_batch(slab, mask), tsrv.step_batch(slab, mask)
    np.testing.assert_allclose(ts, np.asarray(js), rtol=0, atol=SCORE_ATOL)
    if not flt:
        np.testing.assert_array_equal(tt, np.asarray(jt))
    return ts, tt


def _frames(*rows):
    return {sid: fv for sid, fv in enumerate(rows)}


@pytest.mark.parametrize("classifier", CLASSIFIERS)
def test_always_on_equals_the_ungated_server(setup, classifier):
    """always_on(): the port's cascaded server equals its ungated server
    bit for bit (live raw-audio ticks with partial masks, an FV tick and a
    replay), and both agree with the reference's cascaded server."""
    flt = classifier == "float"
    jsrv, casc = _pair(setup, classifier, cascade=dict(wake_threshold=0.0))
    _, plain = _pair(setup, classifier)
    for srv in (jsrv, casc, plain):
        for sid in range(3):
            srv.open_stream(sid)
    rng = np.random.default_rng(8)
    for t in range(3):
        slab = (rng.standard_normal((4, 256)) * 0.05).astype(np.float32)
        mask = np.zeros(4, bool)
        mask[:3] = True
        mask[t % 3] = False
        s, top = _step(jsrv, casc, slab, mask, flt)
        ps, ptop = plain.step_batch(slab, mask)
        np.testing.assert_array_equal(s, ps)
        np.testing.assert_array_equal(top, ptop)
    fv = np.round(rng.standard_normal((4, 16)) * 256).astype(np.float32) / 256
    np.testing.assert_array_equal(casc.step_batch(fv, np.ones(4, bool))[0],
                                  plain.step_batch(fv, np.ones(4, bool))[0])
    jsrv.step_batch(fv, np.ones(4, bool))
    slab = (rng.standard_normal((5, 4, 256)) * 0.05).astype(np.float32)
    mask = rng.random((5, 4)) < 0.7
    seq, tops = casc.run_batch(slab, mask)
    pseq, ptops = plain.run_batch(slab, mask)
    np.testing.assert_array_equal(seq, pseq)
    np.testing.assert_array_equal(tops, ptops)
    for t in range(5):  # the reference's live ticks equal its replay
        np.testing.assert_allclose(seq[t], np.asarray(jsrv.step_batch(slab[t], mask[t])[0]),
                                   rtol=0, atol=SCORE_ATOL)
    for a, b in zip(casc.state.leaves()[:-4], plain.state.leaves()):
        assert torch.equal(a, b)
    np.testing.assert_array_equal(casc.wake_rate, np.ones(4, np.float32))
    np.testing.assert_array_equal(plain.wake_rate, np.ones(4, np.float32))
    _assert_same(jsrv, casc, flt)


def test_silence_stream_never_wakes(setup):
    jsrv, tsrv = _pair(setup, "qat", cascade=dict(wake_threshold=0.1))
    for srv in (jsrv, tsrv):
        srv.open_stream(0)
    for _ in range(5):
        jsrv.step({0: SILENCE_FV})
        tsrv.step({0: SILENCE_FV})
    slot = tsrv.active[0]
    np.testing.assert_array_equal(tsrv.scores[slot], np.zeros(12, np.float32))
    for h in tsrv.state.gru:
        assert not h[slot].any()
    assert tsrv.wake_rate[slot] == 0.0
    _assert_same(jsrv, tsrv)


def test_gate_wakes_holds_and_hangs_over(setup):
    jsrv, tsrv = _pair(setup, "qat", cascade=dict(wake_threshold=0.1, hangover_frames=2))
    for srv in (jsrv, tsrv):
        srv.open_stream(0)
    slot = tsrv.active[0]
    for fv in [LOUD_FV] + [SILENCE_FV] * 4:
        _step(jsrv, tsrv, *_slab(tsrv, {0: fv}))
    assert int(tsrv.state.det["woken"][slot]) == 3 and int(tsrv.state.det["ticks"][slot]) == 5
    assert tsrv.wake_rate[slot] == pytest.approx(3 / 5)
    before = [h[slot].clone() for h in tsrv.state.gru]
    s_before = tsrv.scores[slot].copy()
    _step(jsrv, tsrv, *_slab(tsrv, {0: SILENCE_FV}))
    for h, hb in zip(tsrv.state.gru, before):
        assert torch.equal(h[slot], hb)
    np.testing.assert_array_equal(tsrv.scores[slot], s_before)
    _assert_same(jsrv, tsrv)


def _slab(srv, frames):
    return srv._slab(frames)


def test_score_decay_on_gated_ticks(setup):
    jsrv, tsrv = _pair(setup, "qat", cascade=dict(wake_threshold=0.1, score_decay=0.5))
    for srv in (jsrv, tsrv):
        srv.open_stream(0)
    slot = tsrv.active[0]
    _step(jsrv, tsrv, *_slab(tsrv, {0: LOUD_FV}))
    s0 = tsrv.scores[slot].copy()
    _step(jsrv, tsrv, *_slab(tsrv, {0: SILENCE_FV}))
    np.testing.assert_array_equal(tsrv.scores[slot], s0 * np.float32(0.5))
    _step(jsrv, tsrv, *_slab(tsrv, {0: SILENCE_FV}))
    np.testing.assert_array_equal(tsrv.scores[slot], s0 * np.float32(0.25))
    _assert_same(jsrv, tsrv)


def test_wake_telemetry_idle_freeze_and_slot_reset(setup):
    jsrv, tsrv = _pair(setup, "qat", cascade=dict(wake_threshold=0.1))
    for srv in (jsrv, tsrv):
        srv.open_stream(0)
        srv.open_stream(1)
    slot1 = tsrv.active[1]
    for frames in (_frames(LOUD_FV, LOUD_FV), _frames(SILENCE_FV, SILENCE_FV)):
        _step(jsrv, tsrv, *_slab(tsrv, frames))
    wr = tsrv.wake_rate[slot1]
    assert wr == pytest.approx(0.5)
    for fv in (LOUD_FV, SILENCE_FV, LOUD_FV):  # stream 1 idles
        _step(jsrv, tsrv, *_slab(tsrv, {0: fv}))
    assert tsrv.wake_rate[slot1] == wr
    _assert_same(jsrv, tsrv)
    for srv in (jsrv, tsrv):
        srv.close_stream(1)
        srv.open_stream(99)
    assert tsrv.active[99] == slot1
    for key, leaf in tsrv.state.det.items():
        assert leaf[slot1] == 0 and leaf.dtype == (torch.bool if key == "awake" else torch.int32)
    assert tsrv.wake_rate[slot1] == 1.0
    _assert_same(jsrv, tsrv)


def test_scan_replay_matches_live_ticks(setup):
    kw = dict(wake_threshold=0.1, hangover_frames=1)
    jsrv, live = _pair(setup, "qat", cascade=kw)
    _, scan = _pair(setup, "qat", cascade=kw)
    for srv in (jsrv, live, scan):
        for sid in range(3):
            srv.open_stream(sid)
    rng = np.random.default_rng(21)
    slab = np.where(rng.random((6, 4, 1)) < 0.4, LOUD_FV, SILENCE_FV).astype(np.float32)
    mask = rng.random((6, 4)) < 0.7
    for t in range(6):
        live.step_batch(slab[t], mask[t])
    scan.run_batch(slab, mask)
    jsrv.run_batch(slab, mask)
    np.testing.assert_array_equal(live.scores, scan.scores)
    for key in live.state.det:
        assert torch.equal(live.state.det[key], scan.state.det[key])
    np.testing.assert_array_equal(live.wake_rate, scan.wake_rate)
    _assert_same(jsrv, scan)


def test_cascade_composes_with_delta(setup):
    jsrv, tsrv = _pair(setup, "delta", cascade=dict(wake_threshold=0.1), theta=0.25)
    for srv in (jsrv, tsrv):
        srv.open_stream(0)
    slot = tsrv.active[0]
    _step(jsrv, tsrv, *_slab(tsrv, {0: LOUD_FV}))
    totals = [int(st["total"][slot]) for st in tsrv.state.gru]
    assert all(t > 0 for t in totals)
    sparsity = tsrv.sparsity[slot]
    for _ in range(3):
        _step(jsrv, tsrv, *_slab(tsrv, {0: SILENCE_FV}))
    assert [int(st["total"][slot]) for st in tsrv.state.gru] == totals
    assert tsrv.sparsity[slot] == sparsity
    assert tsrv.wake_rate[slot] == pytest.approx(1 / 4)
    _assert_same(jsrv, tsrv)


def _linear_kw(rng):
    return dict(detector="linear", wake_threshold=0.5, hangover_frames=3,
                linear_w=tuple(rng.standard_normal(16) * 0.5), linear_b=-0.2)


@pytest.mark.parametrize("frontend", ["software", "hardware"])
@pytest.mark.parametrize("detector", ["energy", "linear"])
@pytest.mark.parametrize("classifier", ["qat", "delta-int"])
def test_gated_raw_audio_servers(setup, die, frontend, detector, classifier):
    """Energy at 0.15 and linear at 0.5 (hangover 3) on raw-audio hops of
    quiet and loud streams with partial masks and an idle tick, then a
    replay: every tick and the whole state against the reference."""
    rng = np.random.default_rng(30)
    kw = dict(wake_threshold=0.15) if detector == "energy" else _linear_kw(rng)
    jsrv, tsrv = _pair(setup, classifier, cascade=kw, theta=0.15, max_streams=7,
                       frontend=frontend, die=die)
    for srv in (jsrv, tsrv):
        for sid in range(6):
            srv.open_stream(sid)
    gains = np.asarray([0.001, 0.002, 0.01, 0.05, 0.2, 0.5, 0.01], np.float32)[:, None]
    for t in range(6):
        slab = (rng.standard_normal((7, 256)) * gains).astype(np.float32)
        mask = rng.random(7) < (0.0 if t == 4 else 0.8)
        _step(jsrv, tsrv, slab, mask)
    slab = (rng.standard_normal((2, 7, 256)) * gains).astype(np.float32)
    mask = rng.random((2, 7)) < 0.8
    tseq, ttops = tsrv.run_batch(slab, mask)
    for t in range(2):  # the reference's live ticks equal its replay
        js, jt = jsrv.step_batch(slab[t], mask[t])
        np.testing.assert_allclose(tseq[t], np.asarray(js), rtol=0, atol=SCORE_ATOL)
        np.testing.assert_array_equal(ttops[t], np.asarray(jt))
    for key in ("s1", "s2"):
        np.testing.assert_array_equal(tsrv.state.carry[key].numpy(),
                                      np.asarray(jsrv.state.carry[key]))
    _assert_same(jsrv, tsrv)
    woken = tsrv.state.det["woken"].numpy()[:6]
    ticks = tsrv.state.det["ticks"].numpy()[:6]
    assert (woken < ticks).any() and woken.any()  # the gate really gated


def test_server_starts_mid_stream_from_a_reference_detector_state(setup):
    kw = dict(wake_threshold=0.1, hangover_frames=2)
    jsrv, tsrv = _pair(setup, "qat", cascade=kw)
    jsrv.open_stream(0)
    for fv in (LOUD_FV, SILENCE_FV):
        jsrv.step({0: fv})
    tsrv.open_stream(0)
    det = convert.cascade_state_from_numpy(
        {k: np.asarray(v) for k, v in jsrv.state.det.items()}, "cpu")
    tsrv.state = dataclasses.replace(
        tsrv.state, det=det, scores=torch.from_numpy(np.array(jsrv.state.scores)),
        gru=tuple(torch.from_numpy(np.array(h)) for h in jsrv.state.gru))
    for fv in (SILENCE_FV, SILENCE_FV, LOUD_FV):
        _step(jsrv, tsrv, *_slab(tsrv, {0: fv}))
    _assert_same(jsrv, tsrv)
    with pytest.raises(ValueError, match="must be int32"):
        convert.cascade_state_from_numpy(
            {"awake": np.zeros(2, bool), "hang": np.zeros(2, np.int64),
             "woken": np.zeros(2, np.int32), "ticks": np.zeros(2, np.int32)}, "cpu")


def test_frontend_state_kinds_are_unchanged_by_the_cascade(setup):
    """A cascaded pipeline's frontend state and carry are the ungated
    pipeline's (the cascade touches only the serving tick)."""
    pipe = KWSPipeline(KWSPipelineConfig(cascade=tc.CascadeConfig(wake_threshold=0.2)),
                       norm_stats=setup[2])
    assert isinstance(pipe.state, FrontendState)
    assert set(pipe.streaming_features_init(2, "cpu")) == {"s1", "s2"}


if __name__ == "__main__":
    # The map behind F5 and F11: for each width and row count, how many of
    # 20 seeded (w, b) give a dL/dw, and a dL/db, of `_fit_grad` unequal to
    # the reference's compiled gradient.
    for c in (1, 2, 3, 5, 7, 8, 9, 12, 16, 17, 20, 24, 25, 26, 33):
        print(f"C={c}", {n: _fit_grad_mismatches(n, c, draws=20)
                         for n in (1, 2, 3, 6, 8, 14, 16, 24, 32, 34, 48, 96, 104, 600, 602)})
