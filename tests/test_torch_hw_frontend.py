"""The port's hardware frontends and batch feature path against the
reference.

- `KWSPipeline.features` / `record_features` for "software", "hardware"
  and "hardware-pallas" (the reference's TDC kernel through its own
  interpret tier), on a die drawn with ``jax.random`` and carried across
  by `convert.frontend_state_from_numpy`: FV_Raw and FV_Norm array-equal.
- The hardware streaming step, one hop at a time from equal states:
  codes and the carry {s1, s2, r, j} array-equal (the frame sum runs in
  the reference's compiled order, blocks of 32 samples).
- Hardware servers (qat, delta-int) against the reference's
  ``tick_impl="xla"`` server: partial masks, an idle tick, slot reuse and
  `run_batch`; state and `top` array-equal, scores within 1e-6 (R1).
- Keyed noise by its statistics (W4).
"""

import jax
import jax._src.core as jax_core_internal
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro.core.fex import fit_norm_stats
from repro.core.frontend import FrontendState as JState
from repro.core.frontend import get_frontend as j_get_frontend
from repro.core.frontend import hardware_state as j_hardware_state
from repro.core.gru_delta import DeltaConfig as JDelta
from repro.core.pipeline import KWSPipeline as JPipeline
from repro.core.pipeline import KWSPipelineConfig as JConfig
from repro.core.tdfex import TDFExConfig as JTDFExConfig
from repro.core.tdfex import draw_chip as j_draw_chip
from repro.serving.serve_loop import StreamingKWSServer as JServer
from repro_torch import convert
from repro_torch.core.fex import FExConfig
from repro_torch.core.frontend import (
    FrontendState,
    _nominal_coeffs,
    get_frontend,
    hardware_state,
)
from repro_torch.core.gru_delta import DeltaConfig
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.core.tdfex import TDFExConfig, TDFExState
from repro_torch.serving.serve_loop import StreamingKWSServer

FRONTENDS = ("software", "hardware", "hardware-pallas")
SCORE_ATOL = 1e-6
HOP = 256


@pytest.fixture
def interpret_tier(monkeypatch):
    """The reference's kernel dispatch (`repro.kernels.dispatch`) reads
    ``jax.core.trace_state_clean``, which newer jax keeps only in
    ``jax._src.core``; put it back so the reference's "hardware-pallas"
    frontend runs its TDC kernel through its own interpret tier."""
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(
            jax.core, "trace_state_clean", jax_core_internal.trace_state_clean, raising=False
        )


@pytest.fixture(scope="module")
def die():
    """A reference die (jax.random, seed 3) with calibration-like beta /
    alpha and fitted norm stats, as the reference's state and as the
    port's, carried across through numpy."""
    jcfg = JConfig(frontend="hardware")
    tdcfg = jcfg.tdfex_config
    chip = j_draw_chip(jax.random.PRNGKey(3), tdcfg)
    rng = np.random.default_rng(0)
    beta = (tdcfg.beta_nominal + 3 * rng.standard_normal(16)).astype(np.float32)
    alpha = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    audio = jnp.asarray(rng.standard_normal((4, 8000)).astype(np.float32) * 0.05)
    _, raw = JPipeline(JConfig(use_norm=False)).features(audio)
    stats = fit_norm_stats(jq.log_compress_lut(raw, 12, 10))
    jstate = j_hardware_state(tdcfg, chip, jnp.asarray(beta), jnp.asarray(alpha), stats)
    tstate = convert.frontend_state_from_numpy(
        "cpu", gain_mismatch=np.asarray(chip.gain_mismatch),
        cf_mismatch=np.asarray(chip.cf_mismatch), beta=beta, alpha=alpha,
        coeffs=np.asarray(jstate.coeffs), mu=np.asarray(stats.mu), sigma=np.asarray(stats.sigma),
    )
    return jstate, tstate


def _states(die, frontend):
    jstate, tstate = die
    if frontend == "software":
        return (JState(norm_stats=jstate.norm_stats), FrontendState(norm_stats=tstate.norm_stats))
    return jstate, tstate


def _clips(seed, b, samples):
    rng = np.random.default_rng(seed)
    gains = np.logspace(-2, -0.3, b).astype(np.float32)[:, None]
    t = np.arange(samples) / 16000.0
    tones = np.sin(2 * np.pi * rng.uniform(200, 6000, (b, 1)) * t)
    return ((0.7 * tones + 0.3 * rng.standard_normal((b, samples))) * gains).astype(np.float32)


# ---------------- batch features ----------------

@pytest.mark.parametrize("frontend", FRONTENDS)
def test_features_match_reference(interpret_tier, die, frontend):
    jstate, tstate = _states(die, frontend)
    audio = _clips(1, 3, 4000)  # 0.25 s clips
    jfv, jraw = JPipeline(JConfig(frontend=frontend)).features(jnp.asarray(audio), jstate)
    tfv, traw = KWSPipeline(KWSPipelineConfig(frontend=frontend)).features(
        torch.from_numpy(audio), tstate)
    assert traw.shape == tfv.shape == (3, 15, 16)
    np.testing.assert_array_equal(traw.numpy(), np.asarray(jraw))
    np.testing.assert_array_equal(tfv.numpy(), np.asarray(jfv))
    assert len(np.unique(traw.numpy())) > 100  # a real spread of codes


@pytest.mark.parametrize("frontend", FRONTENDS)
def test_record_features_matches_reference(interpret_tier, die, frontend):
    jstate, tstate = _states(die, frontend)
    audio = _clips(2, 5, 1600)  # 0.1 s clips, batches of 2, 2 and 1
    want = JPipeline(JConfig(frontend=frontend)).record_features(audio, jstate, batch_size=2)
    got = KWSPipeline(KWSPipelineConfig(frontend=frontend), state=tstate).record_features(
        audio, batch_size=2, device="cpu")
    assert isinstance(got, np.ndarray) and got.shape == (5, 6, 16)
    np.testing.assert_array_equal(got, want)


def test_hardware_pallas_agrees_with_hardware_within_the_references_2_lsb(die):
    _, tstate = die
    audio = torch.from_numpy(_clips(3, 4, 3200))
    raws = {f: KWSPipeline(KWSPipelineConfig(frontend=f)).features(audio, tstate)[1]
            for f in ("hardware", "hardware-pallas")}
    assert float((raws["hardware"] - raws["hardware-pallas"]).abs().max()) <= 2.0


def test_frontend_state_from_numpy_carries_a_reference_die(die):
    """The designed coeffs a reference die brings equal the port's own
    design for the same mismatch, and the carried state is complete."""
    jstate, tstate = die
    assert torch.equal(tstate.coeffs, hardware_state(TDFExConfig(), tstate.chip).coeffs)
    for a, b in ((tstate.beta, jstate.beta), (tstate.alpha, jstate.alpha),
                 (tstate.chip.gain_mismatch, jstate.chip.gain_mismatch),
                 (tstate.norm_stats.mu, jstate.norm_stats.mu)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError, match="both gain_mismatch and cf_mismatch"):
        convert.frontend_state_from_numpy("cpu", gain_mismatch=np.zeros(16))
    bare = convert.frontend_state_from_numpy("cpu")
    assert bare == FrontendState()


def test_hardware_state_without_a_chip_defaults_to_the_card(die):
    """No chip and no device means the card, as at every entry point of
    the port: it raises where there is none rather than building the state
    on the CPU. A named device, or the chip's, is followed."""
    if torch.cuda.is_available():
        assert hardware_state(TDFExConfig()).coeffs.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            hardware_state(TDFExConfig())
    state = hardware_state(TDFExConfig(), device="cpu")
    assert state.chip is None
    assert all(t.device.type == "cpu" for t in (state.beta, state.alpha, state.coeffs))
    _, tstate = die
    assert hardware_state(TDFExConfig(), tstate.chip).coeffs.device.type == "cpu"


def test_init_frontend_state_draws_and_calibrates_a_die():
    pipe = KWSPipeline(KWSPipelineConfig(frontend="hardware"))
    state = pipe.init_frontend_state(torch.Generator().manual_seed(0), device="cpu")
    assert state.chip is not None and state.chip.gain_mismatch.shape == (16,)
    assert state.beta.shape == state.alpha.shape == (16,) and state.coeffs.shape == (5, 16)
    assert abs(float(state.alpha.mean()) - 1.0) < 1e-5
    ideal = pipe.init_frontend_state(mismatch=False, device="cpu")
    assert ideal.chip is None
    np.testing.assert_array_equal(ideal.coeffs.numpy(), FExConfig().filterbank().stacked(device="cpu").numpy())
    raw = pipe.init_frontend_state(calibrate=False, device="cpu")
    assert torch.equal(raw.beta, torch.full((16,), TDFExConfig().beta_nominal))
    assert torch.equal(raw.alpha, torch.ones(16))
    soft = KWSPipeline(KWSPipelineConfig()).init_frontend_state(device="cpu")
    assert soft == FrontendState()
    bound = pipe.with_state(state)
    assert bound.state is state and bound.config is pipe.config


def test_nominal_coeffs_refuses_a_chip_without_coeffs():
    chip = TDFExState(torch.zeros(16), torch.zeros(16))
    with pytest.raises(ValueError, match="no designed coeffs"):
        _nominal_coeffs(KWSPipelineConfig(), FrontendState(chip=chip), "cpu")
    with pytest.raises(ValueError, match="disagree"):
        KWSPipelineConfig(fex=FExConfig(q=2.5), tdfex=TDFExConfig())
    cfg = KWSPipelineConfig(fex=FExConfig(q=2.5))
    assert cfg.tdfex_config == TDFExConfig(fex=FExConfig(q=2.5))


# ---------------- streaming ----------------

@pytest.mark.parametrize("frontend", ["hardware", "hardware-pallas"])
def test_hardware_streaming_step_matches_one_hop_at_a_time(die, frontend):
    """16 hops from the reference's state each time, so a difference
    would show where it arises instead of cascading."""
    jstate, tstate = die
    jcfg, tcfg = JConfig(frontend=frontend), KWSPipelineConfig(frontend=frontend)
    jfe, tfe = j_get_frontend(frontend), get_frontend(frontend)
    step = jax.jit(lambda ch, c: jfe.streaming_step(ch, jcfg, jstate, c))
    n = 6
    carry = jfe.streaming_init(jcfg, n)
    tcarry = tfe.streaming_init(tcfg, n, "cpu")
    assert sorted(tcarry) == ["j", "r", "s1", "s2"]
    rng = np.random.default_rng(5)
    gains = np.logspace(-2, -0.3, n).astype(np.float32)[:, None]
    codes = []
    for _ in range(16):
        hop = (rng.standard_normal((n, HOP)) * gains).astype(np.float32)
        from_ref = {k: torch.from_numpy(np.array(v)) for k, v in carry.items()}
        new, jcodes = step(jnp.asarray(hop), carry)
        tnew, tcodes = tfe.streaming_step(torch.from_numpy(hop), tcfg, tstate, from_ref)
        np.testing.assert_array_equal(tcodes.numpy(), np.asarray(jcodes))
        for k in ("s1", "s2", "r", "j"):
            np.testing.assert_array_equal(tnew[k].numpy(), np.asarray(new[k]))
        carry = new
        codes.append(tcodes.numpy())
    assert len(np.unique(codes)) > 50


def test_streaming_features_step_matches_over_8_hops(die):
    jstate, tstate = die
    jpipe = JPipeline(JConfig(frontend="hardware"), state=jstate)
    tpipe = KWSPipeline(KWSPipelineConfig(frontend="hardware"), state=tstate)
    jcarry, tcarry = jpipe.streaming_features_init(4), tpipe.streaming_features_init(4, "cpu")
    rng = np.random.default_rng(6)
    for _ in range(8):
        hop = (rng.standard_normal((4, HOP)) * 0.1).astype(np.float32)
        jcarry, jfv = jpipe.streaming_features_step(jcarry, jnp.asarray(hop))
        tcarry, tfv = tpipe.streaming_features_step(tcarry, torch.from_numpy(hop))
        np.testing.assert_array_equal(tfv.numpy(), np.asarray(jfv))


# ---------------- servers ----------------

@pytest.fixture(scope="module")
def params():
    return JPipeline(JConfig()).init_params(jax.random.PRNGKey(7))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(die, params, classifier, max_streams, frontend="hardware"):
    jstate, tstate = die
    jd = td = None
    if classifier.startswith("delta"):
        jd, td = JDelta(0.15, 0.15), DeltaConfig(0.15, 0.15)
    jsrv = JServer(JPipeline(JConfig(frontend=frontend, classifier=classifier, delta=jd),
                             state=jstate),
                   params, max_streams=max_streams, tick_impl="xla")
    tsrv = StreamingKWSServer(
        KWSPipeline(KWSPipelineConfig(frontend=frontend, classifier=classifier, delta=td),
                    state=tstate),
        convert.params_from_numpy(_np(params), "cpu"), max_streams=max_streams, device="cpu")
    return jsrv, tsrv


def _assert_server_equal(jsrv, tsrv):
    t_leaves = jax.tree_util.tree_leaves(
        (list(tsrv.state.gru), tsrv.state.carry), is_leaf=torch.is_tensor)
    j_leaves = jax.tree_util.tree_leaves((list(jsrv.state.gru), jsrv.state.carry))
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    np.testing.assert_allclose(tsrv.scores, jsrv.scores, rtol=0, atol=SCORE_ATOL)


def _assert_tick_equal(j_out, t_out):
    np.testing.assert_allclose(t_out[0], j_out[0], rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(t_out[1], np.asarray(j_out[1]))


@pytest.mark.parametrize("classifier", ["qat", "delta-int"])
def test_hardware_server_live_ticks_partial_masks_and_idle(die, params, classifier):
    jsrv, tsrv = _pair(die, params, classifier, max_streams=7)
    for srv in (jsrv, tsrv):
        for sid in range(5):
            srv.open_stream(sid)
    assert sorted(tsrv.state.carry) == ["j", "r", "s1", "s2"]
    rng = np.random.default_rng(1)
    for t in range(5):
        slab = (rng.standard_normal((7, HOP)) * 0.05 * (1 + t)).astype(np.float32)
        mask = np.array([(t + s) % 3 != 0 for s in range(7)])
        _assert_tick_equal(jsrv.step_batch(slab, mask), tsrv.step_batch(slab, mask))
        _assert_server_equal(jsrv, tsrv)
    idle = np.zeros((7, HOP), np.float32), np.zeros(7, bool)
    before = {k: v.clone() for k, v in tsrv.state.carry.items()}
    _assert_tick_equal(jsrv.step_batch(*idle), tsrv.step_batch(*idle))
    for k, v in tsrv.state.carry.items():
        assert torch.equal(v, before[k])
    _assert_server_equal(jsrv, tsrv)


@pytest.mark.parametrize("classifier", ["qat", "delta-int"])
def test_hardware_server_slot_reuse_and_run_batch(die, params, classifier):
    jsrv, tsrv = _pair(die, params, classifier, max_streams=5, frontend="hardware-pallas")
    rng = np.random.default_rng(2)
    for srv in (jsrv, tsrv):
        for sid in (10, 11, 12):
            srv.open_stream(sid)
    slab = (rng.standard_normal((6, 5, HOP)) * 0.08).astype(np.float32)
    mask = rng.random((6, 5)) < 0.75
    mask[3] = False
    j_scores, j_tops = jsrv.run_batch(slab, mask)
    t_scores, t_tops = tsrv.run_batch(slab, mask)
    np.testing.assert_allclose(t_scores, np.asarray(j_scores), rtol=0, atol=SCORE_ATOL)
    np.testing.assert_array_equal(t_tops, np.asarray(j_tops))
    _assert_server_equal(jsrv, tsrv)
    for srv in (jsrv, tsrv):
        srv.close_stream(11)
        srv.open_stream(42)  # reuses slot 1, zeroed
    assert tsrv.active[42] == jsrv.active[42] == 1
    assert all(not v[1].any() for v in tsrv.state.carry.values())
    frames = {sid: (rng.standard_normal(HOP) * 0.1).astype(np.float32) for sid in (10, 42)}
    j_out, t_out = jsrv.step(frames), tsrv.step(frames)
    for sid in frames:
        assert t_out[sid]["top"] == j_out[sid]["top"]
    _assert_server_equal(jsrv, tsrv)


# ---------------- keyed noise, by its statistics (W4) ----------------

def test_keyed_streaming_noise_statistics(die):
    _, tstate = die
    cfg = KWSPipelineConfig(frontend="hardware", tdfex=TDFExConfig(phase_noise_rms=0.05))
    fe = get_frontend("hardware")
    hop = torch.zeros((64, HOP))
    carry = fe.streaming_init(cfg, 64, "cpu")
    clean, _ = fe.streaming_step(hop, cfg, tstate, carry)
    noisy, _ = fe.streaming_step(hop, cfg, tstate, carry, generator=torch.Generator().manual_seed(4))
    j = noisy["j"].numpy()
    assert abs(j.std() / (15 * 0.05) - 1) < 0.05 and abs(j.mean()) < 0.05
    assert not torch.equal(noisy["s1"], clean["s1"])  # the VTC's input noise
    # batch: the codes' noise against the noiseless codes, port against
    # reference (same die, same clips, each with its own noise source)
    jstate, _ = die
    audio = _clips(7, 8, 1600)
    jpipe = JPipeline(JConfig(frontend="hardware", tdfex=JTDFExConfig(phase_noise_rms=0.05)))
    jd = (np.asarray(jpipe.features(jnp.asarray(audio), jstate, key=jax.random.PRNGKey(5))[1])
          - np.asarray(jpipe.features(jnp.asarray(audio), jstate)[1]))
    pipe = KWSPipeline(cfg)
    _, quiet = pipe.features(torch.from_numpy(audio), tstate)
    _, noisy = pipe.features(torch.from_numpy(audio), tstate, generator=torch.Generator().manual_seed(5))
    td = (noisy - quiet).numpy()
    assert np.abs(td).max() <= 3 and np.abs(jd).max() <= 3
    assert abs(td.std() / jd.std() - 1) < 0.3 and abs(td.mean() - jd.mean()) < 0.1
