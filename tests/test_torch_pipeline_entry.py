"""The pipeline's remaining entry points and the IC's energy model: the
port against the reference.

`KWSPipeline.logits_all_frames` is array-equal on every frame for qat,
integer, delta and delta-int, and the float backend within F1's 2e-6;
`predict` gives the same class wherever the reference's two best logits
are more than twice that apart; `norm_stats`, `core.gru.classifier_macs`
/ `classifier_param_bytes` (24 204 weights at the paper's config), every
figure of `core.energy`, `BiquadCoeffs.as_arrays` and
`biquad_frequency_response` equal the reference's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import energy as je
from repro.core import filters as jf
from repro.core import gru as jgru
from repro.core import quant as jq
from repro.core.fex import fit_norm_stats
from repro.core.gru_delta import DeltaConfig as JDelta
from repro.core.pipeline import KWSPipeline as JPipeline
from repro.core.pipeline import KWSPipelineConfig as JConfig
from repro_torch import convert
from repro_torch.core import energy as te
from repro_torch.core import filters as tf
from repro_torch.core import gru as tgru
from repro_torch.core.gru_delta import DeltaConfig
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig

FLOAT_ATOL = 2e-6  # F1
THETA = 0.15
CLASSIFIERS = ("float", "qat", "integer", "delta", "delta-int")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((4, 8000)).astype(np.float32) * 0.05)
    _, raw = JPipeline(JConfig(use_norm=False)).features(audio)
    stats = fit_norm_stats(jq.log_compress_lut(raw, 12, 10))
    params = JPipeline(JConfig()).init_params(jax.random.PRNGKey(11))
    tstats = convert.norm_stats_from_numpy(np.asarray(stats.mu), np.asarray(stats.sigma), "cpu")
    tparams = convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, params), "cpu")
    clips = (rng.standard_normal((3, 2560)) * np.array([[0.02], [0.1], [0.4]])).astype(np.float32)
    fv, _ = JPipeline(JConfig(), norm_stats=stats).features(jnp.asarray(clips))
    return stats, params, tstats, tparams, clips, fv


def test_features_frames(setup):
    assert setup[5].shape == (3, 10, 16)


def _pipes(setup, classifier):
    stats, _, tstats = setup[:3]
    delta = THETA if classifier.startswith("delta") else None
    jd = None if delta is None else JDelta(delta, delta)
    td = None if delta is None else DeltaConfig(delta, delta)
    return (JPipeline(JConfig(classifier=classifier, delta=jd), norm_stats=stats),
            KWSPipeline(KWSPipelineConfig(classifier=classifier, delta=td), norm_stats=tstats))


@pytest.mark.parametrize("classifier", CLASSIFIERS)
def test_logits_all_frames(setup, classifier):
    _, params, _, tparams, _, fv = setup
    jp, tp = _pipes(setup, classifier)
    want = np.asarray(jp.logits_all_frames(params, fv))
    got = tp.logits_all_frames(tparams, torch.from_numpy(np.array(fv)))
    assert got.shape == want.shape == (3, fv.shape[1], 12)
    if classifier == "float":
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_ATOL)
    else:
        np.testing.assert_array_equal(got.numpy(), want)
    # `logits` is the final frame of the same forward
    np.testing.assert_array_equal(
        tp.logits(tparams, torch.from_numpy(np.array(fv))).numpy(), got[:, -1].numpy())


@pytest.mark.parametrize("classifier", CLASSIFIERS)
def test_predict(setup, classifier):
    _, params, _, tparams, clips, fv = setup
    jp, tp = _pipes(setup, classifier)
    want = np.asarray(jp.predict(params, jnp.asarray(clips)))
    got = tp.predict(tparams, torch.from_numpy(clips))
    assert got.dtype == torch.int64 and got.shape == (3,)
    best2 = np.sort(np.asarray(jp.logits(params, fv)), axis=-1)[:, -2:]
    clear = best2[:, 1] - best2[:, 0] > 2 * FLOAT_ATOL
    assert clear.any()
    np.testing.assert_array_equal(got.numpy()[clear], want[clear])


def test_norm_stats_property(setup):
    tstats = setup[2]
    jp, tp = _pipes(setup, "qat")
    assert tp.norm_stats is tstats
    np.testing.assert_array_equal(tp.norm_stats.mu.numpy(), np.asarray(jp.norm_stats.mu))
    np.testing.assert_array_equal(tp.norm_stats.sigma.numpy(), np.asarray(jp.norm_stats.sigma))
    assert KWSPipeline(KWSPipelineConfig()).norm_stats is None


CONFIGS = ({}, dict(hidden_dim=32), dict(num_layers=3, num_classes=10),
           dict(input_dim=20, hidden_dim=64, num_layers=1))


@pytest.mark.parametrize("kw", CONFIGS)
def test_classifier_counts(kw):
    jc, tc = jgru.GRUConfig(**kw), tgru.GRUConfig(**kw)
    assert tgru.classifier_macs(tc) == jgru.classifier_macs(jc)
    for bits in (8, 16, 32):
        assert tgru.classifier_param_bytes(tc, bits) == jgru.classifier_param_bytes(jc, bits)
    if not kw:
        assert tgru.classifier_macs(tc) == 24204  # the paper's weight count
        assert tgru.classifier_param_bytes(tc) == 24204


def _energy_figures(mod, gru_mod, cfg, **accel):
    acc = mod.AcceleratorModel(**accel)
    power = mod.ICPowerModel(accel=acc)
    return (acc.effective_macs(cfg), acc.cycles_per_frame(cfg), acc.latency_s(cfg),
            acc.utilization(cfg), power.accelerator_power_w(cfg), power.fex_power_w(),
            power.fex_power_w(8), power.total_power_w(cfg), power.total_power_w(cfg, 8, 32e-3))


@pytest.mark.parametrize("accel", ({}, dict(effective_mac_fraction=0.1),
                                   dict(duty_cycle=0.25, effective_mac_fraction=0.5),
                                   dict(n_hpe=4, f_clk_hz=500e3)))
@pytest.mark.parametrize("kw", CONFIGS[:2])
def test_energy_model(accel, kw):
    got = _energy_figures(te, tgru, tgru.GRUConfig(**kw), **accel)
    want = _energy_figures(je, jgru, jgru.GRUConfig(**kw), **accel)
    assert got == want
    assert dataclasses.asdict(te.paper_power_model()) == dataclasses.asdict(je.paper_power_model())
    assert te.paper_accelerator() == te.AcceleratorModel()
    if not kw and not accel:
        assert round(te.paper_accelerator().latency_s(tgru.GRUConfig()) * 1e3, 1) == 12.4


def test_energy_model_validation():
    for bad in (dict(effective_mac_fraction=1.5), dict(duty_cycle=-0.1)):
        with pytest.raises(ValueError):
            te.AcceleratorModel(**bad)
        with pytest.raises(ValueError):
            je.AcceleratorModel(**bad)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_biquad_as_arrays_and_frequency_response(dtype):
    jc, tc = jf.design_filterbank(), tf.design_filterbank()
    # jax without x64 holds float32 only: float64 is held to the design's
    # own numpy arrays
    want_rows = (jc.as_arrays() if dtype == torch.float32
                 else (jc.b0, jc.b1, jc.b2, jc.a1, jc.a2))
    for got, want in zip(tc.as_arrays(dtype, device="cpu"), want_rows, strict=True):
        assert got.dtype == dtype and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    stacked = tc.stacked(dtype, device="cpu")
    for k, row in enumerate(tc.as_arrays(dtype, device="cpu")):
        assert torch.equal(stacked[k], row)
    freqs = np.linspace(10.0, 15990.0, 97)
    np.testing.assert_array_equal(
        tf.biquad_frequency_response(tc, freqs), jf.biquad_frequency_response(jc, freqs))
    single = tf.design_bandpass_biquad([1000.0, 3000.0], fs=16000.0, q=1.5)
    np.testing.assert_array_equal(
        tf.biquad_frequency_response(single, freqs),
        jf.biquad_frequency_response(jf.design_bandpass_biquad([1000.0, 3000.0], 16000.0, 1.5),
                                     freqs))


@pytest.mark.parametrize("method", ["as_arrays", "stacked"])
def test_biquad_tensors_default_to_the_card(method, monkeypatch):
    """F9: ``device=None`` resolves through `kernels.build.resolve_device`
    (the card), as every entry point of the port does, and raises where
    there is no card."""
    from repro_torch.kernels import build

    coeffs = tf.design_filterbank()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(coeffs, method)()
    asked = []
    monkeypatch.setattr(build, "resolve_device",
                        lambda d=None: asked.append(d) or torch.device("meta"))
    out = getattr(coeffs, method)()
    for t in (out if method == "as_arrays" else (out,)):
        assert t.device.type == "meta"
    assert asked == [None]
