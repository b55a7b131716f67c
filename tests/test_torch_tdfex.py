"""The port's time-domain FEx (tdfex), its TDC and filterbank kernels'
plain versions, and the calibration, against the reference.

Held against the reference's compiled (XLA, CPU) graph: the VTC, the
mismatched filterbank design, `counts_to_fv_raw`, `sro_tdc` (its
cumulative phase in the blocked order of XLA's reduce-window rewrite),
the plain TDC (against the reference's own interpret tier, as
tests/test_kernels.py runs it) and the plain `fex_fused` are
array-equal; the plain TDC is within 1 count of the float64 oracle.
beta / alpha from a die drawn with ``jax.random`` are array-equal to
the reference's bench calibration. Keyed noise is held by its
statistics (ROADMAP W4).
"""

import jax
import jax._src.core as jax_core_internal
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as jcal
from repro.core import quant as jq
from repro.core import tdfex as jtd
from repro.core.filters import design_filterbank as j_design_filterbank
from repro.kernels.fex_fused.kernel import fex_fused_pallas
from repro.kernels.fex_fused.ref import fex_fused_ref as j_fex_fused_ref
from repro.kernels.tdc import tdc_counts as j_tdc_counts
from repro.kernels.tdc import tdc_counts_ref as j_tdc_counts_ref
from repro_torch.core import calibration as tcal
from repro_torch.core import quant as tq
from repro_torch.core import tdfex as ttd
from repro_torch.core.fex import biquad_filterbank_streaming
from repro_torch.core.filters import design_filterbank
from repro_torch.kernels.fex_fused import biquad_stream, fex_fused, fex_fused_ref
from repro_torch.kernels.tdc import tdc_counts, tdc_counts_plain, tdc_counts_ref
from repro_torch.kernels.tdc.ops import tdc_scale

JCFG, TCFG = jtd.TDFExConfig(), ttd.TDFExConfig()
SPF = TCFG.decimation // TCFG.tdc_oversample  # 512 samples a frame


@pytest.fixture
def interpret_tier(monkeypatch):
    """The reference's kernel dispatch (`repro.kernels.dispatch`) reads
    ``jax.core.trace_state_clean``, which newer jax keeps only in
    ``jax._src.core``; put it back for the test so the reference's own
    interpret tier runs."""
    if not hasattr(jax.core, "trace_state_clean"):
        monkeypatch.setattr(
            jax.core, "trace_state_clean", jax_core_internal.trace_state_clean, raising=False
        )


def _chip_pair(seed):
    """A die drawn by the reference with jax.random, and the port's copy."""
    jchip = jtd.draw_chip(jax.random.PRNGKey(seed), JCFG)
    tchip = ttd.TDFExState(
        gain_mismatch=torch.from_numpy(np.array(jchip.gain_mismatch)),
        cf_mismatch=torch.from_numpy(np.array(jchip.cf_mismatch)),
    )
    return jchip, tchip


def _rect(seed, b, t, c=16, scale=0.2):
    return (np.abs(np.random.default_rng(seed).standard_normal((b, t, c))) * scale).astype(np.float32)


# ---------------- VTC, filterbank design, code scale ----------------

@pytest.mark.parametrize("hd3_db", [-70.0, -60.0], ids=["hd3=hd2", "hd3!=hd2"])
def test_vtc_matches(hd3_db):
    jcfg, tcfg = jtd.TDFExConfig(vtc_hd3_db=hd3_db), ttd.TDFExConfig(vtc_hd3_db=hd3_db)
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 4096)) * np.logspace(-2, -0.3, 6)[:, None]).astype(np.float32)
    for audio_rate in (True, False):
        want = jax.jit(lambda a: jtd.vtc(a, jcfg, audio_rate=audio_rate))(jnp.asarray(x))
        got = ttd.vtc(torch.from_numpy(x), tcfg, audio_rate=audio_rate)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed", [0, 7])
def test_mismatched_filterbank_design_matches(seed):
    jchip, tchip = _chip_pair(seed)
    j = np.asarray(jtd.design_mismatched_filterbank(JCFG, jchip).stacked(dtype=jnp.float32))
    t = ttd.design_mismatched_filterbank(TCFG, tchip).stacked(device="cpu").numpy()
    np.testing.assert_array_equal(t, j)
    nominal = ttd.design_mismatched_filterbank(TCFG, None).stacked(device="cpu").numpy()
    np.testing.assert_array_equal(nominal, np.asarray(JCFG.fex.filterbank().stacked(dtype=jnp.float32)))


def test_counts_to_fv_raw_matches():
    """The reference's compiled graph folds ``/ full_scale * 4095`` into
    one product with 0.203125; held on 2^20 counts that cross every code
    boundary, with per-channel beta / alpha."""
    rng = np.random.default_rng(1)
    counts = (rng.random((1 << 16, 16)) * 21000 + 900).astype(np.float32)
    counts[: 1 << 15] = np.floor(counts[: 1 << 15])
    beta = (960 + rng.standard_normal(16)).astype(np.float32)
    alpha = (1 + 0.1 * rng.standard_normal(16)).astype(np.float32)
    want = jax.jit(lambda c, b, a: jtd.counts_to_fv_raw(c, JCFG, b, a))(
        jnp.asarray(counts), jnp.asarray(beta), jnp.asarray(alpha))
    got = ttd.counts_to_fv_raw(torch.from_numpy(counts), TCFG, torch.from_numpy(beta),
                               torch.from_numpy(alpha))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert ttd.fv_scale(TCFG) == 0.203125
    codes = got.numpy()
    assert codes.min() == 0 and codes.max() == 4095


def test_config_constants_match():
    for name in ("f_tdc", "beta_nominal"):
        assert getattr(TCFG, name) == getattr(JCFG, name)
    assert TCFG.counts_per_frame(0.3) == JCFG.counts_per_frame(0.3)


# ---------------- SRO TDC: cumulative-phase form ----------------

@pytest.mark.parametrize("n", [1, 16, 17, 100, 256, 4000, 4096, 16000])
def test_blocked_cumsum_matches_xla_cumsum(n):
    x = (np.random.default_rng(n).random((3, n)) * 0.3 + 0.05).astype(np.float32)
    want = jax.jit(lambda a: jnp.cumsum(a, axis=-1))(jnp.asarray(x))
    np.testing.assert_array_equal(ttd.blocked_cumsum(torch.from_numpy(x), -1).numpy(),
                                  np.asarray(want))


@pytest.mark.parametrize("chip", [None, 3], ids=["ideal", "mismatched"])
def test_sro_tdc_matches(chip):
    u = _rect(2, 3, SPF * 5 + 100)
    jchip, tchip = _chip_pair(chip) if chip is not None else (None, None)
    want, wdiff = jax.jit(lambda a: jtd.sro_tdc(a, JCFG, jchip, return_diff_stream=True))(
        jnp.asarray(u))
    got, gdiff = ttd.sro_tdc(torch.from_numpy(u), TCFG, tchip, return_diff_stream=True)
    assert got.shape == (3, 5, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(gdiff.numpy(), np.asarray(wdiff))


def test_dc_input_counts_match_ideal():
    u = torch.full((1, SPF * 4, 16), 0.3)
    counts = ttd.sro_tdc(u, TCFG).numpy()
    assert np.all(np.abs(counts - TCFG.counts_per_frame(0.3)) <= 1.0)


# ---------------- K5 plain version ----------------

@pytest.mark.parametrize("b,frames,c", [(1, 1, 1), (1, 3, 16), (3, 2, 16), (2, 4, 4)])
@pytest.mark.parametrize("chip", [None, 5], ids=["ideal", "mismatched"])
def test_plain_tdc_matches_interpret_tier(interpret_tier, b, frames, c, chip):
    """The plain fractional-carry loop against the reference's TDC kernel
    run by the Pallas interpreter (its own tests' tier), incl. the R4
    shape b = frames = c = 1."""
    u = _rect(b * 10 + frames, b, SPF * frames, c)
    jchip = tchip = None
    if chip is not None:
        jchip, tchip = _chip_pair(chip)
        jchip = jtd.TDFExState(jchip.gain_mismatch[:c], jchip.cf_mismatch[:c])
        tchip = ttd.TDFExState(tchip.gain_mismatch[:c], tchip.cf_mismatch[:c])
    want = j_tdc_counts(jnp.asarray(u), JCFG, jchip, dispatch="interpret")
    got = tdc_counts(torch.from_numpy(u), TCFG, tchip)
    assert got.shape == (b, frames, c)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("c", [1, 4])
def test_plain_tdc_sums_counts_past_2_24_in_the_references_order(interpret_tier, c):
    """16 samples with d from 2^23 up put frame 1's count past 2^24, where
    float32 sums round: the plain version adds tick by tick as the
    reference's body does, and so stays array-equal to its interpret
    tier."""
    u = _rect(17 + c, 2, SPF * 2, c)
    hi = np.float32(298262.0) + np.arange(16, dtype=np.float32) * np.float32(2.0**-5)
    u[:, 700:716, :] = hi[None, :, None]
    want = np.asarray(j_tdc_counts(jnp.asarray(u), JCFG, None, dispatch="interpret"))
    got = tdc_counts(torch.from_numpy(u), TCFG).numpy()
    assert want[:, 1].min() > 2.0**24
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("b,frames,c", [(1, 1, 1), (3, 6, 16), (2, 4, 4)])
def test_plain_tdc_within_one_count_of_float64_oracle(b, frames, c):
    u = _rect(b + frames + c, b, SPF * frames, c)
    got = tdc_counts(torch.from_numpy(u), TCFG).numpy()
    f0, k = np.full(c, TCFG.f_free_hz), np.full(c, TCFG.k_sro_hz)
    ref = tdc_counts_ref(u, f0, k, SPF, TCFG.tdc_oversample, TCFG.f_tdc)
    np.testing.assert_array_equal(
        ref, j_tdc_counts_ref(u, f0, k, SPF, JCFG.tdc_oversample, JCFG.f_tdc))
    assert np.abs(got - ref).max() <= 1.0


def test_plain_tdc_trims_to_whole_frames_and_carries_phase():
    """The partial frame is dropped; the first frame equals a run over it
    alone, and the carry r running on into the second frame keeps the
    whole run within 1 count of the float64 oracle."""
    u = _rect(3, 2, SPF * 2 + 77)
    got = tdc_counts(torch.from_numpy(u), TCFG)
    assert got.shape == (2, 2, 16)
    f0 = torch.full((16,), TCFG.f_free_hz)
    k = torch.full((16,), TCFG.k_sro_hz)
    one = tdc_counts_plain(torch.from_numpy(u[:, :SPF]), f0, k, SPF, 2, tdc_scale(TCFG))
    np.testing.assert_array_equal(got[:, :1].numpy(), one.numpy())
    ref = tdc_counts_ref(u, f0.numpy(), k.numpy(), SPF, TCFG.tdc_oversample, TCFG.f_tdc)
    assert np.abs(got.numpy() - ref).max() <= 1.0


# ---------------- K1 plain versions ----------------

@pytest.mark.parametrize("batch,t,channels,frame", [
    (1, 1024, 16, 512), (3, 2048, 16, 512), (5, 1536, 8, 256), (2, 1024, 4, 128),
])
def test_plain_fex_fused_matches_reference(batch, t, channels, frame):
    """Array-equal to the reference's `fex_fused_ref` (its XLA tier: the
    frame mean summed in windows of 32, as the port sums it), which is
    tighter than the reference's kernel tests (rtol 2e-5, atol 1e-6);
    the reference's Pallas body, which sums left to right, agrees within
    that tolerance."""
    coeffs = design_filterbank(channels, 32000.0)
    jcoeffs = j_design_filterbank(channels, 32000.0)
    x = (np.random.default_rng(batch + t).standard_normal((batch, t)) * 0.2).astype(np.float32)
    want = jax.jit(lambda a: j_fex_fused_ref(a, jcoeffs, frame))(jnp.asarray(x))
    got = fex_fused(torch.from_numpy(x), coeffs, frame)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    interp = jax.jit(lambda a, c: fex_fused_pallas(
        a, c, frame_len=frame, block_batch=batch, interpret=True))(
        jnp.asarray(x), jnp.asarray(coeffs.stacked(device="cpu").numpy()))
    np.testing.assert_allclose(got.numpy(), np.asarray(interp), rtol=2e-5, atol=1e-6)


def test_plain_fex_fused_bfloat16_input_and_trimming():
    coeffs = design_filterbank(16, 32000.0)
    x = torch.from_numpy((np.random.default_rng(9).standard_normal((2, 1100)) * 0.2)
                         .astype(np.float32))
    xb = x.to(torch.bfloat16)
    got = fex_fused(xb, coeffs, 512)
    assert got.dtype == torch.float32 and got.shape == (2, 2, 16)
    np.testing.assert_array_equal(got.numpy(), fex_fused_ref(xb.float()[:, :1024], coeffs, 512).numpy())
    ref32 = fex_fused_ref(x[:, :1024], coeffs, 512).numpy()
    np.testing.assert_allclose(got.numpy(), ref32, rtol=3e-2, atol=3e-2)


def test_plain_fex_fused_state_carries_across_frames():
    coeffs = design_filterbank(16, 32000.0)
    x = torch.zeros((1, 1024))
    x[0, 500] = 1.0
    assert float(fex_fused(x, coeffs, 512)[0, 1].max()) > 1e-4


def test_plain_scan_entry_carries_state_like_one_pass():
    coeffs = design_filterbank(16, 32000.0).stacked(device="cpu")
    x = torch.from_numpy((np.random.default_rng(4).standard_normal((3, 300)) * 0.3)
                         .astype(np.float32))
    y_all, st_all = biquad_stream(x, coeffs)
    y_a, st = biquad_stream(x[:, :128], coeffs)
    y_b, st = biquad_filterbank_streaming(x[:, 128:], coeffs, st)
    np.testing.assert_array_equal(torch.cat([y_a, y_b], 1).numpy(), y_all.numpy())
    for a, b in zip(st, st_all):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------- the whole chain and calibration ----------------

@pytest.mark.parametrize("chip", [None, 3], ids=["ideal", "mismatched"])
def test_tdfex_forward_matches(chip):
    rng = np.random.default_rng(6)
    audio = (rng.standard_normal((3, 2048)) * np.array([[0.02], [0.1], [0.4]])).astype(np.float32)
    jchip, tchip = _chip_pair(chip) if chip is not None else (None, None)
    beta = (JCFG.beta_nominal + rng.standard_normal(16)).astype(np.float32)
    alpha = (1 + 0.05 * rng.standard_normal(16)).astype(np.float32)
    want = jax.jit(lambda a: jtd.tdfex_forward(a, JCFG, jnp.asarray(beta), jnp.asarray(alpha),
                                               jchip))(jnp.asarray(audio))
    got = ttd.tdfex_forward(torch.from_numpy(audio), TCFG, torch.from_numpy(beta),
                            torch.from_numpy(alpha), tchip)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_calibration_matches_reference_bench():
    """beta / alpha of a die drawn with jax.random: the reference's eager
    bench flow against the port's on the CPU."""
    jchip, tchip = _chip_pair(7)
    jbeta, jalpha = jcal.calibrate_chip(JCFG, jchip)
    tbeta, talpha = tcal.calibrate_chip(TCFG, tchip, device="cpu")
    np.testing.assert_array_equal(tbeta.numpy(), np.asarray(jbeta))
    np.testing.assert_array_equal(talpha.numpy(), np.asarray(jalpha))
    # alpha undoes the gain mismatch (the reference's own check)
    g = 1.0 + tchip.gain_mismatch.numpy()
    ideal = (1.0 / g) / np.mean(1.0 / g)
    np.testing.assert_allclose(talpha.numpy()[:15], ideal[:15], rtol=0.06)
    np.testing.assert_allclose(tcal.measure_beta(TCFG, device="cpu").numpy(),
                               TCFG.beta_nominal, rtol=0.01)


# (B, F) of the recorded counts: one fused loop (21, 32 rows), odd pads
# (33, 63 rows), even ones (36, 62, 496, 4464), and 1200 clips x 62
# frames = 74 400 rows, windowed three times.
COUNT_SHAPES = [(3, 7), (4, 8), (3, 11), (4, 9), (1, 62), (7, 9), (8, 62), (72, 62),
                (1200, 62)]


@pytest.mark.parametrize("clips,frames", COUNT_SHAPES)
def test_fit_norm_stats_from_counts(clips, frames):
    """Array-equal to the reference's eager fit on every code, 63
    included: both fits read FV_Log by the eager closed form, 512 at code
    63 (ROADMAP queue 3, F2), and take the eager mean / std (F15)."""
    rng = np.random.default_rng([8, clips, frames])
    codes = np.floor(rng.random((clips, frames, 16)) * 4096).astype(np.float32)
    codes[0, :, 3] = 63.0
    want = jcal.fit_norm_stats_from_counts(jnp.asarray(codes), JCFG)
    got = tcal.fit_norm_stats_from_counts(torch.from_numpy(codes), TCFG)
    np.testing.assert_array_equal(got.mu.numpy(), np.asarray(want.mu))
    np.testing.assert_array_equal(got.sigma.numpy(), np.asarray(want.sigma))
    at63 = np.full((1, 2, 16), 63.0, np.float32)
    assert float(tcal.fit_norm_stats_from_counts(torch.from_numpy(at63), TCFG).mu[0]) == 512.0
    assert float(jcal.fit_norm_stats_from_counts(jnp.asarray(at63), JCFG).mu[0]) == 512.0


def test_eager_log_equals_the_references_eager_lut_on_every_code():
    """The fit's closed-form log against the reference's eager
    `log_compress_lut` on all 4096 codes; the tick's ROM keeps 511 at
    the tie, code 63 (P1), and equals the eager form everywhere else."""
    v = np.arange(4096, dtype=np.float32)
    want = np.asarray(jq.log_compress_lut(jnp.asarray(v), 12, 10))
    got = tq.log_compress_eager(torch.from_numpy(v), 12, 10).numpy()
    np.testing.assert_array_equal(got, want)
    rom = tq.log_rom("cpu", 12, 10).numpy()
    assert rom[63] == 511.0 and got[63] == 512.0
    np.testing.assert_array_equal(np.delete(rom, 63), np.delete(want, 63))


# ---------------- keyed noise, by its statistics (W4) ----------------

def test_draw_chip_statistics():
    g = torch.Generator().manual_seed(0)
    chips = [ttd.draw_chip(g, TCFG) for _ in range(400)]
    gm = torch.stack([c.gain_mismatch for c in chips]).numpy()
    cm = torch.stack([c.cf_mismatch for c in chips]).numpy()
    assert gm.shape == cm.shape == (400, 16) and gm.dtype == np.float32
    assert abs(gm.mean()) < 0.01 and abs(gm.std() / TCFG.gain_mismatch_sigma - 1) < 0.03
    assert abs(cm.mean()) < 0.002 and abs(cm.std() / TCFG.cf_mismatch_sigma - 1) < 0.03
    # seeded: the same generator seed draws the same die
    a = ttd.draw_chip(torch.Generator().manual_seed(3), TCFG)
    b = ttd.draw_chip(torch.Generator().manual_seed(3), TCFG)
    assert torch.equal(a.gain_mismatch, b.gain_mismatch)


def test_draw_chip_without_a_generator_defaults_to_the_card():
    """No generator and no device means the card, as at every entry point
    of the port: it raises where there is none rather than drawing on the
    CPU. A named device, or a generator's, is followed."""
    if torch.cuda.is_available():
        chip = ttd.draw_chip(None, TCFG)
        assert chip.gain_mismatch.device.type == chip.cf_mismatch.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ttd.draw_chip(None, TCFG)
    chip = ttd.draw_chip(None, TCFG, device="cpu")
    assert chip.gain_mismatch.device.type == chip.cf_mismatch.device.type == "cpu"
    assert chip.gain_mismatch.shape == (16,) and chip.gain_mismatch.dtype == torch.float32
    chip = ttd.draw_chip(torch.Generator().manual_seed(1), TCFG)
    assert chip.cf_mismatch.device.type == "cpu"


def test_vtc_noise_statistics():
    x = torch.zeros((4, 8192))
    clean = ttd.vtc(x, TCFG)
    noisy = ttd.vtc(x, TCFG, torch.Generator().manual_seed(1))
    n = (noisy - clean).numpy()
    assert abs(n.std() / TCFG.input_noise_rms - 1) < 0.02 and abs(n.mean()) < 1e-4
    jn = np.asarray(jtd.vtc(jnp.zeros((4, 8192)), JCFG, jax.random.PRNGKey(1)))
    assert abs(n.std() / jn.std() - 1) < 0.03


def test_sro_jitter_statistics():
    cfg = ttd.TDFExConfig(phase_noise_rms=0.05)
    u = torch.from_numpy(_rect(11, 4, SPF * 8))
    clean = ttd.sro_tdc(u, cfg)
    noisy = ttd.sro_tdc(u, cfg, generator=torch.Generator().manual_seed(2))
    d = (noisy - clean).numpy()
    assert np.abs(d).max() >= 1 and abs(d.mean()) < 0.2
    # the jitter's counts telescope: the total over all frames moves by at
    # most the last edge's jitter
    assert np.abs(d.sum(axis=1)).max() <= 15 * 0.05 * 6 + 1
