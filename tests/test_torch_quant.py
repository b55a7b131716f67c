"""The port's numeric substrate against `repro.core.quant`, exhaustively.

The ROMs decide every code the port produces, so they are compared on
their whole domain: the 4096-entry log ROM with the log compression the
reference's compiled (XLA) tick evaluates, and the two 32 767-entry Q6.8
gate ROMs with both the reference's ROMs and its jitted
``fake_quant(sigmoid(.))`` / ``fake_quant(tanh(.))`` (watch item W3).
The straight-through gradients are held against ``jax.grad``: ste_round,
the fake-quant clip's 0.5 on a bound, and the QAT gates' derivative on
every code of their domain.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq
from repro_torch.core.fex import fma_f32
from repro_torch.core.gru import _gate

ALL_LOG_CODES = np.arange(4096, dtype=np.float32)
GATE_CODES = np.arange(tq.LUT_MIN, tq.LUT_MAX + 1, dtype=np.int32)


def test_log_rom_equals_compiled_reference():
    ref = np.asarray(
        jax.jit(lambda c: jq.log_compress_lut(c, 12, 10))(ALL_LOG_CODES)
    )
    np.testing.assert_array_equal(tq.log_rom("cpu").numpy(), ref)
    np.testing.assert_array_equal(
        tq.log_compress_lut(torch.from_numpy(ALL_LOG_CODES)).numpy(), ref
    )


def test_log_rom_tie_at_code_63():
    """1023 * log2(64) / 12 = 511.5 exactly. The compiled reference folds
    its constants and gives 511; the eager `make_log_lut` gives 512.
    The port follows the tick the server runs; no other code differs."""
    eager = np.asarray(jq.make_log_lut())
    rom = tq.log_rom("cpu").numpy()
    assert np.nonzero(rom != eager)[0].tolist() == [63]
    assert (rom[63], eager[63]) == (511.0, 512.0)


@pytest.mark.parametrize(
    "rom,ref_rom,fn",
    [
        (tq.sigmoid_rom, jq.sigmoid_lut_q68, jax.nn.sigmoid),
        (tq.tanh_rom, jq.tanh_lut_q68, jnp.tanh),
    ],
    ids=["sigmoid", "tanh"],
)
def test_gate_roms_exhaustive(rom, ref_rom, fn):
    port = rom("cpu").numpy()
    assert port.shape == (32767,)
    np.testing.assert_array_equal(port, np.asarray(ref_rom()))
    # the QAT path's own evaluation, jitted, on every grid input
    grid = GATE_CODES.astype(np.float32) * np.float32(2.0**-8)
    qat = jax.jit(lambda v: jq.fake_quant(fn(v), jq.ACT_Q6_8))(grid)
    np.testing.assert_array_equal(port, np.asarray(qat) * 256.0)
    # and the lookup helpers index it over the clipped domain
    codes = torch.tensor([tq.LUT_MIN - 5, tq.LUT_MIN, 0, 3, tq.LUT_MAX, 10**6])
    look = (tq.lut_sigmoid_q68 if rom is tq.sigmoid_rom else tq.lut_tanh_q68)(codes)
    np.testing.assert_array_equal(
        look.numpy(), port[np.clip(codes.numpy(), tq.LUT_MIN, tq.LUT_MAX) - tq.LUT_MIN]
    )


@pytest.mark.parametrize("shift", [0, 1, 7, 8])
def test_round_shift_even_sweep_with_negative_ties(shift):
    base = np.arange(-2000, 2001, dtype=np.int32)
    ties = (np.arange(-40, 41, dtype=np.int32) << shift) + (
        (1 << (shift - 1)) if shift else 0
    )
    codes = np.concatenate([base, ties, -ties])
    got = tq.round_shift_even(torch.from_numpy(codes), shift).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jq.round_shift_even(jnp.asarray(codes), shift))
    )
    np.testing.assert_array_equal(got, np.round(codes / 2.0**shift).astype(np.int32))


def _random_and_boundary(spec, rng):
    lsb = spec.scale
    edges = np.array(
        [0.0, -0.0, spec.min_value, spec.max_value, spec.max_value + lsb,
         spec.min_value - lsb, 1e9, -1e9],
        np.float64,
    )
    halves = (rng.integers(-300, 300, 200) + 0.5) * lsb  # exact ties
    noise = rng.standard_normal(2000) * spec.max_value / 3
    return np.concatenate([edges, halves, noise]).astype(np.float32)


@pytest.mark.parametrize("name", ["ACT_Q6_8", "WEIGHT_INT8", "BIAS_Q8_15"])
def test_fake_quant_and_quantize_int_match(name):
    x = _random_and_boundary(getattr(jq, name), np.random.default_rng(1))
    jspec, tspec = getattr(jq, name), getattr(tq, name)
    xt = torch.from_numpy(x)
    np.testing.assert_array_equal(
        tq.fake_quant(xt, tspec).numpy(),
        np.asarray(jax.jit(lambda v: jq.fake_quant(v, jspec))(x)),
    )
    np.testing.assert_array_equal(
        tq.quantize_int(xt, tspec).numpy(),
        np.asarray(jax.jit(lambda v: jq.quantize_int(v, jspec))(x)),
    )


def test_quantize_unsigned_matches_compiled_reference():
    rng = np.random.default_rng(2)
    scale = tq.quantizer_scale(12, 0.7)
    assert scale == 5850.0
    ties = ((np.arange(0, 4095) + 0.5) / np.float32(5850.0)).astype(np.float32)
    x = np.concatenate(
        [np.array([-1.0, 0.0, 0.7, 0.70001, 5.0], np.float32), ties,
         rng.random(20000).astype(np.float32) * 0.75]
    )
    ref = jax.jit(lambda v: jq.quantize_unsigned(v, 12, 0.7))(x)
    np.testing.assert_array_equal(
        tq.quantize_unsigned(torch.from_numpy(x), 12, 0.7).numpy(), np.asarray(ref)
    )


def _exact_fma(a, b, c):
    """Correctly rounded float32 of the exact rational a*b + c (nearest,
    ties to the even significand)."""
    exact = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    r = np.float32(float(exact))
    near = [np.nextafter(r, np.float32(-np.inf)), r, np.nextafter(r, np.float32(np.inf))]
    return min(
        near,
        key=lambda v: (abs(Fraction(float(v)) - exact), int(v.view(np.int32)) & 1),
    )


def test_fma_f32_is_one_rounding():
    """Random triples plus triples whose float64 sum lands exactly on a
    float32 tie, where a plain float64 sum rounds twice and misses."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal(400).astype(np.float32)
    b = rng.standard_normal(400).astype(np.float32)
    c = (rng.standard_normal(400) * 4).astype(np.float32)
    # (2^23 + x)(2^24 - 2x + 1) = 2^47 + 2^23 - 2x^2 + x, within 2^12 of
    # 2^47 for x near 2048: a*b = 2^-24 + tiny, and 1 + a*b sits a hair
    # off the float32 midpoint between 1 and 1 + 2^-23
    x = np.arange(2030, 2070)
    m1 = (2**23 + x) * 2.0**-47
    m2 = (2**24 - 2 * x + 1) * 2.0**-24
    a = np.concatenate([a, m1.astype(np.float32)])
    b = np.concatenate([b, m2.astype(np.float32)])
    c = np.concatenate([c, np.ones(len(x), np.float32)])
    got = fma_f32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_exact_fma(*t) for t in zip(a, b, c)], np.float32)
    np.testing.assert_array_equal(got, want)
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert (naive != want).any()  # the hard cases are really exercised


@pytest.mark.parametrize("rom", [tq.log_rom, tq.sigmoid_rom, tq.tanh_rom],
                         ids=["log", "sigmoid", "tanh"])
def test_roms_default_to_the_card(rom, monkeypatch):
    """F7: ``device=None`` means the card, as at every entry point of the
    port, and raises where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        rom()
    assert rom("cpu").device.type == "cpu"


def test_ste_round_passes_the_gradient_through():
    x = np.array([-2.5, -1.5, -0.5, 0.0, 0.49, 0.5, 1.5, 2.5, 7.3], np.float32)
    g = np.arange(1, len(x) + 1, dtype=np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tq.ste_round(xt)
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jq.ste_round(jnp.asarray(x))))
    y.backward(torch.from_numpy(g))
    _, vjp = jax.vjp(jq.ste_round, jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(vjp(jnp.asarray(g))[0]))
    np.testing.assert_array_equal(xt.grad.numpy(), g)


@pytest.mark.parametrize("name", ["ACT_Q6_8", "WEIGHT_INT8", "BIAS_Q8_15"])
def test_fake_quant_gradient_equals_jax_grad_with_clip_ties(name):
    """1 inside the format, 0.5 on a bound (jnp.clip's max and min split a
    tie), 0 beyond; torch.clamp would give 1 on the bound."""
    jspec, tspec = getattr(jq, name), getattr(tq, name)
    lsb = jspec.scale
    bounds = np.array([jspec.min_value, jspec.max_value, jspec.min_value + lsb / 4,
                       jspec.max_value + lsb / 4, jspec.min_value - lsb, jspec.max_value + lsb,
                       jspec.max_value * 2, 0.0], np.float32)
    x = np.concatenate([bounds, _random_and_boundary(jspec, np.random.default_rng(4))])
    g = np.random.default_rng(5).standard_normal(len(x)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tq.fake_quant(xt, tspec)
    y.backward(torch.from_numpy(g))
    want = jax.grad(lambda v: jnp.sum(jq.fake_quant(v, jspec) * g))(jnp.asarray(x))
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jq.fake_quant(jnp.asarray(x), jspec)))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    # on a bound, and a quarter LSB inside it (the same code): half the gradient
    np.testing.assert_array_equal(xt.grad.numpy()[:4], g[:4] * np.float32(0.5))
    np.testing.assert_array_equal(xt.grad.numpy()[4:8], [0, 0, 0, g[7]])


def test_quantize_unsigned_gradient_is_straight_through_inside_the_range():
    x = np.array([-0.1, 0.0, 0.2, 0.35, 0.7, 0.9], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    tq.quantize_unsigned(xt, 12, 0.7).sum().backward()
    want = np.asarray(jax.grad(lambda v: jnp.sum(jq.quantize_unsigned(v, 12, 0.7)))(jnp.asarray(x)))
    # the port scales by the folded 5850.0, the reference by / 0.7 * 4095
    np.testing.assert_allclose(xt.grad.numpy(), want, rtol=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), [0, 2925, 5850, 5850, 2925, 0])


# the port's gate backward against jax.grad of the reference's
# fake_quant(sigmoid / tanh): the same rule on a float a = f(x) that torch
# and XLA evaluate up to 1 ulp (sigmoid) / 2 ulps (tanh) apart; measured
# over the whole domain, relative to the largest |gradient|: sigmoid
# 1.9e-7, tanh 6.1e-7 (at a = -1 + 2^-22, where 1 - a carries it)
GATE_GRAD_TOL = 1e-6


@pytest.mark.parametrize("name,fn", [("sigmoid", jax.nn.sigmoid), ("tanh", jnp.tanh)])
def test_gate_gradient_equals_jax_grad_on_every_code(name, fn):
    x = GATE_CODES.astype(np.float32) * np.float32(2.0**-8)
    g = np.random.default_rng(6).standard_normal(len(x)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = _gate(name, xt)
    y.backward(torch.from_numpy(g))
    ref_fn = lambda v: jq.fake_quant(fn(v), jq.ACT_Q6_8)  # noqa: E731
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jax.jit(ref_fn)(x)))
    want = np.asarray(jax.grad(lambda v: jnp.sum(ref_fn(v) * g))(jnp.asarray(x)))
    err = np.abs(xt.grad.numpy() - want).max() / np.abs(want).max()
    assert err <= GATE_GRAD_TOL, err
