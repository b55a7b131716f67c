"""The port's float, qat and integer classifiers against the reference.

Parameters are made by the reference and carried across through numpy
(`repro_torch.convert`); inputs lie on the Q6.8 grid, as every frame the
frontend makes does. qat / integer states and logit codes must be
array-equal, the float backend agree within FLOAT_ATOL (R3), and the
plain integer GEMM must equal `intgemm_ref` and an int64 numpy oracle,
saturation and degenerate shapes included (R4). The ΔGRU backends are
held in tests/test_torch_delta.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gru as jgru
from repro.core import gru_int as jgi
from repro.core import quant as jq
from repro.core.pipeline import KWSPipeline as JPipeline
from repro.core.pipeline import KWSPipelineConfig as JConfig
from repro.kernels.intgemm import intgemm_ref as j_intgemm_ref
from repro.serving.quantize import quantize_classifier as j_quantize
from repro_torch import convert
from repro_torch.core import gru as tgru
from repro_torch.core import gru_int as tgi
from repro_torch.core.classifier import available_classifiers, get_classifier
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.kernels.intgemm import INT24_MAX, INT24_MIN, intgemm
from repro_torch.serving.cascade import CascadeConfig
from repro_torch.serving.quantize import quantize_classifier

CFG = jgru.GRUConfig()
TCFG = tgru.GRUConfig()
# float32 forward: matmul order and sigmoid / tanh differ from XLA's in the
# last bits (the forward's logits differed by at most 6e-8 on this seed;
# the bound is the one tests/test_torch_delta.py states for the server)
FLOAT_ATOL = 2e-6


@pytest.fixture(scope="module")
def params():
    jp = jgru.init_gru_classifier(jax.random.PRNGKey(0), CFG)
    return jp, convert.params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _grid_fv(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    return np.array(jq.fake_quant(jnp.asarray(x), jq.ACT_Q6_8))


def test_qat_forward_matches(params):
    jp, tp = params
    fv = _grid_fv((3, 6, 16), 1)
    want = jax.jit(lambda p, x: jgru.gru_classifier_forward(p, x, CFG))(jp, fv)
    got = tgru.gru_classifier_forward(tp, torch.from_numpy(fv), TCFG)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qat_and_integer_steps_match(params):
    jp, tp = params
    jq_codes = j_quantize(jp, CFG)
    tq_codes = convert.quantized_from_numpy(
        jax.tree_util.tree_map(np.asarray, jq_codes), "cpu"
    )
    jqat = jax.jit(lambda p, s, x: jgru.gru_classifier_step(p, s, x, CFG))
    jint = jax.jit(lambda p, s, x: jgi.int_gru_classifier_step(p, s, x, CFG))
    js_q, js_i = jgru.init_states(CFG, 7), jgi.int_init_states(CFG, 7)
    ts_q = tgru.init_states(TCFG, 7, "cpu")
    ts_i = tgi.int_init_states(TCFG, 7, "cpu")
    for t in range(5):
        fv = _grid_fv((7, 16), 10 + t)
        js_q, jl_q = jqat(jp, js_q, fv)
        js_i, jl_i = jint(jq_codes, js_i, jgi.quantize_acts(fv))
        ts_q, tl_q = tgru.gru_classifier_step(tp, ts_q, torch.from_numpy(fv), TCFG)
        ts_i, tl_i = tgi.int_gru_classifier_step(
            tq_codes, ts_i, tgi.quantize_acts(torch.from_numpy(fv)), TCFG
        )
        np.testing.assert_array_equal(tl_q.numpy(), np.asarray(jl_q))
        np.testing.assert_array_equal(tl_i.numpy(), np.asarray(jl_i))
        for a, b in zip(ts_q, js_q):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        for a, b, q in zip(ts_i, js_i, ts_q):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            # the qat state is the integer codes times 2^-8
            np.testing.assert_array_equal(q.numpy(), a.numpy() * np.float32(2**-8))


def test_integer_forward_matches(params):
    jp, tp = params
    fv = _grid_fv((2, 5, 16), 3)
    jcodes = j_quantize(jp, CFG)
    want = jax.jit(lambda p, x: jgi.int_gru_classifier_forward(p, x, CFG))(
        jcodes, jgi.quantize_acts(fv)
    )
    got = tgi.int_gru_classifier_forward(
        quantize_classifier(tp, TCFG), tgi.quantize_acts(torch.from_numpy(fv)), TCFG
    )
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_classifier_codes_match(params):
    jp, tp = params
    j = j_quantize(jp, CFG)
    t = quantize_classifier(tp, TCFG)
    for jl, tl in zip(j.gru, t.gru):
        for k in ("w_i", "w_h", "b_i", "b_h"):
            assert tl[k].dtype == (torch.int8 if k[0] == "w" else torch.int32)
            np.testing.assert_array_equal(tl[k].numpy(), np.asarray(jl[k]))
    np.testing.assert_array_equal(t.fc_w.numpy(), np.asarray(j.fc_w))
    np.testing.assert_array_equal(t.fc_b.numpy(), np.asarray(j.fc_b))


@pytest.mark.parametrize("classifier", ["qat", "integer"])
def test_pipeline_streaming_step_and_logits_match(params, classifier):
    jp, tp = params
    jpipe = JPipeline(JConfig(classifier=classifier))
    tpipe = KWSPipeline(KWSPipelineConfig(classifier=classifier))
    fv = _grid_fv((4, 3, 16), 5)
    np.testing.assert_array_equal(
        tpipe.logits(tp, torch.from_numpy(fv)).numpy(),
        np.asarray(jpipe.logits(jp, fv)),
    )
    js, ts = jpipe.streaming_init(4), tpipe.streaming_init(4, device="cpu")
    for t in range(3):
        js, jl = jpipe.streaming_step(jp, js, fv[:, t])
        ts, tl = tpipe.streaming_step(tp, ts, torch.from_numpy(fv[:, t]))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    for a, b in zip(ts, js):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _int64_oracle(x, w):
    return np.clip(x.astype(np.int64) @ w.astype(np.int64), INT24_MIN, INT24_MAX)


@pytest.mark.parametrize(
    "m,k,n,kind",
    [
        (1, 1, 1, "random"),
        (7, 5, 3, "random"),
        (13, 48, 144, "random"),
        (9, 16, 12, "random"),
        (5, 48, 144, "saturate_pos"),
        (5, 48, 144, "saturate_neg"),
        (1, 1, 1, "saturate_pos"),
    ],
)
def test_plain_intgemm_matches_reference_and_oracle(m, k, n, kind):
    rng = np.random.default_rng(m * 1000 + k * 10 + n)
    if kind == "random":
        x = rng.integers(-8192, 8192, (m, k)).astype(np.int32)
        w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    else:
        sign = 1 if kind == "saturate_pos" else -1
        x = np.full((m, k), 8191 * sign, np.int32)
        w = np.full((k, n), 127, np.int8)
        if k == 1:  # one term cannot pass 2^23: scale the row instead
            x = np.full((m, k), sign * (2**23 + 5), np.int32)
            w = np.ones((k, n), np.int8)
    got = intgemm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _int64_oracle(x, w))
    np.testing.assert_array_equal(got, np.asarray(j_intgemm_ref(x, w)))
    if kind != "random":
        assert np.abs(got).max() in (INT24_MAX, -INT24_MIN)


def test_registry_ports_qat_and_integer_only():
    # every backend of the reference is ported, and the cascade binds
    assert available_classifiers() == ("delta", "delta-int", "float", "integer", "qat")
    for name in available_classifiers():
        assert get_classifier(name).name == name
    with pytest.raises(KeyError, match="registered classifiers"):
        get_classifier("bogus")
    assert KWSPipeline(KWSPipelineConfig(gru=tgru.GRUConfig(quantized=False))).classifier.name == "float"
    # the cascade composes around a backend, it does not replace it
    casc = CascadeConfig(wake_threshold=0.25)
    gated = KWSPipeline(KWSPipelineConfig(classifier="integer", cascade=casc))
    assert gated.config.cascade is casc and gated.classifier is get_classifier("integer")
    assert KWSPipelineConfig().cascade is None
    for name in ("integer", "delta-int"):
        with pytest.raises(TypeError, match="QuantizedClassifier"):
            get_classifier(name).step({}, [], torch.zeros(1, 16), TCFG)


def test_float_forward_and_step_within_tolerance(params):
    jp, tp = params
    fcfg, tfcfg = jgru.GRUConfig(quantized=False), tgru.GRUConfig(quantized=False)
    fv = np.random.default_rng(6).standard_normal((3, 8, 16)).astype(np.float32)
    want = jax.jit(lambda p, x: jgru.gru_classifier_forward(p, x, fcfg))(jp, fv)
    got = tgru.gru_classifier_forward(tp, torch.from_numpy(fv), tfcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=FLOAT_ATOL)
    jpipe, tpipe = JPipeline(JConfig(classifier="float")), KWSPipeline(KWSPipelineConfig(classifier="float"))
    np.testing.assert_allclose(tpipe.logits(tp, torch.from_numpy(fv)).numpy(),
                               np.asarray(jpipe.logits(jp, fv)), rtol=0, atol=FLOAT_ATOL)
    js, ts = jpipe.streaming_init(3), tpipe.streaming_init(3, device="cpu")
    for t in range(8):
        js, jl = jpipe.streaming_step(jp, js, fv[:, t])
        ts, tl = tpipe.streaming_step(tp, ts, torch.from_numpy(fv[:, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0, atol=FLOAT_ATOL)
    for a, b in zip(ts, js):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=FLOAT_ATOL)
    # the float backend quantizes nothing: its states leave the Q6.8 grid
    assert (ts[0].numpy() * 256 % 1 != 0).any()


def test_init_params_uses_the_generator():
    pipe = KWSPipeline(KWSPipelineConfig())
    a = pipe.init_params(torch.Generator().manual_seed(3), device="cpu")
    b = pipe.init_params(torch.Generator().manual_seed(3), device="cpu")
    assert a["gru"][0]["w_i"].shape == (16, 144)
    assert a["gru"][1]["w_h"].shape == (48, 144)
    assert a["fc"]["w"].shape == (48, 12)
    np.testing.assert_array_equal(a["fc"]["w"].numpy(), b["fc"]["w"].numpy())
    assert float(a["gru"][0]["w_i"].abs().max()) <= 1 / np.sqrt(48)
