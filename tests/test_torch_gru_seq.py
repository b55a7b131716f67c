"""The port's GRU sequence entry point (K6's plain path on the CPU) and
`core.gru.gru_layer` against the reference's XLA tier.

Inputs are made with numpy from a seed and go through both packages.
The oracle is `repro.kernels.gru.gru_sequence_ref` compiled with
`jax.jit` (the reference's own `gru_sequence` needs its Pallas dispatch,
ROADMAP R5). float32 agrees within FLOAT_ATOL, bfloat16 within BF16_ATOL,
the QAT layer (Q6.8 grid) exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gru as jgru
from repro.core import quant as jq
from repro.kernels.gru import gru_sequence_ref
from repro_torch import convert
from repro_torch.core import gru as tgru
from repro_torch.kernels import gru_sequence, gru_sequence_plain
from repro_torch.kernels.gru import ops as gru_ops

# float32: the port's matmul order and sigmoid / tanh differ from XLA's in
# the last bits; over the shapes below the hidden states differed by at
# most 4.0e-7 (the reference's own kernel test allows 1e-5)
FLOAT_ATOL = 2e-6
# bfloat16 against the reference's bf16 oracle: the reference's own bound
# (tests/test_kernels.py); measured at most 0.0195 here
BF16_ATOL = 3e-2

_ref = jax.jit(gru_sequence_ref)


def _layer(seed, b, t, i, h, h0_scale=0.0):
    rng = np.random.default_rng(seed)
    xs = rng.standard_normal((b, t, i)).astype(np.float32)
    w = (rng.standard_normal((i, 3 * h)) * 0.2).astype(np.float32)
    u = (rng.standard_normal((h, 3 * h)) * 0.2).astype(np.float32)
    bi = (rng.standard_normal(3 * h) * 0.1).astype(np.float32)
    bh = (rng.standard_normal(3 * h) * 0.1).astype(np.float32)
    h0 = (rng.standard_normal((b, h)) * h0_scale).astype(np.float32)
    return xs, w, u, bi, bh, h0


def _want(xs, w, u, bi, bh, h0):
    """The reference's oracle, batch-major in and out."""
    out = _ref(jnp.asarray(np.moveaxis(xs, 1, 0)), w, u, bi, bh, h0)
    return np.moveaxis(np.asarray(out.astype(jnp.float32)), 0, 1)


# the reference's sweep (tests/test_kernels.py:56-61), B not a multiple of
# 8, and T = 1
SHAPES = [(1, 5, 16, 48), (4, 20, 16, 48), (9, 7, 32, 64), (2, 62, 16, 48),
          (5, 3, 8, 16), (3, 1, 16, 48)]


@pytest.mark.parametrize("b,t,i,h", SHAPES)
def test_gru_sequence_matches_the_reference(b, t, i, h):
    xs, w, u, bi, bh, h0 = _layer(b * 100 + t, b, t, i, h)
    got = gru_sequence(*(torch.from_numpy(a) for a in (xs, w, u, bi, bh)))
    assert got.shape == (b, t, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _want(xs, w, u, bi, bh, h0), rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("b,t,i,h", [(2, 4, 8, 16), (9, 7, 32, 64)])
def test_gru_sequence_nonzero_initial_state(b, t, i, h):
    xs, w, u, bi, bh, h0 = _layer(7, b, t, i, h, h0_scale=1.0)
    got = gru_sequence(*(torch.from_numpy(a) for a in (xs, w, u, bi, bh, h0)))
    np.testing.assert_allclose(got.numpy(), _want(xs, w, u, bi, bh, h0), rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("b,t,i,h", [(2, 8, 16, 48), (9, 7, 32, 64)])
def test_gru_sequence_bf16_matches_the_references_bf16(b, t, i, h):
    a = _layer(11, b, t, i, h, h0_scale=0.5)
    bf = lambda x: jnp.asarray(x).astype(jnp.bfloat16)  # noqa: E731
    want = np.moveaxis(np.asarray(
        _ref(bf(np.moveaxis(a[0], 1, 0)), *(bf(x) for x in a[1:])).astype(jnp.float32)), 0, 1)
    got = gru_sequence(*(torch.from_numpy(x).to(torch.bfloat16) for x in a))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0, atol=BF16_ATOL)


def test_plain_version_is_time_major():
    """(T, B, I) in, (T, B, H) out; a transposition slip would show on
    this non-square shape."""
    xs, w, u, bi, bh, h0 = _layer(3, 9, 7, 32, 64, h0_scale=1.0)
    tm = np.moveaxis(xs, 1, 0)
    got = gru_sequence_plain(*(torch.from_numpy(np.ascontiguousarray(a))
                               for a in (tm, w, u, bi, bh, h0)))
    assert got.shape == (7, 9, 64)
    want = np.asarray(_ref(jnp.asarray(tm), w, u, bi, bh, h0))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_ATOL)


def test_gru_sequence_shared_memory_size():
    """The kernel's block holds the layer, two h tiles and a ring of four
    x tiles, 16 rows each padded to 16 mod 32 bytes: 47.5 KB at the
    paper's layer 1, 73.5 KB at layer 2 (above the 48 KB default, so the
    launch raises the block's limit); two blocks of layer 2 fit an SM."""
    assert gru_ops.smem_bytes(16, 48) == 4 * (64 * 144) + 2 * 16 * 208 + 4 * 16 * 80
    assert gru_ops.smem_bytes(48, 48) == 4 * (96 * 144) + 2 * 16 * 208 + 4 * 16 * 208
    assert gru_ops.smem_bytes(48, 48) > 48 * 1024 > gru_ops.smem_bytes(16, 48)
    assert 2 * gru_ops.smem_bytes(48, 48) < 232448


def test_gru_sequence_rejects_other_devices():
    xs = torch.zeros((1, 2, 4), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        gru_sequence(xs, torch.zeros((4, 6)), torch.zeros((2, 6)), torch.zeros(6), torch.zeros(6))


# ---------------- gru_layer against the reference's ----------------

def _grid(shape, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32) * 3
    return np.array(jq.fake_quant(jnp.asarray(x), jq.ACT_Q6_8))


@pytest.mark.parametrize("quantized", [True, False], ids=["qat", "float"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zeros", "h0"])
def test_gru_layer_matches_the_reference(quantized, with_h0):
    jcfg = jgru.GRUConfig(quantized=quantized)
    tcfg = tgru.GRUConfig(quantized=quantized)
    jp = jgru.init_gru_classifier(jax.random.PRNGKey(3), jcfg)["gru"][0]
    keys = ("w_i", "w_h", "b_i", "b_h")
    tp = dict(zip(keys, convert.gru_layer_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")))
    xs = _grid((5, 9, 16), 4)
    h0 = _grid((5, 48), 5) / 8 if with_h0 else None
    fn = jax.jit(lambda p, x, h: jgru.gru_layer(p, x, jcfg, h0=h))
    jhs, jh = fn(jp, xs, h0)
    ths, th = tgru.gru_layer(tp, torch.from_numpy(xs), tcfg,
                             h0=None if h0 is None else torch.from_numpy(h0))
    assert ths.shape == (5, 9, 48) and th.shape == (5, 48)
    if quantized:
        np.testing.assert_array_equal(ths.numpy(), np.asarray(jhs))
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    else:
        np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), rtol=0, atol=FLOAT_ATOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_array_equal(ths[:, -1].numpy(), th.numpy())


def test_gru_layer_zero_length_returns_h0():
    tp = tgru.init_gru_classifier(tgru.GRUConfig(), torch.Generator().manual_seed(0),
                                  device="cpu")["gru"][0]
    h0 = torch.ones((2, 48))
    hs, h = tgru.gru_layer(tp, torch.zeros((2, 0, 16)), tgru.GRUConfig(), h0=h0)
    assert hs.shape == (2, 0, 48) and torch.equal(h, h0)


# ---------------- weights carried across, and the library's layout ----------------

def test_init_gru_classifier_defaults_to_the_card():
    """No device means the card, as at every entry point of the port: it
    raises where there is none rather than drawing onto the CPU."""
    gen = torch.Generator().manual_seed(0)
    if torch.cuda.is_available():
        params = tgru.init_gru_classifier(tgru.GRUConfig(), gen)
        assert params["fc"]["w"].device.type == "cuda"
        assert all(t.device.type == "cuda" for layer in params["gru"] for t in layer.values())
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tgru.init_gru_classifier(tgru.GRUConfig(), gen)


def test_gru_layer_from_numpy_gives_the_same_sequence():
    """A reference layer's params, through numpy, drive the port's entry
    point to the reference's sequence."""
    jp = jgru.init_gru_classifier(jax.random.PRNGKey(9), jgru.GRUConfig(quantized=False))
    xs = np.random.default_rng(2).standard_normal((6, 62, 16)).astype(np.float32)
    x_j = xs
    x_t = torch.from_numpy(xs)
    for layer in jp["gru"]:
        np_layer = jax.tree_util.tree_map(np.asarray, layer)
        ops = convert.gru_layer_from_numpy(np_layer, "cpu")
        assert [o.dtype for o in ops] == [torch.float32] * 4
        assert tuple(ops[0].shape) == np_layer["w_i"].shape
        x_t = gru_sequence(x_t, *ops)
        x_j = _want(x_j, *(np_layer[k] for k in ("w_i", "w_h", "b_i", "b_h")),
                    np.zeros((6, 48), np.float32))
        np.testing.assert_allclose(x_t.numpy(), x_j, rtol=0, atol=FLOAT_ATOL)


def test_torch_nn_gru_with_the_layers_weights_matches_the_reference():
    """cuDNN's GRU, the library yardstick of the chip run, loaded as the
    chip run loads it (weight_ih = wᵀ, weight_hh = uᵀ, gate order r, z,
    n), computes the reference's sequence."""
    xs, w, u, bi, bh, h0 = _layer(5, 4, 12, 16, 48, h0_scale=1.0)
    gru = torch.nn.GRU(16, 48, batch_first=True)
    with torch.no_grad():
        gru.weight_ih_l0.copy_(torch.from_numpy(w).T)
        gru.weight_hh_l0.copy_(torch.from_numpy(u).T)
        gru.bias_ih_l0.copy_(torch.from_numpy(bi))
        gru.bias_hh_l0.copy_(torch.from_numpy(bh))
        got, h_t = gru(torch.from_numpy(xs), torch.from_numpy(h0)[None])
    want = _want(xs, w, u, bi, bh, h0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=FLOAT_ATOL)
    np.testing.assert_allclose(h_t[0].numpy(), want[:, -1], rtol=0, atol=FLOAT_ATOL)
