"""The port's software frontend against the reference's XLA tier.

Over 64 consecutive raw-audio hops, the streaming frontend's FV_Raw
codes, FV_Norm frames and (s1, s2) filter carry are array-equal to
`repro.core.pipeline.KWSPipeline` (watch item W2: the IIR rounds like
the reference's compiled scan, fused multiply-adds included).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import fex as jfex
from repro.core import quant as jq
from repro.core.frontend import FrontendState as JState
from repro.core.frontend import available_frontends as j_available_frontends
from repro.core.frontend import get_frontend as j_get_frontend
from repro.core.pipeline import KWSPipeline as JPipeline
from repro.core.pipeline import KWSPipelineConfig as JConfig
from repro_torch import convert
from repro_torch.core import fex as tfex
from repro_torch.core.frontend import (
    FrontendState,
    available_frontends,
    get_frontend,
    masked_select,
    tree_clone,
    tree_leaves,
)
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig

N_STREAMS = 5
N_HOPS = 64


@pytest.fixture(scope="module")
def norm_stats():
    rng = np.random.default_rng(0)
    audio = jnp.asarray(rng.standard_normal((4, 8000)).astype(np.float32) * 0.05)
    _, raw = JPipeline(JConfig(use_norm=False)).features(audio)
    return jfex.fit_norm_stats(jq.log_compress_lut(raw, 12, 10))


def test_streaming_frontend_matches_over_64_hops(norm_stats):
    jpipe = JPipeline(JConfig(), norm_stats=norm_stats)
    tstats = convert.norm_stats_from_numpy(
        np.asarray(norm_stats.mu), np.asarray(norm_stats.sigma), "cpu"
    )
    tpipe = KWSPipeline(KWSPipelineConfig(), norm_stats=tstats)
    jcarry = jpipe.streaming_features_init(N_STREAMS)
    tcarry = tpipe.streaming_features_init(N_STREAMS, device="cpu")
    rng = np.random.default_rng(1)
    # loud and quiet streams, so codes span the quantizer's range
    gains = np.array([0.02, 0.05, 0.1, 0.3, 0.6], np.float32)[:, None]
    raw_codes = []
    for _ in range(N_HOPS):
        hop = (rng.standard_normal((N_STREAMS, 256)) * gains).astype(np.float32)
        jcarry, jfv, jraw = jpipe._sfeatures_jit(
            jcarry, jnp.asarray(hop), jpipe.state, None
        )
        # streaming_features_apply is exactly these two stages
        tcarry, traw = tpipe.frontend.streaming_step(
            torch.from_numpy(hop), tpipe.config, tpipe.state, tcarry
        )
        tfv = tpipe.features_from_raw(traw)
        np.testing.assert_array_equal(traw.numpy(), np.asarray(jraw))
        np.testing.assert_array_equal(tfv.numpy(), np.asarray(jfv))
        for k in ("s1", "s2"):
            np.testing.assert_array_equal(tcarry[k].numpy(), np.asarray(jcarry[k]))
        raw_codes.append(traw.numpy())
    raw_codes = np.stack(raw_codes)
    assert len(np.unique(raw_codes)) > 200  # a real spread of codes


def test_batch_fex_forward_matches(norm_stats):
    rng = np.random.default_rng(2)
    audio = (rng.standard_normal((2, 1024)) * 0.1).astype(np.float32)
    cfg = jfex.FExConfig()
    jnorm, jraw = jax.jit(
        lambda a: jfex.fex_forward(a, cfg, norm_stats)
    )(jnp.asarray(audio))
    tstats = convert.norm_stats_from_numpy(
        np.asarray(norm_stats.mu), np.asarray(norm_stats.sigma), "cpu"
    )
    tnorm, traw = tfex.fex_forward(torch.from_numpy(audio), tfex.FExConfig(), tstats)
    np.testing.assert_array_equal(traw.numpy(), np.asarray(jraw))
    np.testing.assert_array_equal(tnorm.numpy(), np.asarray(jnorm))


def test_filterbank_design_matches():
    j, t = jfex.FExConfig().filterbank(), tfex.FExConfig().filterbank()
    for row in ("b0", "b1", "b2", "a1", "a2", "f0"):
        np.testing.assert_array_equal(getattr(t, row), getattr(j, row))
    np.testing.assert_array_equal(
        t.stacked(device="cpu").numpy(), np.asarray(j.stacked(dtype=jnp.float32))
    )


@pytest.mark.parametrize("coeffs", ["nominal", "designed"])
def test_software_raw_codes_match(coeffs):
    """The batch frontend path, with the nominal filterbank and with
    coefficients carried in the frontend state."""
    audio = (np.random.default_rng(5).standard_normal((3, 1536)) * 0.1).astype(np.float32)
    stacked = None
    if coeffs == "designed":
        fexc = jfex.FExConfig(q=2.5)
        stacked = np.array(fexc.filterbank().stacked(dtype=jnp.float32))
    jcfg, tcfg = JConfig(), KWSPipelineConfig()
    want = jax.jit(
        lambda a, c: j_get_frontend("software").raw_codes(a, jcfg, JState(coeffs=c))
    )(jnp.asarray(audio), None if stacked is None else jnp.asarray(stacked))
    got = get_frontend("software").raw_codes(
        torch.from_numpy(audio), tcfg,
        FrontendState(coeffs=None if stacked is None else torch.from_numpy(stacked)),
    )
    assert got.shape == (3, 6, 16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# Row counts of the norm-stat fits: one fused loop (N <= 32, the sum of
# squares contracted into FMAs), odd pads (33: 15 + 16 zeros, 63: 0 + 1),
# even ones (62: 1 + 1, 496 and 4464: 8 + 8), and 74 400 = 12 classes x
# 100 clips x 62 frames, windowed three times (2325, 73, then 3 window
# sums; 5 + 6 and 11 + 12 zeros).
FIT_ROWS = [21, 32, 33, 62, 63, 496, 4464, 74400]


@pytest.mark.parametrize("rows", FIT_ROWS)
def test_fit_norm_stats_matches(rows):
    """mu and sigma array-equal to the reference's eager fit."""
    x = np.random.default_rng([3, rows]).random((rows, 16)).astype(np.float32) * 900
    x = x.reshape(-1, 62 if rows % 62 == 0 else rows, 16)
    j = jfex.fit_norm_stats(jnp.asarray(x))
    t = tfex.fit_norm_stats(torch.from_numpy(x))
    np.testing.assert_array_equal(t.mu.numpy(), np.asarray(j.mu))
    np.testing.assert_array_equal(t.sigma.numpy(), np.asarray(j.sigma))


@pytest.mark.parametrize("rows", [0, 1, 31, 32, 33, 63, 96, 1025, 74400])
def test_xla_sum_matches_the_references_sum(rows):
    """`xla_sum` over (N, C) and over one column against the reference's
    eager ``jnp.sum(x, 0)``: the column form is the detector fit's
    (`serving.cascade`)."""
    x = np.random.default_rng(rows).standard_normal((rows, 5)).astype(np.float32)
    np.testing.assert_array_equal(tfex.xla_sum(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.sum(jnp.asarray(x), 0)))
    col = np.ascontiguousarray(x[:, 2])
    np.testing.assert_array_equal(tfex.xla_sum(torch.from_numpy(col)).numpy(),
                                  np.asarray(jnp.sum(jnp.asarray(col))))


def test_oversample2x_matches():
    x = np.random.default_rng(4).standard_normal((3, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        tfex.oversample2x(torch.from_numpy(x)).numpy(),
        np.asarray(jfex.oversample2x(jnp.asarray(x))),
    )


def test_frontend_registry_names_the_references_frontends():
    assert available_frontends() == ("hardware", "hardware-pallas", "software")
    assert set(available_frontends()) == set(j_available_frontends())
    for name in available_frontends():
        assert get_frontend(name).name == name
    with pytest.raises(KeyError, match="registered frontends: \\['hardware', 'hardware-pallas', 'software'\\]"):
        get_frontend("bogus")


def test_masked_select_keeps_idle_rows_exactly():
    mask = torch.tensor([True, False, True])
    new = {"a": torch.ones(3, 2), "b": (torch.zeros(3), torch.full((3,), 5.0))}
    old = {"a": torch.full((3, 2), -1.0), "b": (torch.ones(3), torch.ones(3))}
    out = masked_select(mask, new, old)
    np.testing.assert_array_equal(out["a"].numpy(), [[1, 1], [-1, -1], [1, 1]])
    np.testing.assert_array_equal(out["b"][1].numpy(), [5, 1, 5])


def test_tree_leaves_and_clone_walk_dense_and_delta_states_alike():
    dense = (torch.ones(3, 2), torch.zeros(3, 2))
    delta = ({"h": torch.ones(3, 2), "skipped": torch.zeros(3, dtype=torch.int32)},)
    tree = (dense, delta, {"s1": torch.full((3,), 2.0)}, torch.zeros(3, 4))
    leaves = tree_leaves(tree)
    assert [tuple(t.shape) for t in leaves] == [(3, 2), (3, 2), (3, 2), (3,), (3,), (3, 4)]
    assert leaves[3].dtype == torch.int32
    copy = tree_clone(tree)
    assert type(copy[1][0]) is dict and list(copy[1][0]) == ["h", "skipped"]
    for a, b in zip(tree_leaves(copy), leaves):
        assert torch.equal(a, b) and a.data_ptr() != b.data_ptr()
    # masked_select walks the same order
    mask = torch.tensor([True, False, True])
    picked = masked_select(mask, copy, tree)
    assert len(tree_leaves(picked)) == len(leaves)
