"""The port's sharded zamba2 step against the reference's, as
tests/test_torch_ssm_grid.py holds rwkv6's (the same checks, bounds and
draw), for reduced zamba2-7b (8 SSD heads of 16: two a coordinate at
model 4; three applications of its two shared attention + MLP blocks) on
(2, 4), (1, 4) and (2, 2) grids (its prefill and decodes are in
tests/test_torch_ssm_grid_serve.py); and its traps: the per-head leaves cut
to a coordinate's heads, and the gated RMSNorm over the whole d_inner (a
psum of the squares; the norm made local fails)."""

import pytest
import torch

from repro_torch.distributed import sharding as ts
from repro_torch.models import mamba2 as tm2
from test_torch_ssm_grid import (
    B,
    GRIDS,
    REF_TOL,
    S,
    _port,
    _whole_and_pieces,
    batches,
    case_id,
    check_forward,
    check_gradients,
    check_pieces,
    check_steps,
    rel,
)

CASES = [("zamba2-7b", g) for g in GRIDS]


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_pieces_are_shard_shapes(case):
    check_pieces(case)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_forward_follows_the_references(case):
    check_forward(case)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_gradients_follow_the_references(case):
    check_gradients(case)


@pytest.mark.parametrize("case", CASES, ids=case_id)
def test_two_adamw_steps_follow_the_references(case):
    check_steps(case)


def test_mamba2_per_head_leaves_are_cut_to_the_local_heads():
    """On each coordinate the SSD's inputs are the whole layer's at the
    coordinate's heads and d_inner slice: dt_bias, A_log (per head) and
    conv_b (per channel) are cut to them, the conv runs on its channels,
    and the B / C projections stay whole."""
    tcfg, mc, whole, lspecs, pieces = _whole_and_pieces("zamba2-7b")
    x = torch.randn((B, S, tcfg.d_model), generator=torch.Generator().manual_seed(5))
    z, xh, a_log, bmat, cmat, conv = tm2._block_pre(whole, x, tcfg)
    p_ = tcfg.ssm.head_dim
    for c, p in zip(mc.coords, pieces):
        lo, n = tm2._channels(tcfg, lspecs, mc, c)
        assert n == 2 * p_  # two SSD heads a coordinate at model 4
        got = tm2._block_pre(p, x, tcfg, channels=(lo, n))
        heads = slice(lo // p_, (lo + n) // p_)
        for g, w in zip(got, (z[..., lo:lo + n], xh[:, :, heads], a_log[..., heads], bmat,
                              cmat, conv[..., lo:lo + n])):
            torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-6)


def _local_gated_norm(ys, gn, cfg, mc):
    """The fault: each coordinate normalises its own slice of d_inner."""
    return [tm2.rms_norm(y, g, cfg.norm_eps) for y, g in zip(ys, gn)]


def test_zamba2_gated_norm_spans_the_whole_d_inner(monkeypatch):
    """The gated RMSNorm's statistic is a psum of the squares over "model":
    the grid's forward follows the reference's, and with the norm made
    local to each coordinate's slice of d_inner it does not."""
    ref, tb, tcfg, trules, tp = _port("zamba2-7b", (2, 4))
    mc = ts.make_mesh_context(trules)
    batch = batches(tcfg)[0]
    tol = REF_TOL["zamba2-7b"]["fwd"]
    logits, _ = tb.forward(tp, batch, tcfg, mc)
    assert rel(logits.numpy(), ref["logits"]) <= tol
    monkeypatch.setattr(tm2, "_gated_norm_grid", _local_gated_norm)
    logits, _ = tb.forward(tp, batch, tcfg, mc)
    assert rel(logits.numpy(), ref["logits"]) > 20 * tol
