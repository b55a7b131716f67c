"""The fit's row chain (`repro_torch.kernels.fma_rows`), held on the CPU:
its plain version against the chain of single-rounded fused multiply-adds
taken step by step (`core.fex.fma_f32`), on seeded rows (also rows whose
sums fall below the smallest normal) and where float64 lands on a
float32 midpoint; at one channel against the reference's compiled dot;
the devices its wrapper refuses; and the kernel's launch geometry
(`fma_rows_geometry`: rows a chunk, chunks in flight, channels a block,
which inputs go by bulk copy, what raises). The kernel against the
plain version is in tests/test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

from repro_torch.core.fex import fma_f32
from repro_torch.kernels.fma_rows import fma_rows
from repro_torch.kernels.fma_rows import ops as fma_ops
from repro_torch.kernels.fma_rows.ops import fma_rows_geometry
from repro_torch.kernels.fma_rows.ref import FUSED_ROWS, HEAD_ROWS, head_channel

# acc, then p = d1 * x1: float64 rounds acc + p onto a float32 midpoint,
# which float32 rounds to even (the last value) while the fused step
# rounds the exact sum back to acc
MIDPOINTS = {
    "normal": (1 + 2.0**-23, 2.0**-24 * (1 + 2.0**-23), 1 - 2.0**-23, 1 + 2.0**-22),
    "subnormal": (2.0**-127 + 2.0**-149, 2.0**-75 * (1 + 2.0**-23), 2.0**-75 * (1 - 2.0**-23),
                  2.0**-127 + 2.0**-148),
}


def _chain(d, xs):
    """The chain step by step, channel by channel; on the head channel (at
    one channel past 32 rows; channel 0 at C = 2 and channel C - 1 at
    C = 8k + 1, from 3 rows) its first 8 rows multiplied and added apart."""
    n, c = xs.shape
    out = torch.zeros(c)
    for j in range(c):
        head = HEAD_ROWS if j == head_channel(n, c) else 0
        acc = torch.zeros(())
        for i in range(n):
            if i < head:
                acc = d[i] * xs[i, j] if i == 0 else acc + d[i] * xs[i, j]
            else:
                acc = fma_f32(d[i], xs[i, j], acc)
        out[j] = acc
    return out


@pytest.mark.parametrize("n,c,want", [
    (0, 1, -1), (32, 1, -1), (33, 1, 0), (2, 2, -1), (3, 2, 0), (600, 2, 0), (2, 9, -1),
    (3, 9, 8), (602, 17, 16), (992, 16, -1), (5, 3, -1), (600, 10, -1), (40, 257, 256)])
def test_head_channel(n, c, want):
    """The channel XLA's compiled GEMV takes apart in its first row tile."""
    assert head_channel(n, c) == want


@pytest.mark.parametrize("n,c,tiny", [(0, 3, False), (1, 1, False), (7, 5, False),
                                      (300, 16, False), (992, 16, False), (64, 33, False),
                                      (50, 8, True), (5, 1, False), (32, 1, False),
                                      (33, 1, False), (600, 1, False), (50, 1, True),
                                      (2, 2, False), (3, 2, False), (602, 2, False),
                                      (6, 9, False), (994, 17, False), (50, 9, True),
                                      (300, 257, False)])
def test_plain_version_is_the_fused_chain(n, c, tiny):
    """``tiny``: products of ~1e-30 and ~1e-10, summed in float32's
    subnormal range."""
    rng = np.random.default_rng(n + c)
    d_scale, x_scale = (1e-30, 1e-10) if tiny else (1e-3, 1.0)
    d = torch.from_numpy(rng.normal(size=n).astype(np.float32) * np.float32(d_scale))
    xs = torch.from_numpy(rng.normal(size=(n, c)).astype(np.float32) * np.float32(x_scale))
    got = fma_rows(d, xs)
    assert got.dtype == torch.float32 and got.shape == (c,)
    assert torch.equal(got, _chain(d, xs))
    if tiny:
        assert bool((got != 0).any())


@pytest.mark.parametrize("case", sorted(MIDPOINTS))
def test_a_float64_midpoint_takes_the_fused_chain(case):
    acc, d1, x1, twice = MIDPOINTS[case]
    d = torch.tensor([1.0, d1], dtype=torch.float32)
    xs = torch.tensor([[acc], [x1]], dtype=torch.float32)
    assert np.float32(np.float64(acc) + np.float64(d1) * np.float64(x1)) == np.float32(twice)
    got = fma_rows(d, xs)
    assert got.item() == acc
    assert torch.equal(got, _chain(d, xs))


@pytest.mark.parametrize("n", [33, 64, 600, 605, 1000])
def test_one_channel_is_xlas_column_major_gemv(n):
    """At one channel and more than 32 rows the chain is the reference's
    compiled vector dot: its first 8 rows multiplied and added apart, the
    rest fused. A midpoint in the head rounds twice, where the fused chain
    would not. (Up to 32 rows the fit's dot is fused into its elementwise
    work, unlike a dot of its own: tests/test_torch_cascade.py holds that.)"""
    jax = pytest.importorskip("jax")
    dot = jax.jit(lambda a, b: a @ b)
    for seed in range(10):
        rng = np.random.default_rng(seed)
        d = rng.normal(size=n).astype(np.float32) * np.float32(1e-3)
        x = rng.normal(size=n).astype(np.float32)
        got = fma_rows(torch.from_numpy(d), torch.from_numpy(x)[:, None])
        assert got.item() == float(dot(d, x))
    acc, d1, x1, twice = MIDPOINTS["normal"]
    zeros = [0.0] * (FUSED_ROWS - 1)  # rows past the head, so that it is taken
    d = torch.tensor([1.0, d1] + zeros)
    assert fma_rows(d, torch.tensor([acc, x1] + zeros)[:, None]).item() == twice


def test_wrapper_refuses_a_device_without_kernel_or_plain_version():
    d = torch.zeros(4, device="meta")
    xs = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fma_rows(d, xs)


def test_the_fits_geometry():
    """(992, 16): chunks of 256 rows, all 4 in flight at once, one block,
    both inputs by bulk copies only."""
    g = fma_rows_geometry(992, 16)
    assert (g.rows, g.stages, g.cols, g.blocks, g.bulk_d, g.bulk_x, g.bulk_only) == (
        256, 4, 16, 1, True, True, True)
    assert fma_ops.stage_bytes(256, 16) == 4 * (256 * 17 + 16 * 260 + 8)
    assert g.smem == fma_ops.BARRIER_BYTES + 4 * fma_ops.stage_bytes(256, 16) and g.flags == 7
    assert g.threads == 32 * (1 + 1 + fma_ops.HELPERS)


@pytest.mark.parametrize("n", [0, 1, 7, 992, 3000])
@pytest.mark.parametrize("c", [1, 5, 12, 16, 20, 33, 200, 256, 257, 1000])
def test_geometry_fits_the_kernels_limits(n, c):
    """Whole groups of 8 rows a chunk (so every chunk of an aligned input
    starts on a 16-byte boundary, C = 5's 20-byte rows too, and the
    column-major copy's columns are whole 16-byte words), at most 16
    chunks in flight and no more than the input has, the ring within
    192 KiB, at most 256 channels a block covering all C."""
    g = fma_rows_geometry(n, c)
    assert g.rows % fma_ops.GROUP == 0 and (4 * g.rows * c) % 16 == 0 and (g.rows + 4) % 4 == 0
    assert 1 <= g.stages <= min(fma_ops.MAX_STAGES, max(1, -(-n // g.rows)))
    assert g.cols == min(c, fma_ops.MAX_COLS) and g.blocks * g.cols >= c > (g.blocks - 1) * g.cols
    assert g.smem == fma_ops.BARRIER_BYTES + g.stages * fma_ops.stage_bytes(g.rows, c)
    assert g.smem - fma_ops.BARRIER_BYTES <= fma_ops.RING_BYTES


@pytest.mark.parametrize("n,d_aligned,x_aligned,c,bulk", [
    (100, True, True, 16, (True, True, True)), (100, False, True, 16, (False, True, False)),
    (100, True, False, 5, (True, False, False)), (100, False, False, 5, (False, False, False)),
    (100, True, True, 257, (True, False, False)), (101, True, True, 16, (True, True, False)),
    (100, True, True, 5, (True, True, True)), (99, True, True, 4, (True, True, False)),
    (98, True, True, 6, (True, True, False))])
def test_bulk_copies_need_an_aligned_base_and_whole_rows(n, d_aligned, x_aligned, c, bulk):
    """An input off 16 bytes goes by cp.async words; so do the rows of a
    block that owns a slice of them (C > 256); a ragged last chunk's words
    past its whole 16-byte words (N or N C not a multiple of 4) go by words
    too, so only a launch with none of these is bulk copies only."""
    g = fma_rows_geometry(n, c, d_aligned, x_aligned)
    assert (g.bulk_d, g.bulk_x, g.bulk_only) == bulk


@pytest.mark.parametrize("n,c", [(-1, 4), (4, 0), (4, -3)])
def test_geometry_raises_where_nothing_can_be_launched(n, c):
    with pytest.raises(ValueError, match="fma_rows geometry"):
        fma_rows_geometry(n, c)
