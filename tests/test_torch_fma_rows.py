"""The fit's row chain (`repro_torch.kernels.fma_rows`), held on the CPU:
its plain version against the chain of single-rounded fused multiply-adds
taken step by step (`core.fex.fma_f32`), on seeded rows (also rows whose
sums fall below the smallest normal) and where float64 lands on a
float32 midpoint; and the devices its wrapper refuses. The kernel against
the plain version is in tests/test_torch_kernels_gpu.py."""

import numpy as np
import pytest
import torch

from repro_torch.core.fex import fma_f32
from repro_torch.kernels.fma_rows import fma_rows

# acc, then p = d1 * x1: float64 rounds acc + p onto a float32 midpoint,
# which float32 rounds to even (the last value) while the fused step
# rounds the exact sum back to acc
MIDPOINTS = {
    "normal": (1 + 2.0**-23, 2.0**-24 * (1 + 2.0**-23), 1 - 2.0**-23, 1 + 2.0**-22),
    "subnormal": (2.0**-127 + 2.0**-149, 2.0**-75 * (1 + 2.0**-23), 2.0**-75 * (1 - 2.0**-23),
                  2.0**-127 + 2.0**-148),
}


def _chain(d, xs):
    acc = torch.zeros(xs.shape[1])
    for i in range(xs.shape[0]):
        acc = fma_f32(d[i].expand_as(acc), xs[i], acc)
    return acc


@pytest.mark.parametrize("n,c,tiny", [(0, 3, False), (1, 1, False), (7, 5, False),
                                      (300, 16, False), (992, 16, False), (64, 33, False),
                                      (50, 8, True)])
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


def test_wrapper_refuses_a_device_without_kernel_or_plain_version():
    d = torch.zeros(4, device="meta")
    xs = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        fma_rows(d, xs)
