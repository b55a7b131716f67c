"""How the CUDA tick's ΔGRU branch (K4) stages its state, held on the CPU:
`repro_torch.kernels.tick_fused.ops.delta_staging` decides, from the
eight arrays' addresses, which go by one bulk copy a block and which by
cp.async words, and raises for what the kernel cannot take. The kernel
against its plain version is in tests/test_torch_kernels_gpu.py."""

import pytest
import torch

from repro_torch.core.gru_delta import DeltaConfig
from repro_torch.core.pipeline import KWSPipeline, KWSPipelineConfig
from repro_torch.kernels.tick_fused.ops import DELTA_ROW_BYTES, delta_staging

KEYS = ("x_ref", "h_ref", "acc_x", "acc_h")


def _addresses(states):
    return [st[key].data_ptr() for st in states for key in KEYS]


def test_rows_are_whole_16_byte_words_of_the_state_arrays():
    """A block's 16 rows of every staged array are one run of whole
    16-byte words, in the order of the kernel's struct GruState."""
    states = KWSPipeline(KWSPipelineConfig(classifier="delta", delta=DeltaConfig(0.1, 0.1))
                         ).streaming_init(5, "cpu")
    assert DELTA_ROW_BYTES == tuple(st[key].shape[1] * 4 for st in states for key in KEYS)
    assert all(b % 16 == 0 for b in DELTA_ROW_BYTES)


@pytest.mark.parametrize("classifier", ["delta", "delta-int"])
def test_a_fresh_state_goes_by_bulk_copies(classifier):
    """Freshly allocated arrays start on 16-byte boundaries: every bit set."""
    states = KWSPipeline(KWSPipelineConfig(classifier=classifier, delta=DeltaConfig(0.1, 0.1))
                         ).streaming_init(37, "cpu")
    assert delta_staging(_addresses(states)) == 0xFF


@pytest.mark.parametrize("k", range(8))
@pytest.mark.parametrize("offset", [4, 8, 12])
def test_an_array_off_16_bytes_goes_by_words(k, offset):
    """Only the array whose base is off 16 bytes loses its bit."""
    addresses = [0x10000 * (i + 1) for i in range(8)]
    addresses[k] += offset
    assert delta_staging(addresses) == 0xFF & ~(1 << k)


def test_a_state_in_one_buffer_off_a_word():
    """The eight arrays carved one after another out of one buffer, one
    word in: every run is whole 16-byte words, so every base stays one
    word off and every array goes by words."""
    n = 3
    sizes = [n * b // 4 for b in DELTA_ROW_BYTES]
    buf = torch.zeros(1 + sum(sizes), dtype=torch.float32)
    views, pos = [], 1
    for size in sizes:
        views.append(buf[pos:pos + size])
        pos += size
    assert delta_staging(v.data_ptr() for v in views) == 0


@pytest.mark.parametrize("addresses,match", [
    ([16] * 7, "takes 8 addresses"), ([16] * 9, "takes 8 addresses"),
    ([16] * 7 + [18], "multiple of 4"), ([16] * 7 + [0], "multiple of 4")])
def test_what_the_kernel_cannot_take_raises(addresses, match):
    with pytest.raises(ValueError, match=match):
        delta_staging(addresses)
