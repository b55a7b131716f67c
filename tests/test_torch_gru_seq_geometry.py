"""K6's launch geometry (`kernels/gru/ops.py` `gru_seq_geometry`), held on
the CPU: the instantiation each layer takes, how x is staged for each
dtype, width and base address, the block's threads and shared bytes, and
the layers that raise. The kernel against its plain version is in
tests/test_torch_kernels_gpu.py."""

import pytest

from repro_torch.kernels.gru import ops as gru_ops
from repro_torch.kernels.gru.ops import COPY16, COPY_ELEMS, COPY_WORDS, gru_seq_geometry


def test_the_papers_layers_at_the_main_paths_batch():
    """4096 rows: 256 blocks of 16 rows, 192 threads (8 row groups x 24
    unit pairs), the two compiled widths, 16-byte copies of x."""
    l1 = gru_seq_geometry(4096, 16, 48)
    l2 = gru_seq_geometry(4096, 48, 48)
    assert (l1.rows, l1.blocks, l1.threads, l1.inst, l1.copy) == (16, 256, 192, 1, COPY16)
    assert (l2.rows, l2.blocks, l2.threads, l2.inst, l2.copy) == (16, 256, 192, 2, COPY16)
    assert l1.smem == gru_ops.smem_bytes(16, 48) and l2.smem == gru_ops.smem_bytes(48, 48)
    # bf16 layer 1: the same instantiation, 32-byte runs go by 16-byte copies
    b1 = gru_seq_geometry(4096, 16, 48, x_bf16=True)
    assert (b1.inst, b1.copy, b1.smem) == (1, COPY16, gru_ops.smem_bytes(16, 48, x_bf16=True))


@pytest.mark.parametrize("i,h", [(8, 16), (32, 64), (5, 48), (17, 48), (16, 47), (48, 16),
                                 (1, 1), (64, 96)])
def test_other_widths_take_the_generic_instantiation(i, h):
    geo = gru_seq_geometry(37, i, h)
    assert geo.inst == 0
    assert geo.threads == 8 * -(-h // 2)  # a last unit pair past an odd H is masked
    assert geo.blocks == 3


@pytest.mark.parametrize("i,bf16,offset,copy", [
    (16, False, 0, COPY16), (48, False, 0, COPY16), (16, True, 0, COPY16),
    (8, True, 0, COPY16), (32, False, 0, COPY16),
    # rows not whole 16-byte words: 4-byte words
    (5, False, 0, COPY_WORDS), (17, False, 0, COPY_WORDS), (4, True, 0, COPY_WORDS),
    (12, True, 0, COPY_WORDS), (18, True, 0, COPY_WORDS),
    # a view off 16 bytes: words, whatever the width
    (16, False, 4, COPY_WORDS), (48, False, 8, COPY_WORDS), (16, True, 4, COPY_WORDS),
    (16, True, 12, COPY_WORDS),
    # bf16 runs no cp.async size fits: an odd width, or a base off 4 bytes
    (5, True, 0, COPY_ELEMS), (17, True, 0, COPY_ELEMS), (16, True, 2, COPY_ELEMS),
    (16, True, 6, COPY_ELEMS),
])
def test_the_copy_mode(i, bf16, offset, copy):
    assert gru_seq_geometry(4096, i, 48, x_bf16=bf16, x_offset=offset).copy == copy


def test_shared_bytes_pad_rows_to_16_mod_32():
    """W and U float32, then 2 h tiles and 4 x tiles of 16 padded rows: a
    row is whole 16-byte words, 16 more where that is a multiple of 32."""
    assert gru_ops.smem_bytes(16, 48) == 16 * 144 * 4 + 48 * 144 * 4 + 2 * 16 * 208 + 4 * 16 * 80
    assert gru_ops.smem_bytes(48, 48) == 48 * 144 * 4 + 48 * 144 * 4 + 2 * 16 * 208 + 4 * 16 * 208
    assert gru_ops.smem_bytes(16, 48, x_bf16=True) == (16 * 144 * 4 + 48 * 144 * 4 + 2 * 16 * 208
                                                        + 4 * 16 * 48)
    # odd widths: each region rounded up to 16 bytes
    assert gru_ops.smem_bytes(5, 47) == (5 * 141 * 4 + 12 + 47 * 141 * 4 + 4 + 2 * 16 * 208
                                          + 4 * 16 * 48)
    assert gru_ops.smem_bytes(5, 47, x_bf16=True) == gru_ops.smem_bytes(5, 47) - 4 * 16 * 32


@pytest.mark.parametrize("b,i,h,match", [
    (4, 128, 128, "shared memory"), (4, 1, 133, "shared memory"), (4, 1, 129, "threads"),
    (4, 0, 48, "i=0"),
    (4, 16, 0, "h=0"), (-1, 16, 48, "b=-1"),
])
def test_layers_that_cannot_launch_raise(b, i, h, match):
    with pytest.raises(ValueError, match=match):
        gru_seq_geometry(b, i, h)


def test_the_largest_layer_fits_both_limits():
    """H = 128 is the widest layer: 512 threads, the generic
    instantiation's bound (its shared memory would hold H = 132 at I = 1)."""
    geo = gru_seq_geometry(1, 1, 128)
    assert geo.smem <= 232448 and geo.threads == 512
    assert gru_ops.smem_bytes(1, 132) <= 232448 < gru_ops.smem_bytes(1, 133)


def test_an_empty_batch_launches_no_block():
    assert gru_seq_geometry(0, 16, 48).blocks == 0
