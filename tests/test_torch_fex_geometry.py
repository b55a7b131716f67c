"""K1's launch geometry (`repro_torch.kernels.fex_fused.ops.fex_geometry`),
held on the CPU: the clips a block, the bulk-copy, fast-body and bulk-store
choices `csrc/fex_fused.cu` is launched with for its two entries (K1 and
the per-sample scan), and the inputs that must raise rather than launch.
The shared-memory layout is the kernel's own (`row_bytes`, `y_stride`)."""

import pytest
import torch

from repro_torch.core.fex import SUM_BLOCK
from repro_torch.kernels.fex_fused.ops import _rows, fex_geometry


def test_the_papers_batch_geometry():
    """K1 on (64, 32 000) oversampled audio trimmed to 62 frames of 512:
    two clips a block (32 filter lanes), bulk copies read the untrimmed
    rows in place, the branch-free 32-sample body."""
    g = fex_geometry(64, 31744, 16, 512, 32000, aligned=True, bf16=False)
    assert (g.clips_per_block, g.bulk, g.fast, g.store_bulk) == (2, True, True, False)


def test_the_papers_scan_geometry():
    """The scan entry on (64, 32 000) duty: bulk copies in, bulk stores of
    y out."""
    g = fex_geometry(64, 32000, 16, None, 32000, aligned=True, bf16=False)
    assert (g.clips_per_block, g.bulk, g.fast, g.store_bulk) == (2, True, False, True)


@pytest.mark.parametrize("frame_len,fast", [(512, True), (SUM_BLOCK, True), (96, True),
                                            (256, True), (1024, True), (100, False),
                                            (20, False), (500, False), (1, False)])
def test_fast_body_needs_frames_of_whole_32_sample_blocks(frame_len, fast):
    """The compile-time body filters 32 samples between frame events (its
    blocks start on the kernel's 256-sample chunk boundaries); other frame
    lengths take the per-sample event loop."""
    g = fex_geometry(3, frame_len * 4, 16, frame_len, frame_len * 4, aligned=True, bf16=False)
    assert g.fast is fast and not g.store_bulk


@pytest.mark.parametrize("b,c,cpb", [(1, 1, 1), (64, 1, 32), (3, 5, 3), (64, 5, 6), (64, 7, 4),
                                     (64, 16, 2), (1, 16, 1), (33, 16, 2), (1, 32, 1),
                                     (3, 33, 1), (2, 100, 1)])
def test_a_block_filters_at_most_one_warp_of_channels(b, c, cpb):
    """32 // C clips a block (C > 32: one clip, 32 of its channels)."""
    for frame_len in (512, None):
        g = fex_geometry(b, 1024, c, frame_len, 1024, aligned=True, bf16=False)
        assert g.clips_per_block == cpb
        assert cpb * min(c, 32) <= 32  # one filter warp


@pytest.mark.parametrize("t,row_stride,aligned,bf16,bulk", [
    (1024, 1024, True, False, True),
    (1024, 1024, False, False, False),  # the base 4 bytes off 16
    (1020, 1020, True, False, True),  # float32: whole 16-byte words from 4 samples
    (1022, 1022, True, False, False),  # a last chunk of 2 samples
    (1022, 1024, True, False, False),
    (1024, 1026, True, False, False),  # rows 8 bytes apart from alignment
    (31744, 32000, True, False, True),  # the paper's trimmed batch
    (1024, 1024, True, True, True),
    (1020, 1020, True, True, False),  # bfloat16: words of 8 samples
    (1016, 1024, True, True, True),
    (1024, 1028, True, True, False),
    (1, 1, True, False, False),  # one sample
])
def test_bulk_copies_need_16_byte_runs(t, row_stride, aligned, bf16, bulk):
    """A clip's run starts 16-byte aligned only where the audio does and
    its row stride is whole 16-byte words; every chunk, the last too, must
    be whole words. Otherwise the producer warp stages by words."""
    frame_len = 4 if t % 4 == 0 else 1
    assert fex_geometry(2, t, 16, frame_len, row_stride, aligned, bf16).bulk is bulk


@pytest.mark.parametrize("t,c,store_bulk", [(32000, 16, True), (1, 16, True), (3, 16, True),
                                            (3, 5, False), (4, 5, True), (1, 4, True),
                                            (1000, 1, True), (1001, 1, False), (1024, 32, True),
                                            (1024, 33, False), (1024, 100, False)])
def test_scan_bulk_stores_need_whole_16_byte_clips(t, c, store_bulk):
    """The scan's y leaves a clip's chunk at a time as T * C contiguous
    floats; bulk stores need T * C a multiple of 4 and a block that holds
    whole rows of y (C <= 32). Otherwise the writer warp copies."""
    assert fex_geometry(2, t, c, None, t, aligned=True, bf16=False).store_bulk is store_bulk


@pytest.mark.parametrize("b,t,c,frame_len,row_stride,bf16", [
    (0, 1024, 16, 512, 1024, False),  # no clips
    (2, 0, 16, 512, 1024, False),  # no samples
    (2, 1024, 0, 512, 1024, False),  # no channels
    (2, 1024, 16, 0, 1024, False),  # no samples a frame
    (2, 1000, 16, 512, 1000, False),  # not whole frames
    (2, 1024, 16, 512, 1000, False),  # rows shorter than the samples read
    (2, 1024, 16, None, 1024, True),  # the scan takes float32 only
])
def test_geometries_that_cannot_launch_raise(b, t, c, frame_len, row_stride, bf16):
    with pytest.raises(ValueError, match="fex geometry"):
        fex_geometry(b, t, c, frame_len, row_stride, aligned=True, bf16=bf16)


def test_a_trimmed_view_is_read_in_place():
    """The wrappers hand the kernel a trimmed view's own rows (its row
    stride beside it); only rows the kernel cannot walk are copied."""
    x = torch.zeros((64, 32000))
    view = x[:, :31744]
    assert _rows(view) is view and view.stride(0) == 32000
    strided = x[::2, :700]
    assert _rows(strided) is strided
    cols = x[:, ::2]  # samples not adjacent
    assert _rows(cols).is_contiguous() and _rows(cols).data_ptr() != x.data_ptr()
    expanded = torch.zeros(1, 100).expand(3, 100)  # rows overlap
    assert _rows(expanded).stride(0) == 100
