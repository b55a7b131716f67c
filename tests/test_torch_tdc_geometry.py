"""K5's launch geometry (`repro_torch.kernels.tdc.ops.tdc_geometry`), held
on the CPU: the clips a block, the bulk-copy and fast-path choices
`csrc/tdc.cu` is launched with, and the inputs that must raise rather than
launch. The shared-memory layout is the kernel's own (`ring_stride`)."""

import pytest

from repro_torch.kernels.tdc.ops import CHUNK, tdc_geometry


def test_the_papers_batch_geometry():
    """(64, 31 744, 16) at os = 2: two clips a block (32 carry lanes),
    chunks of 128 that end on the 512-sample frames, bulk copies."""
    g = tdc_geometry(64, 31744, 16, 512, 2)
    assert (g.clips_per_block, g.bulk, g.fast) == (2, True, True)


@pytest.mark.parametrize("os_,spf,fast", [(1, 1024, False), (2, 512, True), (3, 341, False),
                                          (4, 256, False), (2, 384, True), (2, 320, False),
                                          (2, 64, False), (2, CHUNK, True)])
def test_fast_path_needs_os_2_and_frames_on_chunk_boundaries(os_, spf, fast):
    """The fast carry loop's trip count is the kernel's compile-time chunk
    (128 samples): frames must end on its boundaries."""
    assert tdc_geometry(3, spf * 2, 16, spf, os_).fast is fast


@pytest.mark.parametrize("b,c,cpb", [(1, 1, 1), (64, 1, 32), (3, 5, 3), (64, 5, 6), (64, 16, 2),
                                     (1, 32, 1), (3, 33, 1), (2, 100, 1)])
def test_a_block_carries_at_most_one_warp_of_channels(b, c, cpb):
    """32 // C clips a block (C > 32: one clip, 32 of its channels)."""
    g = tdc_geometry(b, 1024, c, 512, 2)
    assert g.clips_per_block == cpb
    assert cpb * min(c, 32) <= 32  # one carry warp


@pytest.mark.parametrize("t,c,aligned,bulk", [(1024, 16, True, True), (1024, 16, False, False),
                                              (1023, 16, True, True), (341 * 3, 5, True, False),
                                              (341 * 4, 5, True, True), (1024, 33, True, False)])
def test_bulk_copies_need_16_byte_runs(t, c, aligned, bulk):
    """A clip's run of T * C words starts 16-byte aligned only where the
    input is and T * C is a multiple of 4; C > 32 splits rows and is
    loaded by the helper warp."""
    spf = t // 3 if t % 3 == 0 else t
    assert tdc_geometry(2, t, c, spf, 2, aligned=aligned).bulk is bulk


@pytest.mark.parametrize("t,spf,clip_samples,bulk", [(1024, 512, 1024, True),
                                                     (1024, 512, 1025, False),
                                                     (1024, 512, 1028, True),
                                                     (341, 341, 348, False),
                                                     (341 * 4, 341, 341 * 4 + 4, True)])
def test_a_clip_longer_than_its_counted_frames_is_read_in_place(t, spf, clip_samples, bulk):
    """The kernel counts the first t samples of clips of ``clip_samples``:
    bulk copies need each clip's run to start 16-byte aligned and every
    chunk, the last (t mod 128 samples) too, to be whole 16-byte words."""
    assert tdc_geometry(2, t, 5, spf, 3, clip_samples=clip_samples).bulk is bulk


@pytest.mark.parametrize("b,t,c,spf,os_,clip_samples", [
    (0, 1024, 16, 512, 2, None),  # no clips
    (2, 0, 16, 512, 2, None),  # no samples
    (2, 1024, 0, 512, 2, None),  # no channels
    (2, 1024, 16, 0, 2, None),  # no samples a frame
    (2, 1024, 16, 512, 0, None),  # no ticks a sample
    (64, 1000, 16, 512, 2, None),  # not whole frames
    (2, 1024, 16, 512, 2, 1000),  # clips shorter than the counted samples
])
def test_geometries_that_cannot_launch_raise(b, t, c, spf, os_, clip_samples):
    with pytest.raises(ValueError, match="tdc geometry"):
        tdc_geometry(b, t, c, spf, os_, clip_samples=clip_samples)
