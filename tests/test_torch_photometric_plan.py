"""The photometric kernel's launch plan (tdeed_tpu_torch/kernels/augment.py:
photometric_plan), a pure function: shared memory within a block's 227 KB,
portable clusters, every pixel of the frame in exactly one (band, column
segment), and each band's and segment's blur halo inside the frame or
reflected into it."""

import numpy as np
import pytest
import torch

from tdeed_tpu_torch.kernels import augment
from tdeed_tpu_torch.kernels.augment import max_width, photometric_plan, photometric_smem

# one segment; then frames wider than a one-row chunk of the whole width
# fits (2 to 8 segments, the last one ragged at 2000, 5001 and 8192 bf16)
SHAPES = [(224, 224), (256, 256), (448, 796), (37, 61), (11, 19), (3, 3),
          (1080, 1920), (16, 2200), (224, 2000), (7, 5001), (16, 8192), (5, 14_712)]
DTYPES = [torch.uint8, torch.bfloat16]
DEEP_STAGES = 4  # csrc/photometric.cu:kDeep, stages of the sweeps without the blur


def bands(p):
    """[(first row, end row)] of each band, as csrc/photometric.cu cuts them."""
    return [(r * p.rows, min(p.h, (r + 1) * p.rows)) for r in range(p.bands)]


def segments(p):
    """[(first column, end column)] of each column segment."""
    return [(s * p.seg_w, min(p.w, (s + 1) * p.seg_w)) for s in range(p.segments)]


def reflect(i, n):
    """The kernel's width-2 reflect padding of index i into [0, n)."""
    i = -i if i < 0 else i
    return 2 * (n - 1) - i if i >= n else i


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_a_block_and_a_portable_cluster(hw, dtype):
    p = photometric_plan(*hw, dtype)
    in_bytes = 1 if dtype == torch.uint8 else 2
    segmented = p.segments > 1
    assert p.smem_bytes <= 232_448
    assert p.smem_bytes == photometric_smem(p.seg_w, in_bytes, p.chunk, segmented)
    assert 1 <= p.cluster == p.bands * p.segments <= 8
    assert 1 <= p.chunk <= min(8, p.rows)
    assert (p.seg_w == hw[1]) == (not segmented)
    # the sweeps without the blur lay their stages of chunk rows
    # (csrc/photometric.cu:deep_stage_bytes) over the ring and the two blur
    # stages: they fit under the tile
    ring_and_stages = p.smem_bytes - augment.SMEM_HEADER - augment._rows_bytes(
        p.chunk, p.seg_w, 2, segmented)
    deep = DEEP_STAGES * augment._rows_bytes(p.chunk, p.seg_w, in_bytes, segmented)
    assert deep <= ring_and_stages
    if segmented:  # csrc/photometric.cu caps the segmented kernel at 2 blocks an SM
        assert 3 * (p.smem_bytes + 1024) > 232_448


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bands_cover_every_row_once_and_halos_stay_in_the_frame(hw, dtype):
    h, w = hw
    p = photometric_plan(h, w, dtype)
    cut = bands(p)
    assert len(cut) == p.bands
    rows = [y for r0, r1 in cut for y in range(r0, r1)]
    assert rows == list(range(h))  # each row once, in order
    for r0, r1 in cut:
        assert r0 < r1  # no empty band
        for y in (r0 - 2, r0 - 1, r1, r1 + 1):
            assert 0 <= reflect(y, h) < h
        # the rows a chunk stages (csrc/photometric.cu:new_rows) never
        # exceed the stage's chunk + 4
        for y in range(r0, r1, p.chunk):
            first = max(0, y - 2) if y == r0 else min(h, y + 2)
            assert min(h, min(r1, y + p.chunk) + 2) - first <= p.chunk + 4


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bands_and_segments_cover_every_pixel_once(hw, dtype):
    """The CTAs of a cluster, rank r as band r // segments and segment
    r % segments, cover each (row, column) of the frame exactly once."""
    h, w = hw
    p = photometric_plan(h, w, dtype)
    hits = np.zeros((h, w), np.int32)
    for rank in range(p.cluster):
        (r0, r1), (s0, s1) = bands(p)[rank // p.segments], segments(p)[rank % p.segments]
        assert r0 < r1 and s0 < s1  # no CTA without pixels
        hits[r0:r1, s0:s1] += 1
    assert (hits == 1).all()


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("flip", [False, True])
def test_segment_halos_stay_in_the_staged_columns(hw, dtype, flip):
    """A segment's blur reads its output columns s0 - 2 .. s1 + 1, reflected
    into the frame, from source columns w - 1 - c under the flip; the kernel
    stages source columns [max(0, c0 - 2), min(w, c0 + sw + 2)) for the
    segment's own source columns [c0, c0 + sw), within a slot of seg_w + 4."""
    h, w = hw
    p = photometric_plan(h, w, dtype)
    for s0, s1 in segments(p):
        sw = s1 - s0
        c0 = w - s0 - sw if flip else s0
        lo, hi = max(0, c0 - 2), min(w, c0 + sw + 2)
        assert hi - lo <= p.seg_w + 4
        for col in range(s0 - 2, s1 + 2):
            pc = reflect(col, w)
            assert 0 <= pc < w
            src = w - 1 - pc if flip else pc
            assert lo <= src < hi, (col, src, lo, hi)


def test_plan_at_the_flagship_and_its_limits():
    p = photometric_plan(224, 224, torch.bfloat16)
    assert (p.bands, p.rows, p.segments, p.seg_w) == (4, 56, 1, 224) and p.chunk >= 4
    assert (p.cluster, p.chunk, p.smem_bytes) == (4, 8, 75_440)  # as before segments
    assert 3 * (p.smem_bytes + 1024) <= 232_448  # three blocks share an SM
    assert bands(photometric_plan(57, 224, torch.uint8)) == [(0, 29), (29, 57)]
    assert photometric_plan(448, 796, torch.bfloat16).chunk == 1
    assert photometric_plan(4000, 64, torch.uint8).cluster == augment.MAX_CLUSTER
    # the width a one-row chunk of the whole frame fits: one segment up to
    # it, two beyond
    assert photometric_plan(224, 1843, torch.bfloat16).segments == 1
    assert photometric_plan(224, 1844, torch.bfloat16).segments == 2
    assert photometric_plan(224, 2419, torch.uint8).segments == 1
    assert photometric_plan(224, 2420, torch.uint8).segments == 2
    wide = photometric_plan(224, 2000, torch.bfloat16)  # refused before segments
    assert (wide.bands, wide.rows, wide.segments, wide.seg_w) == (4, 56, 2, 1000)
    assert photometric_plan(1080, 1920, torch.bfloat16).cluster == 8
    assert photometric_plan(16, 2200, torch.uint8).segments == 1
    for dtype in DTYPES:
        assert max_width(dtype) >= 8192
        assert photometric_plan(3, max_width(dtype), dtype).segments == augment.MAX_CLUSTER
        with pytest.raises(ValueError, match=str(max_width(dtype))):
            photometric_plan(3, max_width(dtype) + 1, dtype)  # beyond 8 segments
    assert (max_width(torch.bfloat16), max_width(torch.uint8)) == (14_712, 19_328)
    with pytest.raises(ValueError):
        photometric_plan(2, 224, torch.uint8)


def test_reflect_pads_by_two():
    assert [reflect(i, 5) for i in range(-2, 7)] == [2, 1, 0, 1, 2, 3, 4, 3, 2]
