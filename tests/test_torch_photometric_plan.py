"""The photometric kernel's launch plan (tdeed_tpu_torch/kernels/augment.py:
photometric_plan), a pure function: shared memory within a block's 227 KB,
portable clusters, every row of the frame in exactly one band, and each
band's blur halo inside the frame or reflected into it."""

import pytest
import torch

from tdeed_tpu_torch.kernels import augment
from tdeed_tpu_torch.kernels.augment import photometric_plan, photometric_smem

SHAPES = [(224, 224), (256, 256), (448, 796), (37, 61), (11, 19), (3, 3)]
DTYPES = [torch.uint8, torch.bfloat16]


def bands(p):
    """[(first row, end row)] of each CTA's band, as csrc/photometric.cu
    cuts them."""
    return [(r * p.rows, min(p.h, (r + 1) * p.rows)) for r in range(p.cluster)]


def reflect(i, n):
    """The kernel's width-2 reflect padding of index i into [0, n)."""
    i = -i if i < 0 else i
    return 2 * (n - 1) - i if i >= n else i


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_plan_fits_a_block_and_a_portable_cluster(hw, dtype):
    p = photometric_plan(*hw, dtype)
    assert p.smem_bytes <= 232_448
    assert p.smem_bytes == photometric_smem(hw[1], 1 if dtype == torch.uint8 else 2, p.chunk)
    assert 1 <= p.cluster <= 8
    assert 1 <= p.chunk <= min(8, p.rows)


@pytest.mark.parametrize("hw", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_bands_cover_every_row_once_and_halos_stay_in_the_frame(hw, dtype):
    h, w = hw
    p = photometric_plan(h, w, dtype)
    cut = bands(p)
    assert len(cut) == p.cluster
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


def test_plan_at_the_flagship_and_its_limits():
    p = photometric_plan(224, 224, torch.bfloat16)
    assert (p.cluster, p.rows) == (4, 56) and p.chunk >= 4
    assert 3 * (p.smem_bytes + 1024) <= 232_448  # three blocks share an SM
    assert bands(photometric_plan(57, 224, torch.uint8)) == [(0, 29), (29, 57)]
    assert photometric_plan(448, 796, torch.bfloat16).chunk == 1
    assert photometric_plan(4000, 64, torch.uint8).cluster == augment.MAX_CLUSTER
    with pytest.raises(ValueError):
        photometric_plan(224, 2000, torch.bfloat16)  # a one-row chunk exceeds 227 KB
    with pytest.raises(ValueError):
        photometric_plan(2, 224, torch.uint8)


def test_reflect_pads_by_two():
    assert [reflect(i, 5) for i in range(-2, 7)] == [2, 1, 0, 1, 2, 3, 4, 3, 2]
