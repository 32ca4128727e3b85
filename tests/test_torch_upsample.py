"""The SGP-Mixer's upsample kernels' host side (tdeed_tpu_torch/kernels/
upsample.py) on the CPU, where the kernels themselves do not run (they are
held against ATen on the card by tests/test_torch_upsample_gpu.py):

- ``upsample_plan``'s grid, replayed index by index as csrc/upsample.cu
  walks it, stages each element of a block's slab once and writes each
  output element once, its 16-byte accesses aligned and whole;
- the backward's gather windows (``gather_window``) hold exactly the
  (output, weight) pairs the forward's source index (``source_index``)
  scatters, and both, in float64, give F.interpolate's forward and
  autograd backward to fp32's rounding of the weights;
- a CPU tensor, and a call under ``torch.export``'s trace, take
  F.interpolate and launch nothing.
"""

from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tdeed_tpu_torch.kernels import upsample
from tdeed_tpu_torch.kernels.upsample import (
    SMEM_BYTES,
    THREADS,
    gather_pairs,
    gather_window,
    source_index,
    upsample_plan,
)
from tdeed_tpu_torch.ops import temporal

PAIRS = [(1, 7), (7, 7), (13, 25), (25, 50), (50, 100), (7, 100)]


def _strides(layout, b, c, t):
    """(sb, sc, st) of a (B, C, T) tensor: the mixer's view of a dense
    (B, T, C) one, a dense (B, C, T) one, or every other element of it."""
    return {"mixer": (t * c, 1, c), "contiguous": (c * t, t, 1),
            "strided": (2 * c * t, 2 * t, 2)}[layout]


def _stage_offsets(plan, b, c, t_len, strides):
    """Per block, csrc/upsample.cu's stage(): the (c, t) elements each
    load reads, with each load's element offsets in memory."""
    sb, sc, st = strides
    v = plan.vec_read
    for by in range(b):
        for bx in range(plan.blocks[0]):
            c0 = bx * plan.ct
            n = min(plan.ct, c - c0)
            base = by * sb + c0 * sc
            if plan.along_c:
                lanes = n // v
                for k in range(lanes * t_len):
                    cv, t = k % lanes, k // lanes
                    yield [(by, c0 + cv * v + j, t, base + t * st + (cv * v + j) * sc)
                           for j in range(v)]
            else:
                for k in range(n * t_len // v):
                    f = k * v
                    loads = []
                    for j in range(v):
                        ch, t = (f + j) // t_len, (f + j) % t_len
                        off = base + f + j if v > 1 else base + ch * sc + t * st
                        loads.append((by, c0 + ch, t, off))
                    yield loads


def _write_offsets(plan, b, c, t_write):
    """Per store, the dense output's (b, c, t) elements and offsets."""
    w = plan.vec_write
    for by in range(b):
        for bx in range(plan.blocks[0]):
            c0 = bx * plan.ct
            n = min(plan.ct, c - c0)
            base = (by * c + c0) * t_write
            for k in range(n * t_write // w):
                f = k * w
                yield [(by, c0 + (f + j) // t_write, (f + j) % t_write, base + f + j)
                       for j in range(w)]


@pytest.mark.parametrize("layout", ["mixer", "contiguous", "strided"])
@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("channels", [368, 5])
@pytest.mark.parametrize("t_in,t_out", PAIRS)
def test_plan_covers_every_element_once(t_in, t_out, channels, backward, layout):
    b = 3
    t_read, t_write = (t_out, t_in) if backward else (t_in, t_out)
    strides = _strides(layout, b, channels, t_read)
    plan = upsample_plan(b, channels, t_in, t_out, backward, 2, strides, 16, 16)
    assert plan.blocks == (-(-channels // plan.ct), b)
    assert plan.threads % 32 == 0 and plan.threads <= THREADS
    assert plan.threads >= min(THREADS, plan.ct * t_write)  # a thread an element
    assert plan.smem_bytes <= SMEM_BYTES and plan.pitch >= t_read and plan.pitch % 2 == 1
    # the result slab, the staged slab, 4 words an output step, 2 an input step
    table = 4 * t_out + (2 * t_in if backward else 0)
    assert plan.smem_bytes == (-(-plan.ct * t_write * 2 // 16) * 16
                               + 4 * (plan.ct * plan.pitch + table))

    staged = Counter()
    for load in _stage_offsets(plan, b, channels, t_read, strides):
        staged.update((by, ch, t) for by, ch, t, _ in load)
        offs = [o for *_, o in load]
        if len(load) > 1:  # one 16-byte access: aligned, whole, in order
            assert offs[0] % len(load) == 0
            step = strides[1] if plan.along_c else 1
            assert offs == [offs[0] + j * step for j in range(len(load))] and step == 1
        for by, ch, t, o in load:
            assert o == by * strides[0] + ch * strides[1] + t * strides[2]
    assert staged == Counter((by, ch, t) for by in range(b) for ch in range(channels)
                             for t in range(t_read))

    written = Counter()
    for store in _write_offsets(plan, b, channels, t_write):
        written.update((by, ch, t) for by, ch, t, _ in store)
        offs = [o for *_, o in store]
        assert offs[0] % len(store) == 0
        for by, ch, t, o in store:
            assert o == (by * channels + ch) * t_write + t
    assert written == Counter((by, ch, t) for by in range(b) for ch in range(channels)
                              for t in range(t_write))


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
@pytest.mark.parametrize("t_short,t_long", [(25, 50), (50, 100)])
def test_the_mixers_shapes_take_16_byte_accesses(t_short, t_long, backward):
    """bf16 (8, 368, T): the forward reads the mixer's channels-innermost
    view across channels, the backward a dense gradient along time; both
    write dense rows, 8 elements an access."""
    b, c = 8, 368
    if backward:
        plan = upsample_plan(b, c, t_short, t_long, True, 2, (c * t_long, t_long, 1), 256,
                             256)
        assert not plan.along_c
    else:
        plan = upsample_plan(b, c, t_short, t_long, False, 2, (t_short * c, 1, c), 256,
                             256)
        assert plan.along_c
    assert (plan.vec_read, plan.vec_write, plan.ct) == (8, 8, 8)
    assert plan.blocks == (46, 8)
    # a pointer 2 bytes off 16 reads and writes one element an access
    plan = upsample_plan(b, c, t_short, t_long, False, 2, (t_short * c, 1, c), 2, 2)
    assert (plan.vec_read, plan.vec_write) == (1, 1)


def test_plan_refuses_what_the_kernels_cannot_run():
    long = SMEM_BYTES // 8
    with pytest.raises(ValueError, match="shared memory"):
        upsample_plan(1, 1, long, long + 1, True, 4, (long + 1, long + 1, 1), 16, 16)
    with pytest.raises(ValueError, match="nothing to upsample"):
        upsample_plan(1, 0, 5, 7, False, 2, (0, 5, 1), 16, 16)
    with pytest.raises(ValueError, match="grid"):
        upsample_plan(70_000, 8, 5, 7, False, 2, (40, 5, 1), 16, 16)
    # long rows fit as fewer channels a block
    plan = upsample_plan(2, 8, 5_000, 10_001, False, 4, (40_000, 5_000, 1), 16, 16)
    assert plan.ct == 1 and plan.smem_bytes <= SMEM_BYTES


def _scatter_pairs(t_in, t_out):
    """For each input element, the (output, weight) terms the forward's
    source index sends it."""
    pairs = [[] for _ in range(t_in)]
    if t_in == t_out:
        for i in range(t_out):
            pairs[i].append((i, 1.0))
        return pairs
    w1, w1p, l0, l1 = source_index(t_in, t_out)
    for i in range(t_out):
        pairs[w1[i]].append((i, float(l0[i])))
        pairs[w1[i] + w1p[i]].append((i, float(l1[i])))
    return pairs


def _matrix(pairs, t_in, t_out):
    m = torch.zeros((t_out, t_in), dtype=torch.float64)
    for j, terms in enumerate(pairs):
        for i, w in terms:
            m[i, j] += w
    return m


@pytest.mark.parametrize("t_in,t_out", PAIRS + [(100, 7), (9, 4), (5, 1)])
def test_gather_windows_hold_the_scattered_pairs(t_in, t_out):
    gathered, scattered = gather_pairs(t_in, t_out), _scatter_pairs(t_in, t_out)
    assert [sorted(g) for g in gathered] == [sorted(s) for s in scattered]
    for j in range(t_in):
        lo, hi = gather_window(j, t_in, t_out)
        assert 0 <= lo <= hi < t_out or not scattered[j]
        assert all(lo <= i <= hi for i, _ in scattered[j])

    # float64: the weights' matrix against F.interpolate, forward and backward
    m = _matrix(gathered, t_in, t_out)
    gen = torch.Generator().manual_seed(t_in * 1000 + t_out)
    x = torch.randn((2, 3, t_in), generator=gen, dtype=torch.float64, requires_grad=True)
    dy = torch.randn((2, 3, t_out), generator=gen, dtype=torch.float64)
    y = F.interpolate(x, size=t_out, mode="linear", align_corners=True)
    (dx,) = torch.autograd.grad(y, x, dy)
    # each weight is off by fp32's rounding of the source position i * rwidth
    # (< t_in) and of rwidth, at most 2^-22 * t_in
    tol = 2.0 ** -22 * t_in
    assert torch.allclose(x.detach() @ m.T, y.detach(), rtol=0,
                          atol=2 * tol * float(x.detach().abs().max()))
    # over the terms of either matrix: fp32 may move a term to the next step
    m64 = F.interpolate(torch.eye(t_in, dtype=torch.float64)[None], size=t_out, mode="linear",
                        align_corners=True)[0].t()
    terms = ((m != 0) | (m64 != 0)).double()
    assert bool(((dy @ m - dx).abs() <= tol * (dy.abs() @ terms)).all())


def test_weights_sum_to_one_and_the_ends_align():
    for t_in, t_out in PAIRS:
        m = _matrix(gather_pairs(t_in, t_out), t_in, t_out)
        assert torch.allclose(m.sum(1), torch.ones(t_out, dtype=torch.float64), atol=1e-6)
        assert m[0, 0] == 1.0 and m[-1, -1] == 1.0


@pytest.fixture
def no_kernels(monkeypatch):
    """The kernels' entry replaced by one that fails the test if reached."""
    def refuse(*_):
        raise AssertionError("the upsample kernels were called")
    monkeypatch.setattr(upsample, "linear_upsample", refuse)


@pytest.mark.parametrize("t_in,t_out", PAIRS)
def test_a_cpu_tensor_takes_interpolate(no_kernels, t_in, t_out):
    x = torch.randn(2, t_in, 6, requires_grad=True)
    before = (upsample.upsample_forward.launches, upsample.upsample_backward.launches)
    y = temporal.linear_upsample(x, t_out)
    want = F.interpolate(x.transpose(1, 2), size=t_out, mode="linear",
                         align_corners=True).transpose(1, 2)
    assert torch.equal(y, want) and y.stride() == want.stride()
    y.sum().backward()
    assert (upsample.upsample_forward.launches,
            upsample.upsample_backward.launches) == before


def test_export_tracing_takes_interpolate(no_kernels, monkeypatch):
    seen = []
    tracing = temporal.tracing

    def spy():
        seen.append(tracing())
        return seen[-1]

    monkeypatch.setattr(temporal, "tracing", spy)

    class Up(torch.nn.Module):
        def forward(self, x):
            return temporal.linear_upsample(x, 25)

    program = torch.export.export(Up(), (torch.randn(2, 13, 8),))
    assert seen == [True]
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert any("upsample_linear1d" in t for t in targets), targets
    assert not tracing()


def test_the_kernels_refuse_a_cpu_tensor():
    before = upsample.upsample_forward.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        upsample.upsample_forward(torch.randn(2, 3, 5), 9)
    assert upsample.upsample_forward.launches == before


def test_rwidth_is_atens_fp32_ratio():
    assert upsample.rwidth(50, 100) == np.float32(49) / np.float32(99)
    assert upsample.rwidth(13, 25) == np.float32(0.5)
    assert upsample.rwidth(7, 1) == 0 and upsample.rwidth(1, 7) == 0
