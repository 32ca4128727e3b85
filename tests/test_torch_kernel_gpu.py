"""The CUDA kernels against their plain PyTorch versions on the card: the
photometric kernel (tdeed_tpu_torch/csrc/photometric.cu) and the three
probe kernels (tdeed_tpu_torch/csrc/probe.cu). Needs a CUDA GPU and nvcc;
every test skips without a card. The card's machine has no JAX, and tests/conftest.py
imports it, so run this file there without the conftest:

    python -m pytest tests/test_torch_kernel_gpu.py -m gpu --noconftest -q

Tolerance: 1 bf16 ulp at the output's magnitude, and 2^-16 near 0. Both
versions compute the chain in fp32 and round once to bf16; the frame mean's
summation order can move a value across one bf16 rounding boundary, never
further. Near 0 the standardization (c - mean) / std cancels, and the
plain version on the card divides by a scalar as a multiply by its
reciprocal: the two differ there by ~1e-6 absolute (measured on an H100).
The probe: stream and outerp's pass-through bit-exact; perpix 1 bf16 ulp,
floored the same way (the tensor cores add each k16 step's fp32 products
in their own order), and the same bits from every call;
outerp's fp32 (C, C) sum within 1e-5 of its largest entry against a
float64 sum (its tensor cores too), and the same bits from every call.
The BatchNorm kernels (tdeed_tpu_torch/csrc/batchnorm.cu) against their
plain twins at the trunk's shapes in both benchmark cells: the moments
and the gradient's sums within 1e-5 of a float64 sum, relative to the sum
of the terms' magnitudes (the fp32 sums run in another order); y and the
running statistics bit for bit given the kernel's moments; dx within 1
bf16 ulp given the kernel's sums (the twin on the card divides by the row
count as a multiply by its reciprocal).
"""

import pytest
import torch

from tdeed_tpu_torch.kernels import augment, probe
from tdeed_tpu_torch.kernels.augment import (
    max_width,
    photometric,
    photometric_plan,
    photometric_reference,
    photometric_smem,
    sample_params,
    train_preprocess,
)

pytestmark = pytest.mark.gpu

GATE_SLOTS = (0, 2, 4, 6, 8, 14)  # hue, saturation, brightness, contrast, blur, flip


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _all_gate_combinations(device):
    """(64, 16): clip c turns on the gates named by the bits of c."""
    p = sample_params(torch.Generator().manual_seed(0), 64)
    combos = torch.arange(64)
    for bit, slot in enumerate(GATE_SLOTS):
        p[:, slot] = ((combos >> bit) & 1).float()
    return p.to(device)


def _frames(shape, dtype, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    if dtype == torch.uint8:
        return torch.randint(0, 256, shape, generator=g, device=device, dtype=torch.uint8)
    return (torch.rand(shape, generator=g, device=device) * 255).to(torch.bfloat16)


def _assert_within_bf16_ulp(got, want):
    g, w = got.float(), want.float()
    err = (g - w).abs()
    mag = torch.maximum(g.abs(), w.abs()).clamp_min(2.0 ** -9)
    bound = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    assert not bool((err > bound).any()), (
        f"{int((err > bound).sum())} values beyond 1 bf16 ulp; max err {float(err.max())}"
    )


# bands that end unevenly ((57, 224): 29 + 28 rows; (256, 256): 4 x 52 + 48),
# rows that are not 16-byte multiples (W = 796, 61, 11, 3), one-row chunks
# (bf16 at W = 796); then wide frames: one segment (uint8 up to 2,419
# pixels), 2 segments (bf16 at 2000 and 1920, 8 clusters of 4 bands x 2),
# 3 ragged ones (5001), 5 or 4 (8192), and the widest bf16 plan, 8
PHOTOMETRIC_SHAPES = [(224, 224), (448, 796), (3, 3), (37, 61), (57, 224), (224, 796),
                      (5, 11), (256, 256), (16, 2200), (224, 2000), (7, 5001), (16, 8192),
                      (5, 14_712), (1080, 1920)]
# clips of the gate combinations that frames of more than 300,000 pixels
# take, one frame each: none, contrast, blur, both, flip, flip with both,
# flip with blur, hue + saturation + brightness, all
WIDE_COMBOS = [0, 8, 16, 24, 32, 56, 48, 7, 63]


@pytest.mark.parametrize("hw", PHOTOMETRIC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16])
def test_kernel_matches_reference_for_every_gate_combination(cuda, hw, dtype):
    params = _all_gate_combinations(cuda)
    frames_per_clip = 2
    if hw[0] * hw[1] > 300_000:
        params, frames_per_clip = params[WIDE_COMBOS].contiguous(), 1
    frames = _frames((params.shape[0], frames_per_clip, *hw, 3), dtype, cuda)
    got = photometric(frames, params)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == frames.shape
    _assert_within_bf16_ulp(got, photometric_reference(frames, params))


@pytest.mark.parametrize("hw", [(224, 224), (57, 224), (37, 61), (20, 2000)])
def test_kernel_misaligned_input_and_two_calls_give_the_same_bits(cuda, hw):
    """Frames starting 2 bytes past a 16-byte boundary take the element
    copies at each chunk's head and tail (with segments, at each row's:
    (20, 2000) bf16 is cut in 2); every call gives the same bits."""
    params = _all_gate_combinations(cuda)
    shape = (64, 2, *hw, 3)
    flat = _frames((torch.Size(shape).numel() + 1,), torch.bfloat16, cuda)
    frames = flat[1:].view(shape)
    assert frames.data_ptr() % 16 != 0
    got = photometric(frames, params)
    torch.cuda.synchronize()
    _assert_within_bf16_ulp(got, photometric_reference(frames, params))
    assert torch.equal(got, photometric(frames, params))
    assert torch.equal(got, photometric(frames.contiguous().clone(), params))


@pytest.mark.parametrize("hw,dtype", [
    ((224, 224), torch.uint8), ((448, 796), torch.uint8), ((57, 224), torch.uint8),
    ((20, 2600), torch.uint8), ((1080, 1920), torch.uint8), ((1080, 1920), torch.bfloat16)])
def test_contrast_mean_crosses_the_bands(cuda, hw, dtype):
    """Top half bright, left half brighter: each band's and each column
    segment's partial is far from the frame's mean, which only the
    cluster's sum gives ((20, 2600) uint8: 2 segments of one band)."""
    h, w = hw
    assert photometric_plan(h, w, dtype).cluster > 1
    frames = _frames((4, 2, h, w, 3), torch.uint8, cuda) // 8
    frames[:, :, : h // 2] += 150
    frames[:, :, :, : w // 2] += 50
    frames = frames.to(dtype)
    params = torch.zeros(4, 16, device=cuda)
    params[:, 6] = 1.0  # contrast on
    params[:, 7] = torch.tensor([0.7, 0.9, 1.1, 1.2], device=cuda)
    params[2:, 8] = 1.0  # and blur
    params[2:, 9:14] = torch.tensor([0.1, 0.2, 0.4, 0.2, 0.1], device=cuda)
    got = photometric(frames, params)
    torch.cuda.synchronize()
    _assert_within_bf16_ulp(got, photometric_reference(frames, params))
    assert torch.equal(got, photometric(frames, params))


def test_flip_gate_equals_flipped_input(cuda):
    params = _all_gate_combinations(cuda)
    on = params[:, 14] > 0.5
    frames = _frames((64, 2, 40, 53, 3), torch.uint8, cuda)
    pre = torch.where(on.view(-1, 1, 1, 1, 1), frames.flip(3), frames)
    unflipped = params.clone()
    unflipped[:, 14] = 0.0
    _assert_within_bf16_ulp(photometric(frames, params), photometric(pre, unflipped))


def test_launch_counter_and_train_preprocess(cuda):
    """One launch per call; a float mixup blend is staged as bf16."""
    params = sample_params(torch.Generator().manual_seed(1), 2).to(cuda)
    blend = torch.rand(2, 3, 20, 30, 3, device=cuda) * 255
    before = photometric.launches
    got = train_preprocess(blend, params)
    assert photometric.launches == before + 1
    want = photometric_reference(blend.to(torch.bfloat16), params)
    _assert_within_bf16_ulp(got, want)


@pytest.mark.parametrize("pallas_augment,launches", [(None, 1), (True, 1), (False, 0)])
def test_train_step_honours_pallas_augment(cuda, pallas_augment, launches):
    """A train step on the card launches the kernel once with
    pallas_augment None or True, and never with False (the plain chain)."""
    import numpy as np

    from tdeed_tpu_torch.models.tdeed import TDEED
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    torch.manual_seed(0)
    model = TDEED(4, 8, n_layers=1, sgp_ks=3, sgp_r=2, dtype=torch.float32).to(cuda)
    opt, sched = make_optimizer(model.parameters(), 1e-3, 1, 10)
    step = make_train_step(model, opt, sched, crop_dim=32, num_classes_bg=5, mixup=True,
                           radi_displacement=2, pallas_augment=pallas_augment)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 256, (2, 8, 40, 40, 3)).astype(np.uint8)
             for k in ("frame", "frame2")}
    batch.update({k: rng.integers(0, 5, (2, 8)) for k in ("label", "label2")})
    before = photometric.launches
    assert torch.isfinite(step(batch)["loss"])
    assert photometric.launches - before == launches


def test_wrapper_raises_instead_of_falling_back(cuda):
    frames = _frames((1, 2, 8, 8, 3), torch.uint8, cuda)
    with pytest.raises(ValueError):  # params on the wrong device
        photometric(frames, torch.zeros(1, 16))
    with pytest.raises(TypeError):
        photometric(frames.float(), torch.zeros(1, 16, device=cuda))
    with pytest.raises(ValueError):  # wider than 8 column segments take
        photometric(_frames((1, 1, 4, max_width(torch.bfloat16) + 1, 3), torch.bfloat16, cuda),
                    torch.zeros(1, 16, device=cuda))


def test_photometric_entry_refuses_a_bad_plan(cuda):
    h, w = 224, 224
    frames = _frames((2, 3, h, w, 3), torch.bfloat16, cuda)
    params = _all_gate_combinations(cuda)[::32].contiguous()  # clips 0 and 32: contrast on in 32
    out = torch.empty_like(frames)
    p = photometric_plan(h, w, frames.dtype)
    good = (p.bands, p.rows, p.segments, p.seg_w, p.chunk, p.smem_bytes)
    # the same frame cut in 2 bands x 2 column segments
    seg = (2, 112, 2, 112, 8, photometric_smem(112, 2, 8, True))
    fn = augment._kernel()
    stream = torch.cuda.current_stream().cuda_stream

    def call(plan):
        return fn(frames.data_ptr(), 1, params.data_ptr(), out.data_ptr(), 2, 3, h, w,
                  *plan, stream)

    for bad in ((9, 25, 1, 224, 8, p.smem_bytes),  # more than 8 CTAs in a cluster
                (4, 56, 3, 75, 8, seg[5]),  # 4 bands x 3 segments: 12 CTAs
                (4, 55, 1, 224, 8, p.smem_bytes),  # 4 x 55 rows miss the frame's last 4
                (5, 56, 1, 224, 8, p.smem_bytes),  # the fifth band is empty
                (4, 56, 1, 223, 8, p.smem_bytes),  # one segment narrower than the frame
                (2, 112, 2, 111, 8, seg[5]),  # 2 x 111 columns miss the frame's last 2
                (2, 112, 3, 112, 8, seg[5]),  # the third segment is empty
                (2, 112, 0, 112, 8, seg[5]),  # no segment
                (*good[:4], 0, p.smem_bytes), (*good[:4], 9, p.smem_bytes),  # chunk out of range
                (*good[:5], p.smem_bytes - 16),  # less shared memory than the layout takes
                (*seg[:5], seg[5] - 16),  # less than the segmented layout takes
                (*good[:5], 232_448 + 16)):  # more than a block may have
        assert call(bad) != 0, bad
    want = photometric_reference(frames, params)
    for plan in (good, seg):
        out.zero_()
        assert call(plan) == 0
        torch.cuda.synchronize()
        _assert_within_bf16_ulp(out, want)


def _forced_plan(h, w, dtype, segments):
    """A plan of exactly `segments` column segments (photometric_plan
    takes one up to 1,843 bf16 pixels), bands and chunk as it cuts them."""
    seg_w = -(-w // segments)
    assert -(-w // seg_w) == segments
    bands = min(augment.MAX_CLUSTER // segments, -(-h // augment.BAND_ROWS))
    rows = -(-h // bands)
    bands = -(-h // rows)
    chunk = min(augment.MAX_CHUNK, rows)
    smem = photometric_smem(seg_w, 1 if dtype == torch.uint8 else 2, chunk, True)
    return bands, rows, segments, seg_w, chunk, smem


@pytest.mark.parametrize("segments", [2, 3, 8])
@pytest.mark.parametrize("hw", [(37, 61), (57, 224), (9, 97)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16])
def test_forced_segments_match_reference_for_every_gate_combination(cuda, segments, hw, dtype):
    """The segmented layout on frames that one segment would take: every
    gate combination, ragged last segments (61 = 21 + 20 + 20 ... 8 x 8 - 3),
    halos reflected at both edges and mirrored under the flip, and the
    contrast mean summed over bands x segments."""
    h, w = hw
    plan = _forced_plan(h, w, dtype, segments)
    params = _all_gate_combinations(cuda)
    frames = _frames((64, 2, h, w, 3), dtype, cuda)
    out = torch.empty(frames.shape, dtype=torch.bfloat16, device=cuda)
    err = augment._kernel()(frames.data_ptr(), 0 if dtype == torch.uint8 else 1,
                            params.data_ptr(), out.data_ptr(), 64, 2, h, w, *plan,
                            torch.cuda.current_stream().cuda_stream)
    assert err == 0
    torch.cuda.synchronize()
    _assert_within_bf16_ulp(out, photometric_reference(frames, params))


def _probe_x(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.randn(shape, generator=g, device=device).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(16, 16, 24, 800), (3, 5, 7, 37), (1, 1, 1, 1)])
def test_probe_stream_is_bit_exact(cuda, shape):
    x = _probe_x(shape, cuda)
    assert torch.equal(probe.stream(x), probe.stream_reference(x))
    if x.numel() > 1:
        tail = x.view(-1)[1:].view(-1, 1, 1, 1)  # not 16-byte aligned: the scalar path
        assert torch.equal(probe.stream(tail), probe.stream_reference(tail))


PERPIX_CS = (1, 15, 16, 17, 24, 33, 48, 63, 64)  # each side of each 16-row padding edge
# 16-byte rows or not; one tile, several (at C = 48 and up from 800, at
# every C at 1904), ragged
PERPIX_NS = (1, 8, 9, 37, 160, 800, 801, 1904)
# one pixel, and 600 pixels: more work items than the grid has blocks
PERPIX_SHAPES = (
    [(16, 16, 24, 800), (16, 8, 48, 800), (3, 5, 20, 37), (2, 3, 64, 129), (2, 2, 1, 5)]
    + [(1, 1, c, n) for c in PERPIX_CS for n in PERPIX_NS]
    + [(20, 30, c, n) for c in PERPIX_CS for n in PERPIX_NS]
)


def _perpix_weight(c, device):
    wt = torch.randn(c, c, generator=torch.Generator().manual_seed(1)) / c ** 0.5
    return wt.to(torch.bfloat16).to(device)


def _misaligned_probe_x(shape, device):
    """x as x.view(-1)[1:] of a buffer one element longer: 2 bytes off 16."""
    flat = _probe_x((torch.Size(shape).numel() + 1,), device)
    x = flat[1:].view(shape)
    assert x.data_ptr() % 16 != 0
    return x


@pytest.mark.parametrize("shape", PERPIX_SHAPES)
def test_probe_perpix_matches_reference(cuda, shape):
    wt = _perpix_weight(shape[2], cuda)
    for x in (_probe_x(shape, cuda), _misaligned_probe_x(shape, cuda)):
        got = probe.perpix(x, wt)
        torch.cuda.synchronize()
        assert got.dtype == torch.bfloat16 and got.shape == x.shape
        _assert_within_bf16_ulp(got, probe.perpix_reference(x, wt))


@pytest.mark.parametrize("shape", [(16, 16, 24, 800), (16, 8, 48, 800), (20, 30, 17, 37)])
def test_probe_perpix_gives_the_same_bits_twice(cuda, shape):
    wt = _perpix_weight(shape[2], cuda)
    for x in (_probe_x(shape, cuda), _misaligned_probe_x(shape, cuda)):
        assert torch.equal(probe.perpix(x, wt), probe.perpix(x, wt))


def test_probe_perpix_entry_refuses_a_bad_plan(cuda):
    x = _probe_x((2, 2, 24, 160), cuda)
    o = torch.empty_like(x)
    wt = _perpix_weight(24, cuda)
    p = probe.perpix_plan(24, 160, 4)
    good = (p.c_pad, p.bn, p.smem_bytes, p.grid)
    lib = probe._lib()
    stream = torch.cuda.current_stream().cuda_stream
    for bad in ((16, *good[1:]), (p.c_pad, 8, *good[2:]), (*good[:2], p.smem_bytes - 2, p.grid),
                (*good[:2], 232_448 + 16, p.grid), (*good[:3], 4 * p.tiles + 1), (*good[:3], 0)):
        assert lib.tdeed_probe_perpix(x.data_ptr(), wt.data_ptr(), o.data_ptr(),
                                      4, 24, 160, *bad, stream) != 0, bad
    assert lib.tdeed_probe_perpix(x.data_ptr(), wt.data_ptr(), o.data_ptr(),
                                  4, 24, 160, *good, stream) == 0
    torch.cuda.synchronize()
    _assert_within_bf16_ulp(o, probe.perpix_reference(x, wt))


# C = 17, 24, 48 and 64 (the padding edges), rows of 16-byte multiples or
# not (N = 37, 300, 801, 9), one tile a pixel or several (C = 48, 64 at
# N = 800 and up), more items than the grid has blocks
OUTERP_SHAPES = [(16, 16, 24, 800), (3, 5, 20, 37), (2, 3, 64, 300), (1, 1, 1, 1),
                 (16, 8, 48, 800), (4, 5, 17, 801), (20, 30, 17, 37), (3, 3, 64, 4099),
                 (20, 30, 64, 800), (7, 9, 1, 9), (30, 40, 24, 16)]


@pytest.mark.parametrize("shape", OUTERP_SHAPES)
def test_probe_outerp_matches_reference(cuda, shape):
    for x in (_probe_x(shape, cuda), _misaligned_probe_x(shape, cuda)):
        got, acc = probe.outerp(x)
        torch.cuda.synchronize()
        assert torch.equal(got, probe.stream_reference(x))
        xd = x.double()
        want = torch.einsum("hwcn,hwdn->cd", xd, xd)
        assert acc.dtype == torch.float32 and acc.shape == (shape[2], shape[2])
        err = float((acc.double() - want).abs().max())
        assert err <= 1e-5 * float(want.abs().max()), err
        again, acc2 = probe.outerp(x)
        assert torch.equal(acc, acc2) and torch.equal(got, again)  # fixed partials in a fixed order


def test_probe_outerp_entry_refuses_a_bad_plan(cuda):
    x = _probe_x((2, 2, 24, 160), cuda)
    o = torch.empty_like(x)
    p = probe.outerp_plan(24, 160, 4)
    partial = torch.empty(4 * p.tiles, 24, 24, dtype=torch.float32, device=cuda)
    acc = torch.empty(24, 24, dtype=torch.float32, device=cuda)
    good = (p.c_pad, p.bn, p.smem_bytes, p.grid)
    lib = probe._lib()
    stream = torch.cuda.current_stream().cuda_stream

    def call(plan):
        return lib.tdeed_probe_outerp(x.data_ptr(), o.data_ptr(), partial.data_ptr(),
                                      acc.data_ptr(), 4, 24, 160, *plan, stream)

    for bad in ((16, *good[1:]), (p.c_pad, 8, *good[2:]), (80, *good[1:]),
                (*good[:2], p.smem_bytes - 4, p.grid), (*good[:2], 232_448 + 16, p.grid),
                (*good[:3], 4 * p.tiles + 1), (*good[:3], 0)):
        assert call(bad) != 0, bad
    assert call(good) == 0
    torch.cuda.synchronize()
    want_o, want_acc = probe.outerp_reference(x)
    assert torch.equal(o, want_o)
    assert float((acc - want_acc).abs().max()) <= 1e-5 * float(want_acc.abs().max())


def test_probe_launch_counters_and_errors(cuda):
    x = _probe_x((2, 2, 8, 16), cuda)
    wt = torch.zeros(8, 8, dtype=torch.bfloat16, device=cuda)
    before = (probe.stream.launches, probe.perpix.launches, probe.outerp.launches)
    probe.stream(x)
    probe.perpix(x, wt)
    probe.outerp(x)
    after = (probe.stream.launches, probe.perpix.launches, probe.outerp.launches)
    assert after == tuple(b + 1 for b in before)
    with pytest.raises(ValueError):  # weight on the wrong device
        probe.perpix(x, wt.cpu())
    with pytest.raises(TypeError):
        probe.stream(x.float())


# ---------------------------------------------------------------------------
# The BatchNorm kernels
# ---------------------------------------------------------------------------


def _bn_shapes(frames, h, w):
    """(frames, C, H, W) of each trunk BatchNorm of rny002_gsf at h x w:
    the stem, each stage's conv1 at its input's resolution and conv2 at
    its output's, stage 4's width at stage 3's resolution (s4_b1's conv1),
    and the GSF folds (16, 40, 92) at their block inputs' resolutions."""
    def r(k):
        return (-(-h // 2 ** k), -(-w // 2 ** k))

    return [(frames, c, *r(k)) for c, k in (
        (32, 1), (24, 1), (24, 2), (56, 2), (56, 3), (152, 3), (152, 4), (368, 4), (368, 5),
        (16, 3), (40, 4), (92, 5))]


# the two cells: FineDiving 8 x 100 crops of 224^2, SoccerNet Ball 4 x 100
# full 448 x 796 frames
BN_SHAPES = _bn_shapes(800, 224, 224) + _bn_shapes(400, 448, 796)


def _bn_case(shape, dtype, device, seed=0):
    n, c, h, w = shape
    g = torch.Generator(device=device).manual_seed(seed + c)
    x = (torch.randn((n, h, w, c), generator=g, device=device) * 1.5 + 0.3).to(dtype)
    gy = torch.randn((n, h, w, c), generator=g, device=device).to(dtype)
    weight = torch.rand(c, generator=g, device=device) + 0.5
    bias = 0.5 * torch.randn(c, generator=g, device=device)
    return x.permute(0, 3, 1, 2), gy.permute(0, 3, 1, 2), weight, bias


def _sums_close(got, want64, scale64, what):
    err = (got.double() - want64).abs()
    bound = 1e-5 * scale64
    assert bool((err <= bound).all()), (what, float((err / bound).max()))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", BN_SHAPES)
def test_bn_kernels_match_the_twins(cuda, shape, relu):
    from tdeed_tpu_torch.kernels import batchnorm as bn

    x, gy, weight, bias = _bn_case(shape, torch.bfloat16, cuda)
    x64 = x.double()
    dims = [0, 2, 3]

    moments = bn.bn_stats(x)
    want = torch.stack([x64.mean(dims), x64.square().mean(dims)])
    _sums_close(moments, want, torch.stack([x64.abs().mean(dims), want[1]]), "moments")
    assert torch.equal(moments, bn.bn_stats(x))  # the same bits every call

    running = (torch.zeros_like(weight), torch.ones_like(weight),
               torch.zeros((), dtype=torch.long, device=cuda))
    y, stats = bn.bn_apply(x, moments, weight, bias, 1e-5, relu, running)
    want_run = (torch.zeros_like(weight), torch.ones_like(weight),
                torch.zeros((), dtype=torch.long, device=cuda))
    y_twin, stats_twin = bn.bn_apply_reference(x, moments, weight, bias, 1e-5, relu, want_run)
    assert y.stride() == x.stride()
    assert torch.equal(y, y_twin)
    assert torch.equal(stats, stats_twin)
    for got, ref in zip(running, want_run):
        assert torch.equal(got, ref)

    sums = bn.bn_grad_sums(x, gy, stats, weight, bias, 1e-5, relu)
    dz, _ = bn._masked(x, gy, stats, weight, bias, 1e-5, relu)
    dz64 = dz.double()
    want = torch.stack([dz64.sum(dims), (dz64 * x64).sum(dims)])
    _sums_close(sums, want, torch.stack([dz64.abs().sum(dims), (dz64 * x64).abs().sum(dims)]),
                "sums")

    n_rows = x.numel() // x.shape[1]
    dx, dw, db = bn.bn_grad_apply(x, gy, stats, weight, bias, 1e-5, relu, sums, sums, n_rows)
    dx_t, dw_t, db_t = bn.bn_grad_apply_reference(x, gy, stats, weight, bias, 1e-5, relu,
                                                  sums, sums, n_rows)
    assert dx.stride() == x.stride()
    _assert_within_bf16_ulp(dx, dx_t)
    for got, ref in ((dw, dw_t), (db, db_t)):
        assert torch.allclose(got, ref, rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.parametrize("shape", [(64, 32, 56, 56), (64, 92, 7, 7), (64, 368, 7, 7),
                                   (10, 3, 5, 7)])
def test_bn_kernels_take_fp32(cuda, shape):
    """fp32 activations: the sums as in bf16, y and dx within 2^-20 of
    their magnitudes (the twin rounds in another order on the card)."""
    from tdeed_tpu_torch.kernels import batchnorm as bn

    x, gy, weight, bias = _bn_case(shape, torch.float32, cuda, seed=5)
    moments = bn.bn_stats(x)
    x64 = x.double()
    want = torch.stack([x64.mean([0, 2, 3]), x64.square().mean([0, 2, 3])])
    _sums_close(moments, want, torch.stack([x64.abs().mean([0, 2, 3]), want[1]]), "moments")
    y, stats = bn.bn_apply(x, moments, weight, bias, 1e-5, True)
    y_t, _ = bn.bn_apply_reference(x, moments, weight, bias, 1e-5, True)
    assert torch.equal(y, y_t)
    sums = bn.bn_grad_sums(x, gy, stats, weight, bias, 1e-5, True)
    n = x.numel() // x.shape[1]
    dx, _, _ = bn.bn_grad_apply(x, gy, stats, weight, bias, 1e-5, True, sums, sums, n)
    dx_t, _, _ = bn.bn_grad_apply_reference(x, gy, stats, weight, bias, 1e-5, True, sums,
                                            sums, n)
    assert torch.allclose(dx, dx_t, rtol=2.0 ** -20, atol=2.0 ** -20 * float(dx_t.abs().max()))


@pytest.mark.parametrize("view", ["misaligned", "gsf", "fold of 152", "fold of 368"])
def test_bn_kernels_take_views(cuda, view):
    """A pointer 2 bytes off 16 (one bf16 a load); the GSF gate's
    (B, C, T, H, W) view of a (B, T, H, W, C) tensor; and that view of the
    first 40 (or 92) channels of a channels_last activation of 152 (368),
    rows 152 (368) apart, as GatedShift.shift gives it. Forward and
    backward against the twins; the outputs are dense."""
    from tdeed_tpu_torch.kernels import batchnorm as bn

    c = {"fold of 368": 92}.get(view, 40)
    gen = torch.Generator(device=cuda).manual_seed(7)
    if view == "misaligned":
        buf = torch.randn(2 * 8 * 8 * c + 1, generator=gen, device=cuda).to(torch.bfloat16)
        x = buf[1:].view(2, 8, 8, c).permute(0, 3, 1, 2)
    elif view == "gsf":
        x = torch.randn(2, 4, 6, 6, c, generator=gen, device=cuda).to(
            torch.bfloat16).permute(0, 4, 1, 2, 3)
    else:
        wide = int(view.split()[-1])
        act = torch.randn(8, 14, 14, wide, generator=gen, device=cuda).to(torch.bfloat16)
        x = act.permute(0, 3, 1, 2)[:, :c].permute(0, 2, 3, 1).reshape(2, 4, 14, 14, c)
        x = x.permute(0, 4, 1, 2, 3)
        assert bn.pitch(x) == wide
    gy = bn._dense_like(x).copy_(torch.randn(x.shape, generator=gen, device=cuda))
    w, b = torch.rand(c, device=cuda) + 0.5, torch.randn(c, device=cuda)
    m = bn.bn_stats(x)
    _sums_close(m[0], x.double().mean([0, 2, 3, 4][:x.ndim - 1]),
                x.double().abs().mean([0, 2, 3, 4][:x.ndim - 1]), "mean")
    y, stats = bn.bn_apply(x, m, w, b, 1e-5, True)
    assert bn.pitch(y) == c
    assert torch.equal(y, bn.bn_apply_reference(x, m, w, b, 1e-5, True)[0])
    n = x.numel() // c
    sums = bn.bn_grad_sums(x, gy, stats, w, b, 1e-5, True)
    dx = bn.bn_grad_apply(x, gy, stats, w, b, 1e-5, True, sums, sums, n)[0]
    assert bn.pitch(dx) == c
    _assert_within_bf16_ulp(dx, bn.bn_grad_apply_reference(x, gy, stats, w, b, 1e-5, True,
                                                           sums, sums, n)[0])


def test_bn_kernels_refuse_other_layouts_and_dtypes(cuda):
    from tdeed_tpu_torch.kernels import batchnorm as bn

    w, b = torch.ones(8, device=cuda), torch.zeros(8, device=cuda)
    x = torch.randn(2, 8, 4, 4, device=cuda)  # contiguous NCHW: channels outermost
    before = bn.bn_stats.launches
    with pytest.raises(ValueError, match="innermost"):
        bn.bn_stats(x)
    with pytest.raises(ValueError, match="innermost"):
        bn.batch_norm_train(x.requires_grad_(), w, b, 1e-5, True)
    with pytest.raises(TypeError):
        bn.bn_stats(x.half().contiguous(memory_format=torch.channels_last))
    assert bn.bn_stats.launches == before


def test_flagship_step_runs_every_batchnorm_through_the_kernels(cuda):
    """One FineDiving_small training step on the card (rny002_gsf: 44
    ConvBN BatchNorms and 11 GSF gates) launches each of the four kernels
    55 times: every trunk BatchNorm, forward and backward."""
    import os

    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.kernels import batchnorm as bn
    from tdeed_tpu_torch.models.common import SplitBatchNorm
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step

    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
    cfg = load_config("FineDiving_small", config_root=root)
    torch.manual_seed(0)
    model = build_model(cfg, device="cuda")
    n_bn = sum(isinstance(m, SplitBatchNorm) for m in model.modules())
    assert n_bn == 55
    opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, 100, 10_000)
    step = make_train_step(model, opt, sched, crop_dim=cfg.crop_dim,
                           num_classes_bg=cfg.num_classes_bg, mixup=cfg.mixup,
                           radi_displacement=cfg.radi_displacement)
    g = torch.Generator(device=cuda).manual_seed(0)
    shape = (cfg.batch_size, cfg.clip_len, 256, 256, 3)
    batch = {k: torch.randint(0, 256, shape, generator=g, device=cuda, dtype=torch.uint8)
             for k in ("frame", "frame2")}
    batch.update({k: torch.randint(0, cfg.num_classes_bg, shape[:2], generator=g, device=cuda)
                  for k in ("label", "label2")})
    fns = (bn.bn_stats, bn.bn_apply, bn.bn_grad_sums, bn.bn_grad_apply)
    before = [f.launches for f in fns]
    assert torch.isfinite(step(batch)["loss"])
    torch.cuda.synchronize()
    assert [f.launches - n for f, n in zip(fns, before)] == [n_bn] * 4
