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
float64 sum.
"""

import pytest
import torch

from tdeed_tpu_torch.kernels import augment, probe
from tdeed_tpu_torch.kernels.augment import (
    photometric,
    photometric_plan,
    photometric_reference,
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
# (bf16 at W = 796)
PHOTOMETRIC_SHAPES = [(224, 224), (448, 796), (3, 3), (37, 61), (57, 224), (224, 796),
                      (5, 11), (256, 256)]


@pytest.mark.parametrize("hw", PHOTOMETRIC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16])
def test_kernel_matches_reference_for_every_gate_combination(cuda, hw, dtype):
    params = _all_gate_combinations(cuda)
    frames = _frames((64, 2, *hw, 3), dtype, cuda)
    got = photometric(frames, params)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == frames.shape
    _assert_within_bf16_ulp(got, photometric_reference(frames, params))


@pytest.mark.parametrize("hw", [(224, 224), (57, 224), (37, 61)])
def test_kernel_misaligned_input_and_two_calls_give_the_same_bits(cuda, hw):
    """Frames starting 2 bytes past a 16-byte boundary take the element
    copies at each chunk's head and tail; every call gives the same bits."""
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


@pytest.mark.parametrize("hw", [(224, 224), (448, 796), (57, 224)])
def test_contrast_mean_crosses_the_bands(cuda, hw):
    """Top half bright, bottom half dark: each band's partial is far from
    the frame's mean, which only the cluster's sum gives."""
    h, w = hw
    assert photometric_plan(h, w, torch.uint8).cluster > 1
    frames = _frames((4, 2, h, w, 3), torch.uint8, cuda) // 8
    frames[:, :, : h // 2] += 200
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


def test_wrapper_raises_instead_of_falling_back(cuda):
    frames = _frames((1, 2, 8, 8, 3), torch.uint8, cuda)
    with pytest.raises(ValueError):  # params on the wrong device
        photometric(frames, torch.zeros(1, 16))
    with pytest.raises(TypeError):
        photometric(frames.float(), torch.zeros(1, 16, device=cuda))
    with pytest.raises(ValueError):  # wider than a block's shared memory takes
        photometric(_frames((1, 1, 4, 2000, 3), torch.bfloat16, cuda), torch.zeros(1, 16, device=cuda))


def test_photometric_entry_refuses_a_bad_plan(cuda):
    h, w = 224, 224
    frames = _frames((2, 3, h, w, 3), torch.bfloat16, cuda)
    params = _all_gate_combinations(cuda)[::32].contiguous()  # clips 0 and 32: contrast on in 32
    out = torch.empty_like(frames)
    p = photometric_plan(h, w, frames.dtype)
    good = (p.cluster, p.rows, p.chunk, p.smem_bytes)
    fn = augment._kernel()
    stream = torch.cuda.current_stream().cuda_stream

    def call(plan):
        return fn(frames.data_ptr(), 1, params.data_ptr(), out.data_ptr(), 2, 3, h, w,
                  *plan, stream)

    for bad in ((9, 25, 8, p.smem_bytes),  # more than 8 CTAs in a cluster
                (4, 55, 8, p.smem_bytes),  # 4 x 55 rows miss the frame's last 4
                (5, 56, 8, p.smem_bytes),  # the fifth band is empty
                (4, 56, 0, p.smem_bytes), (4, 56, 9, p.smem_bytes),  # chunk out of range
                (*good[:3], p.smem_bytes - 16),  # less shared memory than the layout takes
                (*good[:3], 232_448 + 16)):  # more than a block may have
        assert call(bad) != 0, bad
    assert call(good) == 0
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


@pytest.mark.parametrize("shape", [(16, 16, 24, 800), (3, 5, 20, 37), (2, 3, 64, 300), (1, 1, 1, 1)])
def test_probe_outerp_matches_reference(cuda, shape):
    x = _probe_x(shape, cuda)
    got, acc = probe.outerp(x)
    torch.cuda.synchronize()
    assert torch.equal(got, probe.stream_reference(x))
    xd = x.double()
    want = torch.einsum("hwcn,hwdn->cd", xd, xd)
    assert acc.dtype == torch.float32 and acc.shape == (shape[2], shape[2])
    err = float((acc.double() - want).abs().max())
    assert err <= 1e-5 * float(want.abs().max()), err
    _, again = probe.outerp(x)
    assert torch.equal(acc, again)  # fixed partials in a fixed order


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
