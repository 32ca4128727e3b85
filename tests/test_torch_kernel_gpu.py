"""The photometric CUDA kernel (tdeed_tpu_torch/csrc/photometric.cu) against
its plain PyTorch version on the card. Needs a CUDA GPU and nvcc; every test
skips without a card. The card's machine has no JAX, and tests/conftest.py
imports it, so run this file there without the conftest:

    python -m pytest tests/test_torch_kernel_gpu.py -m gpu --noconftest -q

Tolerance: 1 bf16 ulp at the output's magnitude, and 2^-16 near 0. Both
versions compute the chain in fp32 and round once to bf16; the frame mean's
summation order can move a value across one bf16 rounding boundary, never
further. Near 0 the standardization (c - mean) / std cancels, and the
plain version on the card divides by a scalar as a multiply by its
reciprocal: the two differ there by ~1e-6 absolute (measured on an H100).
"""

import pytest
import torch

from tdeed_tpu_torch.kernels.augment import (
    photometric,
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


@pytest.mark.parametrize("hw", [(224, 224), (448, 796), (3, 3), (37, 61)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.bfloat16])
def test_kernel_matches_reference_for_every_gate_combination(cuda, hw, dtype):
    params = _all_gate_combinations(cuda)
    frames = _frames((64, 2, *hw, 3), dtype, cuda)
    got = photometric(frames, params)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == frames.shape
    _assert_within_bf16_ulp(got, photometric_reference(frames, params))


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
