"""Kernel K1's plain PyTorch version (tdeed_tpu_torch/kernels/augment.py:
photometric_reference) against the JAX package's Pallas kernel
photometric_planar in interpret mode, on the same frames and parameters.

Tolerance: 1 bf16 ulp at the output's magnitude. Both sides compute the
chain in fp32 and round once to bf16; fp32 differences (the contrast
mean's summation order, FMA contraction) can move a value across one bf16
rounding boundary, never more.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdeed_tpu.kernels.augment import photometric_planar
from tdeed_tpu_torch.kernels.augment import (
    N_PARAMS,
    photometric,
    photometric_reference,
    sample_params,
    train_preprocess,
)
from tests.torch_port_util import (
    assert_within_bf16_ulp,
    photometric_params,
    to_np,
)

GATE_CASES = {
    "none": (),
    "hue": ("hue",),
    "sat": ("sat",),
    "bri": ("bri",),
    "con": ("con",),
    "blur": ("blur",),
    "all": ("hue", "sat", "bri", "con", "blur"),
}
SHAPES = {"square": (16, 16), "odd_nonsquare": (11, 19)}


def _frames(rng, shape, dtype):
    h, w = shape
    if dtype == "uint8":
        return rng.integers(0, 256, (2, 3, h, w, 3)).astype(np.uint8)
    # a mixup blend: fractional 0..255 values, staged as bf16
    x = torch.from_numpy(rng.uniform(0, 255, (2, 3, h, w, 3)).astype(np.float32))
    return x.to(torch.bfloat16)


def _jax_kernel(frames, params):
    x = frames.float().numpy() if isinstance(frames, torch.Tensor) else frames
    x = jnp.asarray(x)
    if isinstance(frames, torch.Tensor):
        x = x.astype(jnp.bfloat16)
    planar = jnp.transpose(x, (0, 1, 4, 2, 3))
    out = photometric_planar(planar, jnp.asarray(params), interpret=True)
    return np.asarray(jnp.transpose(out, (0, 1, 3, 4, 2)).astype(jnp.float32))


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["uint8", "bfloat16"])
@pytest.mark.parametrize("gates", list(GATE_CASES))
def test_reference_matches_pallas_kernel(rng, gates, dtype, shape):
    """Each gate alone, all on, all off; clip 0 flipped, clip 1 not."""
    frames = _frames(rng, SHAPES[shape], dtype)
    params = photometric_params(GATE_CASES[gates], flip=(1.0, 0.0))
    x = frames if isinstance(frames, torch.Tensor) else torch.from_numpy(frames)
    got = photometric_reference(x, torch.from_numpy(params))
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    assert_within_bf16_ulp(to_np(got), _jax_kernel(frames, params))


def test_contrast_mean_is_per_frame():
    """White frame then black frame, contrast 0.5: each blends toward its
    own mean, so both stay where they are."""
    frames = np.zeros((1, 2, 8, 8, 3), np.uint8)
    frames[0, 0] = 255
    params = np.zeros((1, N_PARAMS), np.float32)
    params[0, 6], params[0, 7] = 1.0, 0.5
    out = to_np(photometric_reference(torch.from_numpy(frames), torch.from_numpy(params)))
    destd = out[0, :, 0, 0, 0] * 0.229 + 0.485
    np.testing.assert_allclose(destd, [1.0, 0.0], atol=2e-2)


def test_flip_gate_equals_flipped_input(rng):
    """Slot 14 flips the frame; with every gate on the chain commutes with
    the flip. Tolerance 1 bf16 ulp: the mirrored blur sums its taps in the
    other order."""
    frames = rng.integers(0, 256, (2, 2, 12, 17, 3)).astype(np.uint8)
    params = photometric_params(GATE_CASES["all"], flip=(1.0, 0.0))
    got = photometric_reference(torch.from_numpy(frames), torch.from_numpy(params))
    pre = frames.copy()
    pre[0] = pre[0][:, :, ::-1]
    params[:, 14] = 0.0
    want = photometric_reference(torch.from_numpy(pre), torch.from_numpy(params))
    assert_within_bf16_ulp(to_np(got), to_np(want))


def test_sample_params_ranges_and_taps():
    g = torch.Generator().manual_seed(0)
    p = sample_params(g, 4096).numpy()
    assert p.shape == (4096, N_PARAMS) and p.dtype == np.float32
    for slot, rate in ((0, 0.25), (2, 0.25), (4, 0.25), (6, 0.25), (8, 0.25), (14, 0.5)):
        assert set(np.unique(p[:, slot])) <= {0.0, 1.0}
        # 4096 draws: 4 standard deviations of a Bernoulli(rate) mean
        assert abs(p[:, slot].mean() - rate) < 4 * np.sqrt(rate * (1 - rate) / 4096)
    assert np.all((p[:, 1] >= -0.2) & (p[:, 1] <= 0.2))
    for slot in (3, 5, 7):
        assert np.all((p[:, slot] >= 0.7) & (p[:, slot] <= 1.2))
    np.testing.assert_allclose(p[:, 9:14].sum(1), 1.0, rtol=1e-5)
    np.testing.assert_array_equal(p[:, 9:14], p[:, 13:8:-1])  # symmetric taps
    assert np.all(p[:, 15] == 0.0)
    again = sample_params(torch.Generator().manual_seed(0), 4096).numpy()
    np.testing.assert_array_equal(p, again)


def test_photometric_on_cpu_is_the_reference(rng):
    frames = torch.from_numpy(rng.integers(0, 256, (2, 2, 9, 10, 3)).astype(np.uint8))
    params = torch.from_numpy(photometric_params(GATE_CASES["all"]))
    before = photometric.launches
    np.testing.assert_array_equal(
        to_np(photometric(frames, params)), to_np(photometric_reference(frames, params))
    )
    assert photometric.launches == before  # no kernel ran


def test_train_preprocess_stages_blend_as_bf16(rng):
    blend = torch.from_numpy(rng.uniform(0, 255, (2, 2, 10, 12, 3)).astype(np.float32))
    params = torch.from_numpy(photometric_params(GATE_CASES["all"]))
    out = train_preprocess(blend, params)
    assert out.dtype == torch.bfloat16 and out.shape == blend.shape
    want = photometric_reference(blend.to(torch.bfloat16), params)
    np.testing.assert_array_equal(to_np(out), to_np(want))
