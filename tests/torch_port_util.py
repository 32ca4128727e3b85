"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both the JAX package
and the port; JAX weights move to the port through
tdeed_tpu_torch.utils.jax_convert.params_from_jax.
"""

from __future__ import annotations

import numpy as np
import torch
from flax.traverse_util import flatten_dict

from tdeed_tpu_torch.utils.jax_convert import params_from_jax

# The suite runs in several worker processes at once, and pytest-xdist
# imports every test file (so this module) in each of them: torch's default
# of one thread per core in every worker oversubscribes the cores, and its
# OpenMP threads spin between the small ops of these tests. One thread per
# worker ran the whole suite in 378 s against 597 s with the default.
torch.set_num_threads(1)

N_CLASSES = 4
NC_BG = N_CLASSES + 1
FEAT = 368  # rny002 feature width


def port_state(params, batch_stats, prefix: str) -> dict:
    """Port state_dict entries under ``prefix`` (stripped) for a JAX tree
    rooted like TDEED's (e.g. {'features': {...}} or {'temp_fine': ...})."""
    sd = params_from_jax(params, batch_stats)
    return {k[len(prefix):]: v for k, v in sd.items() if k.startswith(prefix)}


def assert_trees_close(got: dict, want: dict, rtol: float, atol: float) -> None:
    """Leaf-wise allclose over two nested dicts with the same keys."""
    fg, fw = flatten_dict(got), flatten_dict(want)
    assert set(fg) == set(fw), set(fg) ^ set(fw)
    for k in fw:
        np.testing.assert_allclose(
            np.asarray(fg[k]), np.asarray(fw[k]), rtol=rtol, atol=atol,
            err_msg="/".join(k),
        )


def bf16_ulp(x: np.ndarray) -> np.ndarray:
    """Spacing of bf16 numbers (8 significant bits) at magnitude |x|."""
    a = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def assert_within_bf16_ulp(got: np.ndarray, want: np.ndarray, floor: float = 0.0) -> None:
    """|got - want| <= 1 bf16 ulp at the larger magnitude, elementwise,
    the magnitude taken as at least ``floor``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    err = np.abs(got - want)
    bound = bf16_ulp(np.maximum(np.maximum(np.abs(got), np.abs(want)), floor))
    bad = err > bound
    assert not bad.any(), (
        f"{bad.sum()} of {bad.size} values beyond 1 bf16 ulp; worst "
        f"{err.max():.4g} (bound there {bound.ravel()[err.argmax()]:.4g})"
    )


def photometric_params(gates=(), flip=(1.0, 0.0)) -> np.ndarray:
    """(2, 16) augment params with fixed factors (as in
    tests/test_augment_kernel.py); ``gates`` names the photometric gates to
    turn on ('hue', 'sat', 'bri', 'con', 'blur') for both clips, ``flip``
    the per-clip hflip gate (slot 14)."""
    slots = {"hue": 0, "sat": 2, "bri": 4, "con": 6, "blur": 8}
    p = np.zeros((2, 16), np.float32)
    p[:, 1] = [0.1, -0.15]
    p[:, 3] = [0.8, 1.1]
    p[:, 5] = [1.15, 0.75]
    p[:, 7] = [0.9, 1.2]
    sigma = np.array([0.8, 1.5], np.float32)
    offs = np.arange(-2, 3, dtype=np.float32)
    taps = np.exp(-0.5 * (offs[None] / sigma[:, None]) ** 2)
    p[:, 9:14] = taps / taps.sum(1, keepdims=True)
    for g in gates:
        p[:, slots[g]] = 1.0
    p[:, 14] = flip
    return p


def to_np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()
