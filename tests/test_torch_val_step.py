"""The port's validation step against the JAX package's ``make_val_step``
(tdeed_tpu/train/step.py:205-247) at fp32, from the same weights and
running BN statistics (drawn from a numpy seed, so eval mode reads
non-trivial statistics), on uint8 clips that both center-crop.

Fixture: full rny002 widths with GSF, clip_len 8, B=2, 40x40 frames
cropped to 32, n_layers 1, sgp_ks 3, displacement radius 2. Held: loss at
rtol 1e-4 (measured 0, the same fp32 number), logits and displacement
at atol 1e-4 (measured 3.1e-6 at magnitude 3.9, and 2.1e-6).
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import tdeed_tpu.models.tdeed as jtdeed
from tdeed_tpu.train.step import make_val_step as jax_val_step
from tdeed_tpu_torch.models.tdeed import TDEED
from tdeed_tpu_torch.train.step import make_val_step
from tdeed_tpu_torch.utils.jax_convert import params_from_jax
from tests.torch_port_util import N_CLASSES, NC_BG, to_np

B, T, HW, CROP = 2, 8, 40, 32
MODEL = dict(n_layers=1, sgp_ks=3, sgp_r=2, radi_displacement=2)


def _running_stats(batch_stats, rng):
    flat = flatten_dict(jax.tree.map(np.asarray, batch_stats))
    out = {}
    for k, v in flat.items():
        if k[-1] == "mean":
            out[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 2.0, v.shape).astype(np.float32)
    return unflatten_dict(out)


@pytest.fixture(scope="module")
def val_outputs():
    rng = np.random.default_rng(11)
    batch = {
        "frame": rng.integers(0, 256, (B, T, HW, HW, 3)).astype(np.uint8),
        "label": rng.integers(0, NC_BG, (B, T)).astype(np.int32),
        "labelD": rng.uniform(-2, 2, (B, T)).astype(np.float32),
    }
    jm = jtdeed.TDEED(num_classes=N_CLASSES, clip_len=T, dtype=jnp.float32, **MODEL)
    v = jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(4), jnp.zeros((B, T, CROP, CROP, 3)), False
    )
    params, stats = v["params"], _running_stats(v["batch_stats"], rng)
    step = jax_val_step(jm, crop_dim=CROP, num_classes_bg=NC_BG, radi_displacement=2)
    want = jax.jit(lambda p, s, b: step(SimpleNamespace(params=p, batch_stats=s), b))(
        params, stats, jax.tree.map(jnp.asarray, batch)
    )

    pm = TDEED(N_CLASSES, T, dtype=torch.float32, **MODEL)
    pm.load_state_dict(params_from_jax(params, stats), strict=True)
    pm.train()  # the step must switch to eval mode itself
    got = make_val_step(pm, crop_dim=CROP, num_classes_bg=NC_BG, radi_displacement=2)(
        {k: torch.from_numpy(x) for k, x in batch.items()}
    )
    return got, {k: np.asarray(x) for k, x in want.items()}, pm


def test_val_step_matches_jax(val_outputs):
    got, want, _ = val_outputs
    assert set(got) == set(want) == {"loss", "logits", "displ"}
    assert got["logits"].shape == (B, T, NC_BG) and got["displ"].shape == (B, T)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    np.testing.assert_allclose(to_np(got["logits"]), want["logits"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(to_np(got["displ"]), want["displ"], rtol=0, atol=1e-4)


def test_val_step_changes_no_state(val_outputs):
    """Running statistics are read, not updated; nothing keeps a graph."""
    got, _, model = val_outputs
    assert not got["loss"].requires_grad
    assert {int(v) for k, v in model.state_dict().items()
            if k.endswith("num_batches_tracked")} == {0}
