"""The port's whole model against the JAX package's, same weights: the
state_dict bridge, the eval forward, the train-mode forward with its BN
statistics, and the predict step with and without the hflip TTA.

Fixture: the full rny002 trunk widths with GSF in s3/s4, clip_len 8, B=2,
40x40 frames (center-cropped to 32 where a step crops), the flagship
temporal stack (n_layers 2, sgp_ks 7, sgp_r 4), radi_displacement 2, fp32
on both sides.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import tdeed_tpu.models.heads as jheads
from tdeed_tpu.models.tdeed import TDEED as JaxTDEED
from tdeed_tpu.train import augment as jaug
from tdeed_tpu.train.step import make_predict_step as jax_predict_step
from tdeed_tpu_torch.models.tdeed import TDEED
from tdeed_tpu_torch.train.augment import eval_preprocess
from tdeed_tpu_torch.train.step import make_predict_step
from tdeed_tpu_torch.utils.jax_convert import params_from_jax
from tests.torch_port_util import N_CLASSES, assert_trees_close, to_np
from tools.import_reference_checkpoint import convert_reference_state_dict

B, T, HW, CROP = 2, 8, 40, 32
MODEL = dict(n_layers=2, sgp_ks=7, sgp_r=4, radi_displacement=2)
RTOL, ATOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(7)
    jm = JaxTDEED(num_classes=N_CLASSES, clip_len=T, dtype=jnp.float32, **MODEL)
    v = jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.zeros((B, T, CROP, CROP, 3)), False
    )
    # non-default running stats: the eval path then reads every stats leaf
    stats = jax.tree.map(
        lambda a: a + np.abs(rng.normal(0, 0.1, a.shape)).astype(np.float32),
        v["batch_stats"],
    )
    frames = rng.integers(0, 256, (B, T, HW, HW, 3)).astype(np.uint8)
    return jm, v["params"], stats, frames


def _port(params, stats, dtype=torch.float32):
    pm = TDEED(N_CLASSES, T, dtype=dtype, **MODEL)
    sd = params_from_jax(params, stats)
    if dtype == torch.float64:
        sd = {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}
        pm = pm.double()
    pm.load_state_dict(sd, strict=True)
    return pm


def test_state_dict_bridge_round_trips(jax_model):
    """JAX trees -> port (strict load: no missing or unexpected key) ->
    convert_reference_state_dict -> the same JAX trees, bit for bit."""
    _, params, stats, _ = jax_model
    pm = _port(params, stats)
    p2, s2, skipped = convert_reference_state_dict(pm.state_dict())
    assert_trees_close(p2, jax.tree.map(np.asarray, params), rtol=0, atol=0)
    assert_trees_close(s2, jax.tree.map(np.asarray, stats), rtol=0, atol=0)
    assert skipped and all(k.endswith("num_batches_tracked") for k in skipped)
    assert sum(p.numel() for p in pm.parameters()) == sum(
        np.size(x) for x in jax.tree.leaves(params)
    )


def test_eval_forward_matches_jax(jax_model):
    jm, params, stats, frames = jax_model
    x = jaug.eval_preprocess(jnp.asarray(frames), CROP)
    want = jax.jit(lambda p, s, x_: jm.apply({"params": p, "batch_stats": s}, x_, False))(
        params, stats, x
    )
    pm = _port(params, stats).eval()
    with torch.no_grad():
        got = pm(eval_preprocess(torch.from_numpy(frames), CROP))
    for k in ("logits", "displ"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def test_train_forward_and_bn_stats_match_jax(jax_model, monkeypatch):
    """Train mode (batch statistics), dropout off on both sides.

    rtol 1e-4 with an absolute term, for a measured reason: XLA's CPU
    reductions accumulate fp32 sequentially (a mean over 65,536 values is
    off by 2.4e-6 relative, torch's by 1.4e-7), and E[x^2] - E[x]^2 over
    these 16 frames carries that through 13 train-mode BNs. Measured
    against a float64 run of the port: JAX's fp32 logits 7.4e-4 off (at
    magnitude 4.5), the port's 1.8e-4; JAX's BN stats 5.0e-5, the port's
    1.2e-5. Held: logits and displacement atol 2e-3 against JAX and 5e-4
    against the port's float64 run; BN stats atol 2e-4."""
    jm, params, stats, frames = jax_model
    monkeypatch.setattr(jheads.nn, "Dropout", lambda rate, deterministic=None: (lambda x: x))
    x = np.array(jaug.eval_preprocess(jnp.asarray(frames), CROP))
    want, upd = jax.jit(
        lambda p, s, x_: jm.apply({"params": p, "batch_stats": s}, x_, True, mutable=["batch_stats"])
    )(params, stats, jnp.asarray(x))

    outs = {}
    for dtype in (torch.float32, torch.float64):
        pm = _port(params, stats, dtype).train()
        with torch.no_grad():
            outs[dtype] = (pm(torch.from_numpy(x)), pm.state_dict())
    got, sd = outs[torch.float32]
    got64, _ = outs[torch.float64]
    for k in ("logits", "displ"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=RTOL, atol=2e-3, err_msg=k)
        np.testing.assert_allclose(to_np(got[k]), to_np(got64[k]), rtol=RTOL, atol=5e-4, err_msg=k)
    _, new_stats, _ = convert_reference_state_dict(sd)
    assert_trees_close(new_stats, jax.tree.map(np.asarray, upd["batch_stats"]), rtol=RTOL, atol=2e-4)
    # the update moved the stats: this compares fresh batch statistics
    old = flatten_dict(jax.tree.map(np.asarray, stats))
    new = flatten_dict(new_stats)
    assert all(not np.allclose(old[k], new[k]) for k in old)


@pytest.mark.parametrize("hflip", [False, True])
def test_predict_step_matches_jax(jax_model, hflip):
    jm, params, stats, frames = jax_model
    jpredict = jax.jit(
        jax_predict_step(jm, crop_dim=CROP, radi_displacement=2), static_argnums=3
    )
    want_cls, want = jpredict(params, stats, jnp.asarray(frames), hflip)
    predict = make_predict_step(_port(params, stats), crop_dim=CROP, radi_displacement=2)
    got_cls, got = predict(torch.from_numpy(frames), hflip=hflip)
    assert got.shape == (B, T, N_CLASSES + 1)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    # decoded scores keep untargeted positions at exactly 0
    np.testing.assert_array_equal(to_np(got) == 0, np.asarray(want) == 0)
    np.testing.assert_array_equal(got_cls.numpy(), np.asarray(want_cls))
