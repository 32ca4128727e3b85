"""The port's rny008_gsf model with the FC2 double head against the JAX
package's, same weights: the state_dict bridge, the eval forward (through
the val step, with its routed loss), the train-mode forward with its BN
statistics, the predict step's head-1 scores, the FC2 head alone and
``double_head_ce``.

Fixture: the full rny008 trunk widths (64, 128, 320, 768; group width 16)
with GSF in s3/s4, two heads (5, 4) = 4 + 1 and 3 + 1 classes, clip_len 8,
B=2, 40x40 frames center-cropped to 32, n_layers 1, sgp_ks 3, sgp_r 2,
displacement radius 2, fp32 on both sides; running BN statistics drawn
from a numpy seed, so eval mode reads non-trivial statistics. This
mirrors tests/test_train_step_oracle.py::test_rny008_full_model_forward_matches_torch,
with the port in the torch oracle's place.

Tolerances, with what was measured on this fixture: the val step's loss
at rtol 1e-4 (measured 7.8e-7), eval logits and displacement at atol 1e-4
(measured 5.0e-6 at magnitude 3.2, and 4.4e-6), as
tests/test_torch_val_step.py holds rny002; predict scores at atol 1e-4
(measured 6.0e-7); train mode at the known train-mode BN floor of
tests/test_torch_slice.py, atol 2e-3 against JAX (measured 6.5e-4; JAX is
4.7e-4 from the port's float64 run) and 5e-4 against the port's own
float64 run (measured 1.9e-4); ``double_head_ce`` and the FC2 logits at
rtol 1e-6, where both sides compute the same fp32 expression.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import tdeed_tpu.models.heads as jheads
from tdeed_tpu.models.common import TorchDense
from tdeed_tpu.models.tdeed import TDEED as JaxTDEED
from tdeed_tpu.train import augment as jaug
from tdeed_tpu.train.losses import class_weights as jax_class_weights
from tdeed_tpu.train.losses import double_head_ce as jax_double_head_ce
from tdeed_tpu.train.step import make_predict_step as jax_predict_step
from tdeed_tpu.train.step import make_val_step as jax_val_step
from tdeed_tpu_torch.models.heads import FC2Layers
from tdeed_tpu_torch.models.tdeed import TDEED
from tdeed_tpu_torch.train.losses import class_weights, double_head_ce
from tdeed_tpu_torch.train.step import make_predict_step, make_val_step
from tdeed_tpu_torch.utils.jax_convert import params_from_jax
from tests.torch_port_util import assert_trees_close, to_np
from tools.import_reference_checkpoint import convert_reference_state_dict

B, T, HW, CROP = 2, 8, 40, 32
N1, N2 = 4, 3  # foreground classes of head 1 and head 2
HEADS = (N1 + 1, N2 + 1)
MODEL = dict(n_layers=1, sgp_ks=3, sgp_r=2, radi_displacement=2)
FEAT = 768


def _running_stats(batch_stats, rng):
    flat = flatten_dict(jax.tree.map(np.asarray, batch_stats))
    return unflatten_dict({
        k: (rng.normal(0, 0.2, v.shape) if k[-1] == "mean"
            else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
        for k, v in flat.items()
    })


@pytest.fixture(scope="module")
def jax_model():
    rng = np.random.default_rng(23)
    jm = JaxTDEED(num_classes=N1, clip_len=T, feature_arch="rny008_gsf",
                  two_heads=HEADS, dtype=jnp.float32, **MODEL)
    v = jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(2), jnp.zeros((B, T, CROP, CROP, 3)), False
    )
    batch = {
        "frame": rng.integers(0, 256, (B, T, HW, HW, 3)).astype(np.uint8),
        "label": rng.integers(0, N1 + 1, (B, T)).astype(np.int32),
        "labelD": rng.uniform(-2, 2, (B, T)).astype(np.float32),
        "dataset": np.array([2, 1], np.int32),
    }
    batch["label"][0] = rng.integers(0, N2 + 1, T)  # a head-2 clip's own ids
    return jm, v["params"], _running_stats(v["batch_stats"], rng), batch


def _port(params, stats, dtype=torch.float32):
    pm = TDEED(N1, T, dtype=dtype, arch="rny008", two_heads=HEADS, **MODEL)
    sd = params_from_jax(params, stats)
    if dtype == torch.float64:
        sd = {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}
        pm = pm.double()
    pm.load_state_dict(sd, strict=True)
    return pm


def test_rny008_state_dict_bridge_round_trips(jax_model):
    """JAX trees with the FC2 head -> port (strict load) ->
    convert_reference_state_dict -> the same trees, bit for bit."""
    _, params, stats, _ = jax_model
    pm = _port(params, stats)
    assert pm.feat_dim == FEAT
    assert pm.dropout_heads == ["pred_fine.fc1", "pred_fine.fc2", "pred_displ"]
    p2, s2, _ = convert_reference_state_dict(pm.state_dict())
    assert_trees_close(p2, jax.tree.map(np.asarray, params), rtol=0, atol=0)
    assert_trees_close(s2, jax.tree.map(np.asarray, stats), rtol=0, atol=0)
    assert sum(p.numel() for p in pm.parameters()) == sum(
        np.size(x) for x in jax.tree.leaves(params))


def test_rny008_eval_forward_and_val_step_match_jax(jax_model):
    """The val step's eval forward (center crop, running statistics, no
    dropout) and its loss routed per clip: clip 0 is a head-2 clip."""
    jm, params, stats, batch = jax_model
    step = jax_val_step(jm, crop_dim=CROP, num_classes_bg=HEADS[0], radi_displacement=2,
                        two_heads=HEADS, pretrain_classes_bg=HEADS[1])
    want = jax.jit(lambda p, s, b: step(SimpleNamespace(params=p, batch_stats=s), b))(
        params, stats, jax.tree.map(jnp.asarray, batch))
    pm = _port(params, stats).train()  # the step must switch to eval mode itself
    got = make_val_step(pm, crop_dim=CROP, num_classes_bg=HEADS[0], radi_displacement=2)(
        {k: torch.from_numpy(x) for k, x in batch.items()})
    assert got["logits"].shape == (B, T, sum(HEADS))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), rtol=1e-4)
    for k in ("logits", "displ"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


def test_rny008_train_forward_and_bn_stats_match_jax(jax_model, monkeypatch):
    """Train mode (batch statistics), dropout off on both sides, at the
    train-mode BN floor (module docstring)."""
    jm, params, stats, batch = jax_model
    monkeypatch.setattr(jheads.nn, "Dropout", lambda rate, deterministic=None: (lambda x: x))
    x = np.array(jaug.eval_preprocess(jnp.asarray(batch["frame"]), CROP))
    want, upd = jax.jit(
        lambda p, s, x_: jm.apply({"params": p, "batch_stats": s}, x_, True,
                                  mutable=["batch_stats"])
    )(params, stats, jnp.asarray(x))
    outs = {}
    for dtype in (torch.float32, torch.float64):
        pm = _port(params, stats, dtype).train()
        with torch.no_grad():
            outs[dtype] = (pm(torch.from_numpy(x)), pm.state_dict())
    (got, sd), (got64, _) = outs[torch.float32], outs[torch.float64]
    for k in ("logits", "displ"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=1e-4, atol=2e-3,
                                   err_msg=k)
        np.testing.assert_allclose(to_np(got[k]), to_np(got64[k]), rtol=1e-4, atol=5e-4,
                                   err_msg=k)
    _, new_stats, _ = convert_reference_state_dict(sd)
    assert_trees_close(new_stats, jax.tree.map(np.asarray, upd["batch_stats"]),
                       rtol=1e-4, atol=2e-4)


def test_rny008_predict_step_scores_head_1(jax_model):
    """Softmax over head 1's logits alone, displacement-decoded:
    (B, T, C1+1) scores at atol 1e-4, the same argmax."""
    jm, params, stats, batch = jax_model
    jpredict = jax.jit(jax_predict_step(jm, crop_dim=CROP, radi_displacement=2,
                                        two_heads=HEADS), static_argnums=3)
    want_cls, want = jpredict(params, stats, jnp.asarray(batch["frame"]), False)
    predict = make_predict_step(_port(params, stats), crop_dim=CROP, radi_displacement=2)
    got_cls, got = predict(torch.from_numpy(batch["frame"]))
    assert got.shape == (B, T, HEADS[0])
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got_cls.numpy(), np.asarray(want_cls))


@pytest.mark.parametrize("masked", [False, True], ids=["eval", "masks"])
def test_fc2_logits_match_jax(masked, monkeypatch):
    """The two heads concatenated on the class axis, from the same
    weights; in train mode each head takes its own dropout mask (injected
    into JAX's FCLayers, as tests/test_torch_train_step.py does)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (B, T, 48)).astype(np.float32)
    keep = {name: rng.random((B, T, 48)) >= 0.5 for name in ("fc1", "fc2")}

    class MaskedFC(jheads.FCLayers):  # same params as FCLayers, injected mask
        @jheads.nn.compact
        def __call__(self, x_, train):
            if train:
                x_ = jnp.where(keep[self.name], x_ / 0.5, 0.0)
            return TorchDense(self.num_classes, dtype=self.dtype, name="fc_out")(x_)

    monkeypatch.setattr(jheads, "FCLayers", MaskedFC)
    head = jheads.FC2Layers(HEADS)
    v = head.init(jax.random.PRNGKey(0), jnp.asarray(x), False)
    want = head.apply(v, jnp.asarray(x), masked)
    pm = FC2Layers(48, HEADS)
    sd = params_from_jax({"pred_fine": v["params"]}, {})
    pm.load_state_dict({k[len("_pred_fine."):]: t for k, t in sd.items()}, strict=True)
    masks = [torch.from_numpy(keep[n]) for n in ("fc1", "fc2")] if masked else [None, None]
    got = pm(torch.from_numpy(x), *masks)
    assert tuple(got.shape) == (B, T, sum(HEADS))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("soft", [False, True], ids=["hard", "soft"])
def test_double_head_ce_matches_jax(soft):
    """Batches that mix dataset ids 1 and 2, hard ids with head-2 clips
    offset by C1+1 (some beyond head 2's range for a head-1 clip, which
    the clip keeps in bounds), or soft two-head distributions."""
    rng = np.random.default_rng(9)
    b, c = 5, sum(HEADS)
    logits = rng.normal(0, 2, (b, T, c)).astype(np.float32)
    ds = np.array([1, 2, 2, 1, 2], np.int32)
    if soft:
        target = rng.dirichlet(np.ones(c), (b, T)).astype(np.float32)
    else:
        target = np.where(ds[:, None] == 2, rng.integers(0, HEADS[1], (b, T)) + HEADS[0],
                          rng.integers(0, HEADS[0], (b, T))).astype(np.int32)
        target[0, :2] = c - 1  # a head-1 clip with an id in head 2's range
    w1, w2 = jax_class_weights(HEADS[0]), jax_class_weights(HEADS[1])
    want = jax_double_head_ce(jnp.asarray(logits), jnp.asarray(target), jnp.asarray(ds),
                              HEADS[0], w1, w2, soft=soft)
    got = double_head_ce(torch.from_numpy(logits), torch.from_numpy(target),
                         torch.from_numpy(ds), HEADS[0], class_weights(HEADS[0]),
                         class_weights(HEADS[1]), soft=soft)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
