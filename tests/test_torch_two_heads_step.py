"""Step 0 of the port's training step with the FC2 double head against
the JAX package's: joint two-dataset training with mixup on, a batch that
mixes a SoccerNet Ball clip (dataset 1) and a SoccerNet clip (dataset 2).

The same random values go to both sides, as in
tests/test_torch_train_step.py: the crop offset, the mixup weights, the
(B, 16) augment params and the three heads' dropout masks (fc1 and fc2 of
the double head, and the displacement head). JAX runs
``photometric_planar`` in interpret mode; the port is given that kernel's
output on the same cropped mixup blend, so the check isolates the step:
the head-2 label offset, mixup over all C1+1 + C2+1 classes, the routed
soft CE and the displacement MSE. Fixture: full rny008 widths with GSF,
two heads (5, 4), clip_len 8, B=2, 40x40 frames cropped to 32, n_layers
1, sgp_ks 3, fp32 on both sides.

Held at rtol 1e-4, as the single-head step-0 loss is (measured 1.6e-5 at
a loss of 25.7); and the port's fp32 loss against its own float64 run at
rtol 1e-4 (measured 7.7e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

import tdeed_tpu.models.heads as jheads
import tdeed_tpu.models.tdeed as jtdeed
from tdeed_tpu.kernels import augment as jkernel
from tdeed_tpu.models.common import TorchDense
from tdeed_tpu.train import augment as jaug
from tdeed_tpu.train.schedule import make_optimizer as jax_optimizer
from tdeed_tpu.train.state import TrainState
from tdeed_tpu.train.step import make_train_step as jax_train_step
from tdeed_tpu_torch.models.tdeed import TDEED
from tdeed_tpu_torch.train import step as port_step
from tdeed_tpu_torch.train.augment import mixup_batch
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train.step import StepDraws, make_train_step
from tdeed_tpu_torch.utils.jax_convert import params_from_jax
from tests.torch_port_util import photometric_params

B, T, HW, CROP = 2, 8, 40, 32
N1, N2 = 4, 3
HEADS = (N1 + 1, N2 + 1)
MODEL = dict(n_layers=1, sgp_ks=3, sgp_r=2, radi_displacement=2)
FEAT = 768
LR, WARM, COS = 8e-4, 2, 10
PORT_KEEP = {"fc1": "pred_fine.fc1", "fc2": "pred_fine.fc2", "pred_displ": "pred_displ"}


def _inputs():
    rng = np.random.default_rng(13)
    ds = np.array([1, 2], np.int32)  # clip 0 SoccerNet Ball, clip 1 SoccerNet

    def labels():  # each clip's ids in its own dataset's classes
        return np.stack([rng.integers(0, HEADS[d - 1], T) for d in ds]).astype(np.int32)

    batch = {
        "frame": rng.integers(0, 256, (B, T, HW, HW, 3)).astype(np.uint8),
        "label": labels(),
        "labelD": rng.uniform(-2, 2, (B, T)).astype(np.float32),
        "frame2": rng.integers(0, 256, (B, T, HW, HW, 3)).astype(np.uint8),
        "label2": labels(),
        "labelD2": rng.uniform(-2, 2, (B, T)).astype(np.float32),
        "dataset": ds,
    }
    draws = dict(
        crop=(4, 2),
        lam=np.array([0.375, 0.75], np.float32),  # dyadic: an exact fp32 blend
        aug=photometric_params(("hue", "sat", "con", "blur"), flip=(0.0, 1.0)),
        keep={h: rng.random((B, T, FEAT)) >= 0.5 for h in PORT_KEEP},
    )
    return batch, draws


def _jax_step(mp, batch, draws):
    """JAX's step-0 loss with the injected draws; returns (variables, loss)."""
    i, j = draws["crop"]
    keep = {k: jnp.asarray(v) for k, v in draws["keep"].items()}

    class MaskedFC(jheads.FCLayers):  # same params as FCLayers, injected mask
        @fnn.compact
        def __call__(self, x, train):
            if train:
                x = jnp.where(keep[self.name], x / 0.5, 0.0)
            return TorchDense(self.num_classes, dtype=self.dtype, name="fc_out")(x)

    def preprocess(frames, key, crop_dim, interpret=False):
        planar = jnp.transpose(frames, (0, 1, 4, 2, 3)).astype(jnp.bfloat16)
        out = jkernel.photometric_planar(planar, jnp.asarray(draws["aug"]), interpret=True)
        return jnp.transpose(out, (0, 1, 3, 4, 2))

    mp.setattr(jtdeed, "FCLayers", MaskedFC)
    mp.setattr(jheads, "FCLayers", MaskedFC)  # the FC2 head's two FCLayers
    mp.setattr(jaug, "random_crop_batch", lambda x, c, k: x[:, :, i:i + c, j:j + c, :])
    mp.setattr(jaug, "sample_mixup_lam", lambda k, b: jnp.asarray(draws["lam"]))
    mp.setattr(jkernel, "train_preprocess_pallas", preprocess)

    jm = jtdeed.TDEED(num_classes=N1, clip_len=T, feature_arch="rny008_gsf",
                      two_heads=HEADS, dtype=jnp.float32, **MODEL)
    v = jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(6), jnp.zeros((B, T, CROP, CROP, 3)), False)
    tx = jax_optimizer(LR, WARM, COS)
    step = jax.jit(jax_train_step(
        jm, tx, crop_dim=CROP, num_classes_bg=HEADS[0], mixup=True, radi_displacement=2,
        two_heads=HEADS, pretrain_classes_bg=HEADS[1], pallas_augment=True,
    ))
    _, metrics = step(TrainState.create(v["params"], v["batch_stats"], tx),
                      jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(1))
    return v, float(metrics["loss"])


def _jax_augmented(batch, draws):
    """The JAX kernel's output on the step's cropped mixup blend (the
    blend's one bf16 rounding is the same in both packages)."""
    i, j = draws["crop"]
    crop = lambda x: torch.from_numpy(x[:, :, i:i + CROP, j:j + CROP])  # noqa: E731
    blend, _, _ = mixup_batch(crop(batch["frame"]), torch.from_numpy(batch["label"]),
                              crop(batch["frame2"]), torch.from_numpy(batch["label2"]),
                              torch.from_numpy(draws["lam"]), sum(HEADS))
    planar = jnp.transpose(jnp.asarray(blend.float().numpy()).astype(jnp.bfloat16),
                           (0, 1, 4, 2, 3))
    out = jkernel.photometric_planar(planar, jnp.asarray(draws["aug"]), interpret=True)
    out = np.array(jnp.transpose(out, (0, 1, 3, 4, 2)).astype(jnp.float32))
    return torch.from_numpy(out).to(torch.bfloat16)


def _port_loss(variables, batch, draws, augmented, dtype):
    pm = TDEED(N1, T, dtype=dtype, arch="rny008", two_heads=HEADS, **MODEL)
    sd = params_from_jax(variables["params"], variables["batch_stats"])
    if dtype == torch.float64:
        pm = pm.double()
        sd = {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}
    pm.load_state_dict(sd, strict=True)
    opt, sched = make_optimizer(pm.parameters(), LR, WARM, COS)
    step = make_train_step(pm, opt, sched, crop_dim=CROP, num_classes_bg=HEADS[0],
                           mixup=True, radi_displacement=2)
    d = StepDraws(draws["crop"], torch.from_numpy(draws["lam"]), torch.from_numpy(draws["aug"]),
                  {PORT_KEEP[k]: torch.from_numpy(v) for k, v in draws["keep"].items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_step, "train_preprocess", lambda frames, params: augmented)
        return float(step({k: torch.from_numpy(v) for k, v in batch.items()}, [d])["loss"])


@pytest.fixture(scope="module")
def step0():
    batch, draws = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        variables, jax_loss = _jax_step(mp, batch, draws)
    augmented = _jax_augmented(batch, draws)
    return jax_loss, {dtype: _port_loss(variables, batch, draws, augmented, dtype)
                      for dtype in (torch.float32, torch.float64)}


def test_two_head_step0_loss_matches_jax(step0):
    jax_loss, port = step0
    assert np.isfinite(port[torch.float32])
    np.testing.assert_allclose(port[torch.float32], jax_loss, rtol=1e-4)
    np.testing.assert_allclose(port[torch.float32], port[torch.float64], rtol=1e-4)


def test_two_head_draws_name_each_head():
    """The step draws one mask per head of the model, under the names the
    model's forward reads, and each is its own draw."""
    pm = TDEED(N1, T, dtype=torch.float32, arch="rny008", two_heads=HEADS, **MODEL)
    opt, sched = make_optimizer(pm.parameters(), LR, WARM, COS)
    step = make_train_step(pm, opt, sched, crop_dim=CROP, num_classes_bg=HEADS[0],
                           mixup=True, radi_displacement=2)
    batch, _ = _inputs()
    (d,) = step.draw(batch)
    assert list(d.dropout_keep) == list(PORT_KEEP.values())
    assert {tuple(m.shape) for m in d.dropout_keep.values()} == {(B, T, FEAT)}
    assert not torch.equal(d.dropout_keep["pred_fine.fc1"], d.dropout_keep["pred_fine.fc2"])
