"""Step 0 of the port's training step against the JAX package's, with
the fused photometric kernel on the augment path: with mixup on, and the
loss with mixup off (the uint8 crop straight into the kernel).

The same random values go to both sides: the crop offset, the mixup
weights, the (B, 16) augment params with the flip gate in slot 14, and
the two heads' dropout masks. On the JAX side they replace
``random_crop_batch``, ``sample_mixup_lam``, ``train_preprocess_pallas``
(which then runs ``photometric_planar`` in interpret mode) and the heads'
dropout, following tests/test_lam_replay.py. The port takes them as a
StepDraws. Fixture: full rny002 widths with GSF, clip_len 8, B=2, 40x40
frames cropped to 32, n_layers 1, sgp_ks 3, fp32 model on both sides.

Tolerances, with what was measured on this fixture:
  * The two kernels (JAX's Pallas kernel, the port's plain chain) agree
    within 1 bf16 ulp but not bit for bit: 17 of the 49,152 augmented
    values sit one bf16 ulp apart. Train-mode BN over 16 frames of 1x1
    maps at s4 amplifies that into a 1.2e-4 relative step-0 loss gap
    (1.1e-3 with blocky frames in place of noise), so each side running
    its own kernel is held at rtol 2e-3.
  * Given the JAX kernel's output as its augmented input, the port's loss
    is 3.5e-5 from JAX's: held at rtol 1e-4. The port's fp32 loss is
    5e-6 from its own float64 run: held at rtol 1e-4.
  * The gradient of this fixture is fp32-ill-conditioned
    (docs/DESIGN.md:382-391): the port's fp32 gradients sit 1.7e-2 (global
    relative L2) from its float64 run, JAX's 1.75e-2 from the port's on
    the same input. Adam's first step is lr * sign(g), so elements whose
    gradient is below that noise may step the other way: 0.15% of the
    parameter elements do.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from flax.traverse_util import flatten_dict

import tdeed_tpu.models.tdeed as jtdeed
from tdeed_tpu.kernels import augment as jkernel
from tdeed_tpu.models.common import TorchDense
from tdeed_tpu.models.heads import FCLayers as JaxFCLayers
from tdeed_tpu.train import augment as jaug
from tdeed_tpu.train.schedule import make_optimizer as jax_optimizer
from tdeed_tpu.train.state import TrainState
from tdeed_tpu.train.step import make_train_step as jax_train_step
from tdeed_tpu_torch.models.tdeed import TDEED
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train import step as port_step
from tdeed_tpu_torch.train.augment import mixup_batch
from tdeed_tpu_torch.train.step import StepDraws, make_train_step
from tdeed_tpu_torch.utils.jax_convert import params_from_jax
from tests.torch_port_util import FEAT, N_CLASSES, NC_BG, photometric_params
from tools.import_reference_checkpoint import convert_reference_state_dict

B, T, HW, CROP = 2, 8, 40, 32
MODEL = dict(n_layers=1, sgp_ks=3, sgp_r=2, radi_displacement=2)
LR, WARM, COS = 8e-4, 2, 10


def _inputs():
    rng = np.random.default_rng(3)
    batch = {
        "frame": rng.integers(0, 256, (B, T, HW, HW, 3)).astype(np.uint8),
        "label": rng.integers(0, NC_BG, (B, T)).astype(np.int32),
        "labelD": rng.uniform(-2, 2, (B, T)).astype(np.float32),
        "frame2": rng.integers(0, 256, (B, T, HW, HW, 3)).astype(np.uint8),
        "label2": rng.integers(0, NC_BG, (B, T)).astype(np.int32),
        "labelD2": rng.uniform(-2, 2, (B, T)).astype(np.float32),
    }
    draws = dict(
        crop=(3, 5),
        # dyadic weights: the fp32 blend is exact in both frameworks, so
        # its one bf16 rounding is the same on both sides
        lam=np.array([0.25, 0.625], np.float32),
        aug=photometric_params(("hue", "sat", "bri", "con", "blur"), flip=(1.0, 0.0)),
        keep={h: rng.random((B, T, FEAT)) >= 0.5 for h in ("pred_fine", "pred_displ")},
    )
    return batch, draws


def _jax_step(monkeypatch, batch, draws, mixup=True, variables=None, acc_grad_iter=1,
              feature_arch="rny002_gsf", checkpoint_backbone=False):
    """One JAX train step with the injected draws (the same for every
    micro-batch), from ``variables`` or a fresh init; returns (variables,
    loss, state)."""
    i, j = draws["crop"]
    keep = {k: jnp.asarray(v) for k, v in draws["keep"].items()}

    class MaskedFC(JaxFCLayers):  # same params as FCLayers, injected mask
        @fnn.compact
        def __call__(self, x, train):
            if train:
                x = jnp.where(keep[self.name], x / 0.5, 0.0)
            return TorchDense(self.num_classes, dtype=self.dtype, name="fc_out")(x)

    def preprocess(frames, key, crop_dim, interpret=False):
        planar = jnp.transpose(frames, (0, 1, 4, 2, 3))
        if not jnp.issubdtype(planar.dtype, jnp.integer):
            planar = planar.astype(jnp.bfloat16)
        out = jkernel.photometric_planar(planar, jnp.asarray(draws["aug"]), interpret=True)
        return jnp.transpose(out, (0, 1, 3, 4, 2))

    monkeypatch.setattr(jtdeed, "FCLayers", MaskedFC)
    monkeypatch.setattr(jaug, "random_crop_batch", lambda x, c, k: x[:, :, i:i + c, j:j + c, :])
    monkeypatch.setattr(jaug, "sample_mixup_lam", lambda k, b: jnp.asarray(draws["lam"]))
    monkeypatch.setattr(jkernel, "train_preprocess_pallas", preprocess)

    jm = jtdeed.TDEED(num_classes=N_CLASSES, clip_len=T, dtype=jnp.float32,
                      feature_arch=feature_arch, checkpoint_backbone=checkpoint_backbone, **MODEL)
    v = variables or jax.jit(jm.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.zeros((B, T, CROP, CROP, 3)), False
    )
    tx = jax_optimizer(LR, WARM, COS)
    state = TrainState.create(v["params"], v["batch_stats"], tx)
    step = jax.jit(jax_train_step(
        jm, tx, crop_dim=CROP, num_classes_bg=NC_BG, mixup=mixup,
        radi_displacement=2, pallas_augment=True, acc_grad_iter=acc_grad_iter,
    ))
    new, metrics = step(state, jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(1))
    return v, float(metrics["loss"]), new


def _jax_augmented(batch, draws, mixup=True):
    """The JAX kernel's output on the step's cropped mixup blend, or with
    mixup off on its uint8 crop (the port's crop and blend equal JAX's bit
    for bit: tests/test_torch_temporal.py)."""
    i, j = draws["crop"]
    crop = lambda x: torch.from_numpy(x[:, :, i:i + CROP, j:j + CROP])  # noqa: E731
    if mixup:
        blend, _, _ = mixup_batch(
            crop(batch["frame"]), torch.from_numpy(batch["label"]),
            crop(batch["frame2"]), torch.from_numpy(batch["label2"]),
            torch.from_numpy(draws["lam"]), NC_BG,
        )
        frames = jnp.asarray(blend.float().numpy()).astype(jnp.bfloat16)
    else:
        frames = jnp.asarray(crop(batch["frame"]).numpy())
    planar = jnp.transpose(frames, (0, 1, 4, 2, 3))
    out = jkernel.photometric_planar(planar, jnp.asarray(draws["aug"]), interpret=True)
    out = np.array(jnp.transpose(out, (0, 1, 3, 4, 2)).astype(jnp.float32))
    return torch.from_numpy(out).to(torch.bfloat16)


def _port_step(variables, batch, draws, dtype, augmented=None, mixup=True, acc_grad_iter=1,
               shift_mode="gsf", checkpoint_backbone=False):
    """One port train step from the JAX weights, with the same draws for
    every micro-batch; ``augmented`` (one tensor per micro-batch) replaces
    the port's photometric kernel output. Returns (model, loss,
    gradients)."""
    pm = TDEED(N_CLASSES, T, dtype=dtype, shift_mode=shift_mode,
               checkpoint_backbone=checkpoint_backbone, **MODEL)
    sd = params_from_jax(variables["params"], variables["batch_stats"])
    if dtype == torch.float64:
        pm = pm.double()
        sd = {k: v.double() if v.is_floating_point() else v for k, v in sd.items()}
    pm.load_state_dict(sd, strict=True)
    opt, sched = make_optimizer(pm.parameters(), LR, WARM, COS)
    step = make_train_step(
        pm, opt, sched, crop_dim=CROP, num_classes_bg=NC_BG, mixup=mixup,
        radi_displacement=2, acc_grad_iter=acc_grad_iter,
    )
    d = StepDraws(
        draws["crop"], torch.from_numpy(draws["lam"]), torch.from_numpy(draws["aug"]),
        {k: torch.from_numpy(v) for k, v in draws["keep"].items()},
    )
    with pytest.MonkeyPatch.context() as mp:
        if augmented is not None:
            outs = iter(augmented)
            mp.setattr(port_step, "train_preprocess", lambda frames, params: next(outs))
        loss = float(step({k: torch.from_numpy(v) for k, v in batch.items()},
                          [d] * acc_grad_iter)["loss"])
    grads = {n: opt.state[p]["exp_avg"] / 0.1 for n, p in pm.named_parameters()}
    return pm, loss, grads


@pytest.fixture(scope="module")
def step0():
    batch, draws = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        variables, jax_loss, jax_state = _jax_step(mp, batch, draws)
    return dict(
        variables=variables, jax_loss=jax_loss, jax_state=jax_state,
        port32=_port_step(variables, batch, draws, torch.float32),
        port64=_port_step(variables, batch, draws, torch.float64),
        same_aug=_port_step(variables, batch, draws, torch.float32,
                            [_jax_augmented(batch, draws)]),
    )


def test_step0_loss_matches_jax(step0):
    jax_loss = step0["jax_loss"]
    loss32, loss64, same = step0["port32"][1], step0["port64"][1], step0["same_aug"][1]
    assert np.isfinite(loss32)
    np.testing.assert_allclose(same, jax_loss, rtol=1e-4)  # same augmented input
    np.testing.assert_allclose(loss32, loss64, rtol=1e-4)
    np.testing.assert_allclose(loss32, jax_loss, rtol=2e-3)  # each its own kernel


@pytest.fixture(scope="module")
def step0_mixup_off(step0):
    """JAX's step-0 loss with mixup off from the same initial weights, and
    the port's given the JAX kernel's output on the uint8 crop."""
    batch, draws = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        _, jax_loss, _ = _jax_step(mp, batch, draws, mixup=False, variables=step0["variables"])
    augmented = _jax_augmented(batch, draws, mixup=False)
    port = _port_step(step0["variables"], batch, draws, torch.float32, [augmented], mixup=False)
    return jax_loss, port[1]


def test_step0_loss_matches_jax_with_mixup_off(step0_mixup_off):
    """Without mixup the uint8 crop goes straight to the kernel and the loss
    takes the hard labels: the same augmented input gives JAX's loss at
    rtol 1e-4, as with mixup on."""
    jax_loss, same = step0_mixup_off
    assert np.isfinite(same)
    np.testing.assert_allclose(same, jax_loss, rtol=1e-4)


def test_step0_params_and_bn_stats_match_jax(step0):
    """After one AdamW step at lr(0) = 8e-6 (warmup start factor 0.01), on
    the same augmented input. Adam's first step moves every weight by
    about lr(0) in the direction -sign(g), so a wrong lr, sign or decay
    term moves every element: at least 99% of the elements must sit
    within a quarter of that step of JAX's (the rest have gradients below
    the fp32 noise, see the module docstring), and every leaf must have
    moved. The running BN stats at atol 1e-3 (measured 7.6e-5)."""
    pm = step0["same_aug"][0]
    jax_state = step0["jax_state"]
    params, stats, _ = convert_reference_state_dict(pm.state_dict())
    lr0 = LR * 0.01
    got, want = flatten_dict(params), flatten_dict(jax.tree.map(np.asarray, jax_state.params))
    old = flatten_dict(jax.tree.map(np.asarray, step0["variables"]["params"]))
    assert set(got) == set(want)
    close = total = 0
    for k in want:
        close += int((np.abs(got[k] - want[k]) <= 0.25 * lr0).sum())
        total += want[k].size
        assert np.abs(got[k] - old[k]).max() > 0.5 * lr0, "/".join(k)  # the leaf moved
    assert close >= 0.99 * total, f"{total - close} of {total} elements differ"
    fs, fw = flatten_dict(stats), flatten_dict(jax.tree.map(np.asarray, jax_state.batch_stats))
    assert set(fs) == set(fw)
    for k in fw:
        np.testing.assert_allclose(fs[k], fw[k], rtol=1e-3, atol=1e-3, err_msg="/".join(k))


def test_step0_gradients_match(step0):
    """Gradients from the optimizers' first moments (m = 0.1 g after one
    step), as one vector over every leaf, by relative L2 distance: the
    port's fp32 against its float64 run, and JAX's against the port's on
    the same augmented input, each under 5e-2 (measured 1.7e-2 and 1.8e-2;
    a missing or wrong backward term moves it to order 1)."""

    def flat(grads, dtype):
        tree = convert_reference_state_dict({k: v.to(dtype) for k, v in grads.items()})[0]
        f = flatten_dict(tree)
        return np.concatenate([np.asarray(f[k], np.float64).ravel() for k in sorted(f)])

    def rel(a, b):
        return np.linalg.norm(a - b) / np.linalg.norm(b)

    g32 = flat(step0["port32"][2], torch.float32)
    g64 = flat(step0["port64"][2], torch.float64)
    same = flat(step0["same_aug"][2], torch.float32)
    mu = flatten_dict(jax.tree.map(lambda m: np.asarray(m) / 0.1, step0["jax_state"].opt_state[0].mu))
    gj = np.concatenate([np.asarray(mu[k], np.float64).ravel() for k in sorted(mu)])
    assert rel(g32, g64) < 5e-2
    assert rel(gj, same) < 5e-2
