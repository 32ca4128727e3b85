"""Temporal stack, losses, schedule and decode of the PyTorch port against
their JAX counterparts, same inputs and weights (params_from_jax), fp32:
ops/temporal, models/sgp.{SGPBlock, SGPMixer, EDSGPMixer}, train/losses,
train/schedule, train/augment (mixup, crops, eval preprocessing),
ops/displacement.

Tolerance rtol 1e-4 / atol 1e-5 unless a test states another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdeed_tpu.models import sgp as jsgp
from tdeed_tpu.ops import displacement as jdisp
from tdeed_tpu.ops import temporal as jtemporal
from tdeed_tpu.train import augment as jaug
from tdeed_tpu.train import losses as jlosses
from tdeed_tpu.train import schedule as jschedule
from tdeed_tpu_torch.models import sgp
from tdeed_tpu_torch.ops import displacement, temporal
from tdeed_tpu_torch.train import augment, losses, schedule
from tests.torch_port_util import port_state, to_np

B, C = 2, 32
RTOL, ATOL = 1e-4, 1e-5


@pytest.mark.parametrize("t_in,t_out", [(8, 4), (7, 4), (5, 3), (9, 9)])
def test_adaptive_max_pool_matches_jax(rng, t_in, t_out):
    x = rng.standard_normal((B, t_in, C)).astype(np.float32)
    got = temporal.adaptive_max_pool1d(torch.from_numpy(x), t_out)
    np.testing.assert_array_equal(to_np(got), np.asarray(jtemporal.adaptive_max_pool1d(jnp.asarray(x), t_out)))


@pytest.mark.parametrize("t_in,t_out", [(4, 8), (3, 7), (1, 5), (5, 1)])
def test_linear_upsample_matches_jax(rng, t_in, t_out):
    x = rng.standard_normal((B, t_in, C)).astype(np.float32)
    got = temporal.linear_upsample(torch.from_numpy(x), t_out)
    want = jtemporal.linear_upsample(jnp.asarray(x), t_out)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_zero_shifts_match_jax(rng):
    x = rng.standard_normal((B, 6, 3, C)).astype(np.float32)
    t = torch.from_numpy(x)
    np.testing.assert_array_equal(to_np(temporal.lshift_zero(t, 1)), np.asarray(jtemporal.lshift_zero(x, 1)))
    np.testing.assert_array_equal(to_np(temporal.rshift_zero(t, 1)), np.asarray(jtemporal.rshift_zero(x, 1)))


def _load(pm, variables, prefix, tree_key):
    pm.load_state_dict(port_state({"temp_fine": tree_key(variables["params"])}, {}, prefix), strict=True)
    return pm


@pytest.mark.parametrize("ks,k", [(3, 2.0), (7, 4.0)])
def test_sgp_block_matches_jax(rng, ks, k):
    x = rng.standard_normal((B, 8, C)).astype(np.float32)
    jm = jsgp.SGPBlock(kernel_size=ks, k=k)
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    pm = _load(sgp.SGPBlock(C, ks, k), v, "_temp_fine._sgp.0.", lambda p: {"sgp_0": p})
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(jm.apply(v, jnp.asarray(x))), rtol=RTOL, atol=ATOL)


def test_sgp_mixer_matches_jax(rng):
    x = rng.standard_normal((B, 4, C)).astype(np.float32)  # decoder state
    z = rng.standard_normal((B, 7, C)).astype(np.float32)  # skip, odd length
    jm = jsgp.SGPMixer(t_size=7, kernel_size=3, k=2.0)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(z))
    pm = _load(sgp.SGPMixer(C, 7, 3, 2.0), v, "_temp_fine._sgpMixer.0.", lambda p: {"mixer_0": p})
    with torch.no_grad():
        got = pm(torch.from_numpy(x), torch.from_numpy(z))
    want = jm.apply(v, jnp.asarray(x), jnp.asarray(z))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("t,n_layers", [(8, 2), (7, 1)])
def test_ed_sgp_mixer_matches_jax(rng, t, n_layers):
    """The U-Net with level lengths ceil(T / 2**i), an odd T included."""
    x = rng.standard_normal((B, t, C)).astype(np.float32)
    jm = jsgp.EDSGPMixer(clip_len=t, num_layers=n_layers, kernel_size=3, k=2.0)
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))
    pm = _load(sgp.EDSGPMixer(C, t, n_layers, 3, 2.0), v, "_temp_fine.", lambda p: p)
    with torch.no_grad():
        got = pm(torch.from_numpy(x))
    np.testing.assert_allclose(to_np(got), np.asarray(jm.apply(v, jnp.asarray(x))), rtol=RTOL, atol=ATOL)


def test_losses_match_jax(rng):
    n, c = 24, 5
    logits = rng.standard_normal((n, c)).astype(np.float32) * 2
    labels = rng.integers(0, c, n).astype(np.int32)
    soft = rng.dirichlet(np.ones(c), n).astype(np.float32)
    w_j = jlosses.class_weights(c, 5.0)
    w_p = losses.class_weights(c, 5.0)
    np.testing.assert_array_equal(to_np(w_p), np.asarray(w_j))
    lt, st, lb = torch.from_numpy(logits), torch.from_numpy(soft), torch.from_numpy(labels)
    pairs = [
        (losses.weighted_ce_hard(lt, lb, w_p), jlosses.weighted_ce_hard(logits, labels, w_j)),
        (losses.weighted_ce_soft(lt, st, w_p), jlosses.weighted_ce_soft(logits, soft, w_j)),
        (losses.displacement_mse(lt[:, 0], lt[:, 1]), jlosses.displacement_mse(logits[:, 0], logits[:, 1])),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


def test_schedule_values_match_jax():
    """Warmup x cosine chained product, including the reference quirk of
    training past the cosine's end (the factor rises again). rtol 1e-5:
    the JAX schedule evaluates in fp32, the port in Python floats."""
    ours = schedule.chained_warmup_cosine(8e-4, 3, 10)
    ref = jschedule.chained_warmup_cosine(8e-4, 3, 10)
    steps = range(14)
    np.testing.assert_allclose([ours(s) for s in steps], [float(ref(s)) for s in steps], rtol=1e-5)
    assert ours(13) > ours(10)  # past the cosine's end: rising again


def test_optimizer_lr_follows_schedule():
    p = torch.nn.Parameter(torch.ones(3))
    opt, sched = schedule.make_optimizer([p], 8e-4, 3, 10)
    ref = schedule.chained_warmup_cosine(8e-4, 3, 10)
    assert opt.defaults["weight_decay"] == 0.01 and opt.defaults["betas"] == (0.9, 0.999)
    for s in range(6):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], ref(s), rtol=1e-12)
        p.grad = torch.ones(3)
        opt.step()
        sched.step()


@pytest.mark.parametrize("half", [False, True])
def test_decode_displacement_matches_jax(rng, half):
    """Scatter-max onto zeros with clamped targets; ``half`` puts offsets
    on .5 to pin round-half-to-even."""
    t, c = 10, 5
    probs = rng.dirichlet(np.ones(c), (B, t)).astype(np.float32)
    displ = rng.uniform(-3, 3, (B, t)).astype(np.float32)
    if half:
        displ = np.round(displ) + 0.5
    got = displacement.decode_displacement(torch.from_numpy(probs), torch.from_numpy(displ))
    want = jdisp.decode_displacement(jnp.asarray(probs), jnp.asarray(displ))
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_mixup_matches_jax(rng, monkeypatch):
    """Blend rounded once to bf16, soft labels and displacement targets,
    with the same weights on both sides."""
    f1 = rng.integers(0, 256, (B, 3, 6, 6, 3)).astype(np.uint8)
    f2 = rng.integers(0, 256, (B, 3, 6, 6, 3)).astype(np.uint8)
    l1, l2 = (rng.integers(0, 5, (B, 3)).astype(np.int32) for _ in range(2))
    d1, d2 = (rng.uniform(-2, 2, (B, 3)).astype(np.float32) for _ in range(2))
    lam = np.array([0.25, 0.625], np.float32)  # dyadic: the fp32 blend is exact
    t = torch.from_numpy
    mixed, soft, md = augment.mixup_batch(t(f1), t(l1), t(f2), t(l2), t(lam), 5, t(d1), t(d2))
    assert mixed.dtype == torch.bfloat16
    monkeypatch.setattr(jaug, "sample_mixup_lam", lambda key, b: jnp.asarray(lam))
    jmixed, jsoft, jmd = jaug.mixup_batch(f1, l1, f2, l2, jax.random.PRNGKey(0), 5, d1, d2)
    np.testing.assert_array_equal(to_np(mixed), np.asarray(jmixed, np.float32))
    np.testing.assert_allclose(to_np(soft), np.asarray(jsoft), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(to_np(md), np.asarray(jmd), rtol=RTOL, atol=ATOL)


def test_mixup_lam_is_beta(rng):
    lam = augment.sample_mixup_lam(np.random.default_rng(0), 20000)
    assert lam.dtype == np.float32 and np.all((lam >= 0) & (lam <= 1))
    # Beta(0.2, 0.2): mean 1/2, variance 0.2^2 / (0.4^2 * 1.4) = 0.1786
    assert abs(lam.mean() - 0.5) < 0.01 and abs(lam.var() - 0.1786) < 0.01


def test_crops_and_eval_preprocess_match_jax(rng):
    frames = rng.integers(0, 256, (B, 3, 11, 13, 3)).astype(np.uint8)
    t = torch.from_numpy(frames)
    for hflip in (False, True):
        got = augment.eval_preprocess(t, 8, hflip=hflip)
        want = jaug.eval_preprocess(jnp.asarray(frames), 8, hflip=hflip)
        np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)
    g = torch.Generator().manual_seed(0)
    offsets = {augment.sample_crop_offset(g, (11, 13), 8) for _ in range(300)}
    assert offsets == {(i, j) for i in range(4) for j in range(6)}  # every position
    crop = augment.random_crop_batch(t, 8, (2, 5))
    np.testing.assert_array_equal(crop.numpy(), frames[:, :, 2:10, 5:13])
    assert augment.random_crop_batch(t, None, None) is t


def test_adamw_schedule_trajectory_matches_optax():
    """make_optimizer against the JAX package's optax AdamW + chained
    schedule over 10 steps on a well-conditioned fixture (a tiny MLP, no
    BN), fed the same gradients: bias correction, decoupled weight decay
    on every parameter and the schedule's chaining all show at 1e-6."""
    rng = np.random.default_rng(5)
    w1 = rng.normal(size=(6, 16)).astype(np.float32) * 0.4
    w2 = rng.normal(size=(16, 3)).astype(np.float32) * 0.4
    xs = rng.normal(size=(10, 32, 6)).astype(np.float32)
    ys = rng.integers(0, 3, (10, 32))

    def loss_fn(p, x, y):
        logp = jax.nn.log_softmax(jnp.tanh(x @ p["w1"]) @ p["w2"], axis=-1)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=-1))

    grad_fn = jax.jit(jax.grad(loss_fn))
    tx = jschedule.make_optimizer(1e-2, warmup_steps=3, cosine_steps=7)
    jp = {"w1": jnp.asarray(w1), "w2": jnp.asarray(w2)}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in (("w1", w1), ("w2", w2))}
    opt, sched = schedule.make_optimizer(list(tp.values()), 1e-2, 3, 7)
    for s in range(10):
        g = grad_fn(jp, jnp.asarray(xs[s]), jnp.asarray(ys[s]))
        for k, p in tp.items():
            p.grad = torch.from_numpy(np.array(g[k]))
        opt.step()
        sched.step()
        updates, state = tx.update(g, state, jp)
        jp = jax.tree.map(lambda a, u: a + u, jp, updates)
        for k, p in tp.items():
            np.testing.assert_allclose(to_np(p), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=f"{k} step {s}")
