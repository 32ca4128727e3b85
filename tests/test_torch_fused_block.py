"""The port's plain trunk units in training against the JAX package's fused
custom-VJP units (tdeed_tpu/kernels/fused_block.py), and the port built
from a config with the fused-block knobs against the JAX package with them
on, on the CPU.

In the JAX package ``fuse_entry`` and ``fuse_shift`` choose how XLA
schedules the same trunk function; the port computes that function with
its plain modules and reads neither knob (tdeed_tpu_torch/config.py).
These tests hold the two to the same numbers.

Sizes and weights are tests/test_fused_block.py's: stem 8, block 8, group
size 4, N 4 (8 for the shift units), 16x16, every parameter ramped by
+0.05 so the statistics' gradients matter. The same numpy inputs go
through both packages; JAX weights reach the port through
``params_from_jax``.

Tolerances:
  * a plain unit in training against JAX's fused unit, fp32: the forward,
    the running statistics (0.9 old + 0.1 of the batch statistics the
    fused unit returns) and the input's gradient at rtol 2e-5, atol 1e-5,
    each parameter's gradient within 5 x 2e-5 + 1e-6 of its leaf's largest
    entry, as tests/test_fused_block.py applies its tolerances (:71-72,
    :147-159);
  * the plain units' gradients in float64: ``torch.autograd.gradcheck``
    (fast mode) at its default tolerances, through the BatchNorm twins'
    hand-written backward (kernels/batchnorm.py);
  * the rny002 trunk, gsf and gsm, built from a config with both knobs
    against JAX's with both knobs: tests/test_fused_block.py:163-225's
    (output and running statistics rtol 2e-5 / atol 1e-5, each gradient
    leaf within 5 x 2e-5 + 1e-6 of its largest entry);
  * the train step (full rny002_gsf widths, clip 8, crop 32, mixup off,
    the JAX kernel's augmented frames on both sides, as
    tests/test_torch_train_step.py), the port built from a config with both
    knobs: the step-0 loss against JAX's with the knobs at rtol 1e-4.
Tiny CPU configs train in fp32 (oneDNN's bf16 weight gradient, ROADMAP.md).
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import tdeed_tpu.models.tdeed as jtdeed
from tdeed_tpu.kernels.fused_block import make_fused_conv_bn_relu
from tdeed_tpu.models import regnet as jregnet
from tdeed_tpu_torch.config import TDEEDConfig
from tdeed_tpu_torch.models import regnet
from tdeed_tpu_torch.models.tdeed import build_model
from tdeed_tpu_torch.train import step as port_step
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train.step import StepDraws, make_train_step
from tdeed_tpu_torch.utils.jax_convert import params_from_jax
from tests.test_fused_block import BLK_W, GROUP_SIZE, H, N, STEM_W, _setup
from tests.test_torch_train_step import (
    COS, CROP, LR, MODEL, T, WARM, _inputs, _jax_augmented, _jax_step,
)
from tests.torch_port_util import N_CLASSES, NC_BG, port_state, to_np

RTOL, ATOL = 2e-5, 1e-5
LEAF_TOL = 5 * RTOL + 1e-6  # tests/test_fused_block.py's per-leaf bound
UNITS = ("entry_stem", "entry", "shift", "conv1")
FUSED = dict(fuse_entry=True, fuse_shift=True)


def _nchw(x):
    return torch.from_numpy(np.array(x, np.float32)).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last)


def _ramp(tree):
    return jax.tree.map(
        lambda a: a + 0.05 * jnp.arange(a.size, dtype=a.dtype).reshape(a.shape) / a.size, tree)


def _load(module, params, stats, name):
    """Load a JAX subtree (TDEED's backbone entry ``name``) into ``module``."""
    prefix = "_features.stem." if name == "stem" else "_features.s1.b1."
    module.load_state_dict(port_state({"features": {name: params}},
                                      {"features": {name: stats}}, prefix), strict=True)


def _port_grads(module_grads, name, stats):
    """Port-layout gradients keyed like ``module.named_parameters()``."""
    return port_state({"features": {name: module_grads}}, {"features": {name: stats}},
                      "_features.stem." if name == "stem" else "_features.s1.b1.")


def _close_leaves(got, want, tol, what=""):
    """Each leaf within ``tol`` of its largest entry."""
    assert set(got) == set(want), set(got) ^ set(want)
    for k, w in want.items():
        g, w = np.asarray(to_np(got[k]) if torch.is_tensor(got[k]) else got[k], np.float64), \
            np.asarray(to_np(w) if torch.is_tensor(w) else w, np.float64)
        den = max(1e-3, float(np.abs(w).max()))
        err = float(np.abs(g - w).max()) / den
        assert err < tol, f"{what}{k}: rel err {err:.3e}"


# ---------------------------------------------------------------------------
# The plain units against JAX's fused units
# ---------------------------------------------------------------------------


def _jax_unit_case(kind):
    """(JAX loss(p, x) -> (sum(out * w), (out, stats)), its params, x, w,
    the port's plain modules with the same weights by JAX name, the port's
    forward of them, JAX batch_stats by module, the port's BatchNorm of
    each statistic the JAX unit returns) for one unit, fp32."""
    rng = np.random.default_rng(7)
    if kind in ("entry_stem", "entry"):
        with_stem = kind == "entry_stem"
        _, variables, params, fused, fused_p, x = _setup(None, with_stem)
        stats = variables["batch_stats"]
        block = regnet.YBlock(STEM_W, BLK_W, 2, GROUP_SIZE)
        _load(block, params["blk"], stats["blk"], "s1_b1")
        mods = {"blk": block}
        bns = {name: getattr(block, name).bn
               for name in ("conv1", "conv2", "conv3", "downsample")}
        port = block
        if with_stem:
            stem = regnet.ConvBN(3, STEM_W, 3, stride=2)
            _load(stem, params["stem"], stats["stem"], "stem")
            mods["stem"] = stem
            bns["stem"] = stem.bn
            port = torch.nn.Sequential(stem, block)
        hw = H // (4 if with_stem else 2)
        out_shape = (x.shape[0], hw, hw, BLK_W)
        w = jnp.asarray(rng.normal(size=out_shape), jnp.float32)

        def loss(p, x_):
            out, st = fused(x_, p)
            return jnp.sum(out * w), (out, st)

        return loss, fused_p, x, w, mods, port, {k: stats[k] for k in fused_p}, bns
    if kind == "conv1":
        x = jnp.asarray(np.random.default_rng(0).normal(size=(N, H, H, BLK_W)), jnp.float32)
        jm = jregnet.ConvBN(BLK_W, 1)
        v = jm.init(jax.random.PRNGKey(4), x, False)
        p = _ramp(v["params"])
        fn = make_fused_conv_bn_relu()
        w = jnp.asarray(rng.normal(size=(N, H, H, BLK_W)), jnp.float32)

        def loss(p_, x_):
            out, st = fn(x_, p_["stem"])
            return jnp.sum(out * w), (out, {"conv1": st})

        convbn = regnet.ConvBN(BLK_W, BLK_W, 1)
        _load(convbn, p, v["batch_stats"], "stem")
        return (loss, {"stem": p}, x, w, {"stem": convbn}, convbn,
                {"stem": v["batch_stats"]}, {"conv1": convbn.bn})
    raise ValueError(kind)


def _port_run(module, x, w, params):
    """out and gradients (by parameter name, and of x) of the port's
    ``module`` in training under the probe loss sum(out * w)."""
    xt = _nchw(x).requires_grad_(True)
    out = module.train()(xt)
    (out * _nchw(w)).sum().backward()
    grads = {n: p.grad for n, p in params}
    return out.detach(), grads, xt.grad


def _assert_running_stats(bns, old, jst):
    """Each BatchNorm's running statistics moved from ``old`` by the JAX
    unit's batch statistics: 0.9 old + 0.1 batch."""
    assert set(bns) == set(jst)
    for k, bn in bns.items():
        for i, name in enumerate(("running_mean", "running_var")):
            want = 0.9 * old[k][i] + 0.1 * np.asarray(jst[k][i], np.float64)
            np.testing.assert_allclose(to_np(getattr(bn, name)), want, rtol=RTOL, atol=ATOL,
                                       err_msg=f"{k} {name}")
        assert int(bn.num_batches_tracked) == 1, k


@pytest.mark.parametrize("kind", ["entry_stem", "entry", "conv1"])
def test_unit_matches_jax_unit(kind):
    """The plain stem + s1_b1, s2_b1 and a stride-1 block's conv1 ConvBN +
    ReLU in training against make_fused_block with and without the stem
    and make_fused_conv_bn_relu, fp32: the forward, the batch statistics,
    the gradient of every parameter and of the input."""
    loss, jp, x, w, mods, port, jstats, bns = _jax_unit_case(kind)
    (_, (jout, jst)), (jg, jgx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(jp, x)
    old = {k: (to_np(bn.running_mean).astype(np.float64),
               to_np(bn.running_var).astype(np.float64)) for k, bn in bns.items()}
    params = [(f"{name}.{n}", p) for name, m in mods.items() for n, p in m.named_parameters()]
    out, grads, gx = _port_run(port, x, w, params)
    np.testing.assert_allclose(to_np(out.permute(0, 2, 3, 1)), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    _assert_running_stats(bns, old, jst)
    want = {}
    for name in mods:
        tree = _port_grads(jg[name], "s1_b1" if name == "blk" else "stem", jstats[name])
        want.update({f"{name}.{k}": g for k, g in tree.items() if f"{name}.{k}" in grads})
    _close_leaves(grads, want, LEAF_TOL)
    np.testing.assert_allclose(to_np(gx.permute(0, 2, 3, 1)), np.asarray(jgx),
                               rtol=RTOL, atol=ATOL)


def test_shift_unit_matches_jax_shift_block():
    """A plain stride-2 GSF block in training against JAX's with fuse=True
    (make_fused_shift_block after its GatedShift), fp32: the output, every
    running statistic, every gradient."""
    clip_len, b = 4, 2
    n = b * clip_len
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.normal(size=(n, H, H, STEM_W)), jnp.float32)
    jm = jregnet.YBlock(width=BLK_W, in_width=STEM_W, stride=2, group_size=GROUP_SIZE,
                        shift="gsf", clip_len=clip_len, fuse=True)
    v = jm.init(jax.random.PRNGKey(2), x, False)
    params = _ramp(v["params"])
    w = jnp.asarray(rng.normal(size=(n, H // 2, H // 2, BLK_W)), jnp.float32)

    def loss(p, x_):
        out, upd = jm.apply({"params": p, "batch_stats": v["batch_stats"]}, x_, True,
                            mutable=["batch_stats"])
        return jnp.sum(out * w), (out, upd["batch_stats"])

    (_, (jout, jstats)), (jg, jgx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(params, x)
    pm = regnet.YBlock(STEM_W, BLK_W, 2, GROUP_SIZE, shift_mode="gsf", clip_len=clip_len)
    _load(pm, params, v["batch_stats"], "s1_b1")
    out, grads, gx = _port_run(pm, x, w, pm.named_parameters())
    np.testing.assert_allclose(to_np(out.permute(0, 2, 3, 1)), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    want = port_state({"features": {"s1_b1": params}}, {"features": {"s1_b1": jstats}},
                      "_features.s1.b1.")
    for k, t in pm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(to_np(t), to_np(want[k]), rtol=RTOL, atol=ATOL,
                                       err_msg=k)
    gwant = _port_grads(jg, "s1_b1", v["batch_stats"])
    _close_leaves(grads, {k: gwant[k] for k in grads}, LEAF_TOL)
    np.testing.assert_allclose(to_np(gx.permute(0, 2, 3, 1)), np.asarray(jgx),
                               rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The plain units' gradients in float64
# ---------------------------------------------------------------------------


def _ramp_port(module):
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.arange(p.numel(), dtype=p.dtype).reshape(p.shape) / p.numel())
    return module


def _plain_case(kind, dtype):
    """(the plain unit in training, its input x) from one seeded set of
    modules: stem + s1_b1, s2_b1, a stride-2 GSF block, a stride-1 GSF
    block (whose conv1 ConvBN + ReLU the JAX package fuses)."""
    torch.manual_seed(1)
    if kind == "entry_stem":
        unit = torch.nn.Sequential(regnet.ConvBN(3, STEM_W, 3, stride=2),
                                   regnet.YBlock(STEM_W, BLK_W, 2, GROUP_SIZE))
        x = torch.randn(N, 3, H, H)
    elif kind == "entry":
        unit = regnet.YBlock(STEM_W, BLK_W, 2, GROUP_SIZE)
        x = torch.randn(N, STEM_W, H, H)
    else:
        stride, cin = (2, STEM_W) if kind == "shift" else (1, BLK_W)
        unit = regnet.YBlock(cin, BLK_W, stride, GROUP_SIZE, shift_mode="gsf", clip_len=4)
        x = torch.randn(8, cin, H, H)
    unit = _ramp_port(unit).to(dtype).train()
    return unit, x.to(dtype).contiguous(memory_format=torch.channels_last)


@pytest.mark.parametrize("kind", UNITS)
def test_unit_gradients_are_the_plain_modules_in_float64(kind):
    """float64: the gradients of the plain unit in training, every
    parameter's and the input's, against finite differences
    (``torch.autograd.gradcheck``, fast mode): the BatchNorm twins'
    hand-written backward (the GSF gate's on its pitched view in the shift
    units) composes with autograd over the rest of the unit."""
    unit, x = _plain_case(kind, torch.float64)
    names = [n for n, _ in unit.named_parameters()]
    params = [p.detach().clone().requires_grad_(True) for _, p in unit.named_parameters()]

    def fn(x_, *ps):
        return torch.func.functional_call(unit, dict(zip(names, ps)), (x_,))

    assert torch.autograd.gradcheck(fn, (x.clone().requires_grad_(True), *params),
                                    fast_mode=True)


# ---------------------------------------------------------------------------
# The trunk against JAX's
# ---------------------------------------------------------------------------


def _with_gates(params, rng):
    """``params`` with every GSM gate (zero at init) drawn from N(0, 0.05)."""
    flat = flatten_dict(jax.tree.map(np.asarray, params))
    return unflatten_dict({k: (rng.normal(0, 0.05, v.shape).astype(np.float32)
                               if len(k) >= 2 and k[-2] == "gate_conv" else v)
                           for k, v in flat.items()})


@contextlib.contextmanager
def _jax_float64():
    """JAX in float64 within: jax_enable_x64 on, and the JAX package's
    float32 statistics and casts (``jnp.float32``) widened to float64."""
    jax.config.update("jax_enable_x64", True)
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jnp, "float32", jnp.float64)
            yield
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("shift_mode", ["gsf", "gsm"])
def test_trunk_with_both_knobs_matches_jax(shift_mode):
    """rny002 with GSF or GSM in s3/s4, train mode: the port's trunk built
    from a config with fuse_entry and fuse_shift (which the port does not
    read) against JAX's with both knobs: the pooled features, every
    updated running statistic (and each BN counted once) and every
    gradient, parameters and input, at tests/test_fused_block.py:163-225's
    tolerances.

    Both sides run in float64. In fp32 these tiny trunks are
    ill-conditioned in train mode (BN over a few values at s3/s4): at 32x32
    the port's fp32 features sat 5.5e-4 from its float64 ones and JAX's
    2.1e-3, and gradient leaves whose exact value is near 0 differed by
    0.28 of the bound's floor. In float64 the two trunks agree to 1.1e-9 on
    the features and 6e-8 relative on the gradients (the fp32 rounding of
    params_from_jax)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16, 16, 3))
    w = rng.normal(size=(4, 368))
    jm = jregnet.RegNetY(arch="rny002", shift_mode=shift_mode, clip_len=2, **FUSED)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x, jnp.float32), False)
    params = variables["params"]
    if shift_mode == "gsm":  # zero-initialised gates only regroup channels
        params = _with_gates(params, rng)
    stats = variables["batch_stats"]

    def wide(tree):
        return jax.tree.map(lambda a: jnp.asarray(np.asarray(a, np.float64)), tree)

    with _jax_float64():
        stats64 = wide(stats)

        def loss(p, x_):
            out, upd = jm.apply({"params": p, "batch_stats": stats64}, x_, True,
                                mutable=["batch_stats"])
            return jnp.sum(out * jnp.asarray(w)), (out, upd["batch_stats"])

        (_, (jout, jstats)), (jg, jgx) = jax.jit(
            jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(wide(params), jnp.asarray(x))
        jout, jstats, jg, jgx = jax.tree.map(np.asarray, (jout, jstats, jg, jgx))
    assert jout.dtype == np.float64
    cfg = TDEEDConfig(feature_arch=f"rny002_{shift_mode}", clip_len=2, dtype="float32",
                      **FUSED)
    pm = build_model(cfg, device="cpu")._features
    pm.load_state_dict(port_state({"features": params}, {"features": stats}, "_features."),
                       strict=True)
    pm = pm.double().train()
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).contiguous(
        memory_format=torch.channels_last).requires_grad_(True)
    out = pm(xt)
    (out * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), jout, rtol=RTOL, atol=ATOL)
    want = port_state({"features": params}, {"features": jstats}, "_features.")
    for k, t in pm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(t.numpy(), want[k].double().numpy(), rtol=RTOL,
                                       atol=ATOL, err_msg=k)
        elif k.endswith("num_batches_tracked"):
            assert int(t) == 1, k
    gwant = port_state({"features": jg}, {"features": stats}, "_features.")
    _close_leaves({k: p.grad for k, p in pm.named_parameters()},
                  {k: gwant[k] for k, _ in pm.named_parameters()}, LEAF_TOL)
    _close_leaves({"x": xt.grad.permute(0, 2, 3, 1).numpy()}, {"x": jgx}, LEAF_TOL)


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------


def test_train_step_with_both_knobs_matches_jax():
    """Step 0, mixup off, on the same augmented frames and draws: the port
    built from a config with fuse_entry and fuse_shift against JAX's step
    with both knobs, the loss at rtol 1e-4."""
    batch, draws = _inputs()
    batch = {k: v for k, v in batch.items() if k in ("frame", "label", "labelD")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtdeed, "TDEED", functools.partial(jtdeed.TDEED, **FUSED))
        variables, jax_loss, _ = _jax_step(mp, batch, draws, mixup=False)
    augmented = _jax_augmented(batch, draws, mixup=False)
    cfg = TDEEDConfig(num_classes=N_CLASSES, clip_len=T, feature_arch="rny002_gsf",
                      dtype="float32", **MODEL, **FUSED)
    pm = build_model(cfg, device="cpu")
    pm.load_state_dict(params_from_jax(variables["params"], variables["batch_stats"]),
                       strict=True)
    opt, sched = make_optimizer(pm.parameters(), LR, WARM, COS)
    step = make_train_step(pm, opt, sched, crop_dim=CROP, num_classes_bg=NC_BG, mixup=False,
                           radi_displacement=2)
    d = StepDraws(draws["crop"], torch.from_numpy(draws["lam"]),
                  torch.from_numpy(draws["aug"]),
                  {k: torch.from_numpy(v) for k, v in draws["keep"].items()})
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_step, "train_preprocess", lambda frames, params: augmented)
        loss = float(step({k: torch.from_numpy(v) for k, v in batch.items()}, [d])["loss"])
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-4)
