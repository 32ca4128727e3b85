"""The port's fused trunk units (tdeed_tpu_torch/kernels/fused_block.py)
against the JAX package's (tdeed_tpu/kernels/fused_block.py) and against
the port's own plain modules, on the CPU.

Sizes and weights are tests/test_fused_block.py's: stem 8, block 8, group
size 4, N 4 (8 for the shift units), 16x16, every parameter ramped by
+0.05 so the statistics' gradients matter. The same numpy inputs go
through both packages; JAX weights reach the port through
``params_from_jax``.

Tolerances:
  * a unit against JAX's, fp32: the forward, the statistics and the
    input's gradient at rtol 2e-5, atol 1e-5, each parameter's gradient
    within 5 x 2e-5 + 1e-6 of its leaf's largest entry, as
    tests/test_fused_block.py applies its tolerances (:71-72, :147-159);
  * a unit against the port's plain modules: the forward and the
    statistics bit for bit (the same op sequence), the gradients in
    float64 within 1e-10 of the largest entry of each leaf, which holds
    the hand-derived backward free of fp32 noise;
  * the rny002 trunk, gsf and gsm, both knobs on, against JAX's with the
    same flags: tests/test_fused_block.py:163-225's (output and running
    statistics rtol 2e-5 / atol 1e-5, each gradient leaf within
    5 x 2e-5 + 1e-6 of its largest entry);
  * the train step (full rny002_gsf widths, clip 8, crop 32, mixup off,
    the JAX kernel's augmented frames on both sides, as
    tests/test_torch_train_step.py): the step-0 loss against JAX's with
    the knobs at rtol 1e-4; the port with the knobs against without over 2
    AdamW steps at tests/test_fused_block.py:361-420's tolerances.
Tiny CPU configs train in fp32 (oneDNN's bf16 weight gradient, ROADMAP.md);
bf16 is held on the card by chip_smoke.py phase 12a.
"""

import contextlib
import copy
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
from tdeed_tpu_torch.kernels import fused_block
from tdeed_tpu_torch.models import regnet
from tdeed_tpu_torch.models.common import SplitBatchNorm
from tdeed_tpu_torch.models.tdeed import TDEED
from tdeed_tpu_torch.train import step as port_step
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train.step import StepDraws, make_predict_step, make_train_step
from tdeed_tpu_torch.utils.jax_convert import params_from_jax
from tests.test_fused_block import BLK_W, GROUP_SIZE, H, N, STEM_W, _setup
from tests.test_torch_train_step import (
    COS, CROP, LR, MODEL, T, WARM, _inputs, _jax_augmented, _jax_step,
)
from tests.torch_port_util import N_CLASSES, NC_BG, port_state, to_np

RTOL, ATOL = 2e-5, 1e-5
LEAF_TOL = 5 * RTOL + 1e-6  # tests/test_fused_block.py's per-leaf bound
UNITS = ("entry_stem", "entry", "shift", "conv1")


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
        den = max(1e-3 if tol > 1e-8 else 1e-30, float(np.abs(w).max()))
        err = float(np.abs(g - w).max()) / den
        assert err < tol, f"{what}{k}: rel err {err:.3e}"


# ---------------------------------------------------------------------------
# The units against JAX's
# ---------------------------------------------------------------------------


def _jax_unit_case(kind):
    """(JAX loss(p, x) -> (sum(out * w), (out, stats)), its params, x, the
    port's modules with the same weights, the port's unit call, JAX
    batch_stats by module) for one unit, fp32."""
    rng = np.random.default_rng(7)
    if kind in ("entry_stem", "entry"):
        with_stem = kind == "entry_stem"
        _, variables, params, fused, fused_p, x = _setup(None, with_stem)
        stats = variables["batch_stats"]
        block = regnet.YBlock(STEM_W, BLK_W, 2, GROUP_SIZE)
        _load(block, params["blk"], stats["blk"], "s1_b1")
        mods = {"blk": block}
        stem = None
        if with_stem:
            stem = regnet.ConvBN(3, STEM_W, 3, stride=2)
            _load(stem, params["stem"], stats["stem"], "stem")
            mods["stem"] = stem
        hw = H // (4 if with_stem else 2)
        out_shape = (x.shape[0], hw, hw, BLK_W)
        w = jnp.asarray(rng.normal(size=out_shape), jnp.float32)

        def loss(p, x_):
            out, st = fused(x_, p)
            return jnp.sum(out * w), (out, st)

        port = lambda x_: fused_block.fused_block(x_, block, stem)  # noqa: E731
        return loss, fused_p, x, w, mods, port, {k: stats[k] for k in fused_p}
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

        def port(x_):
            y, st = fused_block.fused_conv_bn_relu(x_, convbn)
            return y, {"conv1": st}

        return loss, {"stem": p}, x, w, {"stem": convbn}, port, {"stem": v["batch_stats"]}
    raise ValueError(kind)


def _port_run(fn, x, w, params):
    """out, stats and gradients (by parameter name, and of x) of the port's
    ``fn`` under the probe loss sum(out * w)."""
    xt = _nchw(x).requires_grad_(True)
    out, stats = fn(xt)
    (out * _nchw(w)).sum().backward()
    grads = {n: p.grad for n, p in params}
    return out.detach(), stats, grads, xt.grad


@pytest.mark.parametrize("kind", ["entry_stem", "entry", "conv1"])
def test_unit_matches_jax_unit(kind):
    """FusedBlock with and without the stem and FusedConvBNReLU against
    make_fused_block and make_fused_conv_bn_relu, fp32: the forward, the
    batch statistics, the gradient of every parameter and of the input."""
    loss, jp, x, w, mods, port, jstats = _jax_unit_case(kind)
    (_, (jout, jst)), (jg, jgx) = jax.jit(
        jax.value_and_grad(loss, argnums=(0, 1), has_aux=True))(jp, x)
    params = [(f"{name}.{n}", p) for name, m in mods.items() for n, p in m.named_parameters()]
    out, stats, grads, gx = _port_run(port, x, w, params)
    np.testing.assert_allclose(to_np(out.permute(0, 2, 3, 1)), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    assert set(stats) == set(jst)
    for k, (m, v) in stats.items():
        np.testing.assert_allclose(to_np(m), np.asarray(jst[k][0]), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(to_np(v), np.asarray(jst[k][1]), rtol=RTOL, atol=ATOL)
    want = {}
    for name in mods:
        tree = _port_grads(jg[name], "s1_b1" if name == "blk" else "stem", jstats[name])
        want.update({f"{name}.{k}": g for k, g in tree.items() if f"{name}.{k}" in grads})
    _close_leaves(grads, want, LEAF_TOL)
    np.testing.assert_allclose(to_np(gx.permute(0, 2, 3, 1)), np.asarray(jgx),
                               rtol=RTOL, atol=ATOL)


def test_shift_unit_matches_jax_shift_block():
    """A stride-2 GSF block with fuse=True on both sides (FusedShiftBlock
    after the port's GatedShift, make_fused_shift_block after JAX's),
    fp32: the output, every running statistic, every gradient."""
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
    pm = regnet.YBlock(STEM_W, BLK_W, 2, GROUP_SIZE, shift_mode="gsf", clip_len=clip_len,
                       fuse=True)
    _load(pm, params, v["batch_stats"], "s1_b1")
    pm.train()
    out, _, grads, gx = _port_run(lambda x_: (pm(x_), None), x, w, pm.named_parameters())
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
# The units against the port's plain modules
# ---------------------------------------------------------------------------


def _ramp_port(module):
    with torch.no_grad():
        for p in module.parameters():
            p.add_(0.05 * torch.arange(p.numel(), dtype=p.dtype).reshape(p.shape) / p.numel())
    return module


def _plain_case(kind, dtype):
    """(plain forward, fused forward, the modules, x, shape of out) over
    copies of one seeded set of modules: the fused forward writes the
    running statistics as the module path does."""
    torch.manual_seed(1)
    if kind == "entry_stem":
        stem = _ramp_port(regnet.ConvBN(3, STEM_W, 3, stride=2))
        block = _ramp_port(regnet.YBlock(STEM_W, BLK_W, 2, GROUP_SIZE))
        mods = torch.nn.ModuleDict({"stem": stem, "blk": block})
        plain = lambda m, x: m["blk"](m["stem"](x))  # noqa: E731
        fused = lambda m, x: regnet._fused_entry(m["stem"], m["blk"], x)  # noqa: E731
        x = torch.randn(N, 3, H, H)
    elif kind == "entry":
        mods = torch.nn.ModuleDict({"blk": _ramp_port(regnet.YBlock(STEM_W, BLK_W, 2,
                                                                    GROUP_SIZE))})
        plain = lambda m, x: m["blk"](x)  # noqa: E731
        fused = lambda m, x: regnet._fused_entry(None, m["blk"], x)  # noqa: E731
        x = torch.randn(N, STEM_W, H, H)
    else:
        stride, cin = (2, STEM_W) if kind == "shift" else (1, BLK_W)
        block = _ramp_port(regnet.YBlock(cin, BLK_W, stride, GROUP_SIZE, shift_mode="gsf",
                                         clip_len=4))
        mods = torch.nn.ModuleDict({"blk": block})

        def plain(m, x):
            m["blk"].fuse = False
            return m["blk"](x)

        def fused(m, x):
            m["blk"].fuse = True
            return m["blk"](x)

        x = torch.randn(8, cin, H, H)
    mods = mods.to(dtype).train()
    return plain, fused, mods, x.to(dtype).contiguous(memory_format=torch.channels_last)


def _run_modules(fn, mods, x, w):
    mods = copy.deepcopy(mods)
    xt = x.clone().requires_grad_(True)
    out = fn(mods, xt)
    if w is None:
        w = torch.randn(out.shape, generator=torch.Generator().manual_seed(2)).to(out.dtype)
    (out * w).sum().backward()
    grads = {n: p.grad for n, p in mods.named_parameters()}
    grads["input"] = xt.grad
    return out.detach(), mods.state_dict(), grads, w


@pytest.mark.parametrize("kind", UNITS)
def test_unit_forward_is_the_plain_modules_bit_for_bit(kind):
    """fp32: the fused forward gives the plain modules' output and running
    statistics bit for bit; the gradients within fp32 reassociation."""
    plain, fused, mods, x = _plain_case(kind, torch.float32)
    po, ps, pg, w = _run_modules(plain, mods, x, None)
    fo, fs, fg, _ = _run_modules(fused, mods, x, w)
    assert torch.equal(fo, po)
    assert set(fs) == set(ps)
    for k in ps:
        assert torch.equal(fs[k], ps[k]), k
    _close_leaves(fg, pg, LEAF_TOL)


@pytest.mark.parametrize("kind", UNITS)
def test_unit_gradients_are_the_plain_modules_in_float64(kind):
    """float64: every gradient (each parameter's and the input's) within
    1e-10 of the leaf's largest entry of autograd's over the plain
    modules, which holds the hand-derived backward's algebra."""
    plain, fused, mods, x = _plain_case(kind, torch.float64)
    po, _, pg, w = _run_modules(plain, mods, x, None)
    fo, _, fg, _ = _run_modules(fused, mods, x, w)
    assert torch.equal(fo, po)
    _close_leaves(fg, pg, 1e-10)


def test_fused_units_keep_fewer_tensors():
    """What a unit keeps for the backward: the entry unit with the stem
    keeps less than autograd over the plain modules (not the post-ReLU
    stem output, not conv1's post-ReLU output, not the tail's)."""
    _, fused, mods, x = _plain_case("entry_stem", torch.float32)
    plain_fn = lambda m, x_: m["blk"](m["stem"](x_))  # noqa: E731

    def saved_numel(fn):
        kept = []

        def pack(t):
            kept.append(t)
            return t

        m = copy.deepcopy(mods)
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            fn(m, x.clone().requires_grad_(True))
        seen = {}
        for t in kept:
            seen[(t.untyped_storage().data_ptr(), t.dtype)] = t.untyped_storage().nbytes()
        return sum(seen.values())

    assert saved_numel(fused) < 0.75 * saved_numel(plain_fn)


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
    """rny002 with GSF or GSM in s3/s4, fuse_entry and fuse_shift on both
    sides, train mode: the pooled features, every updated running
    statistic (and each BN counted once) and every gradient, parameters
    and input, at tests/test_fused_block.py:163-225's tolerances.

    Both sides run in float64. In fp32 these tiny trunks are
    ill-conditioned in train mode (BN over a few values at s3/s4), the
    knobs off as much as on: at 32x32 the port's fp32 features sit 5.5e-4
    from its float64 ones and JAX's 2.1e-3, and gradient leaves whose
    exact value is near 0 differ by 0.28 of the bound's floor. In float64
    the two trunks agree to 1.1e-9 on the features and 6e-8 relative on
    the gradients (the fp32 rounding of params_from_jax)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 16, 16, 3))
    w = rng.normal(size=(4, 368))
    jm = jregnet.RegNetY(arch="rny002", shift_mode=shift_mode, clip_len=2, fuse_entry=True,
                         fuse_shift=True)
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
    pm = regnet.RegNetY("rny002", clip_len=2, shift_mode=shift_mode, fuse_entry=True,
                        fuse_shift=True)
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

FUSED = dict(fuse_entry=True, fuse_shift=True)


def _port_model(variables, dtype=torch.float32, **kw):
    pm = TDEED(N_CLASSES, T, dtype=dtype, shift_mode="gsf", **MODEL, **kw)
    pm.load_state_dict(params_from_jax(variables["params"], variables["batch_stats"]),
                       strict=True)
    return pm


def _port_steps(variables, batch, draws, augmented, n_steps=1, acc_grad_iter=1, **kw):
    """``n_steps`` port train steps (mixup off, the given augmented frames
    for each micro-batch, the same draws each step) from the JAX weights.
    Returns (model, losses, first-step gradients from Adam's first moments)."""
    pm = _port_model(variables, **kw)
    opt, sched = make_optimizer(pm.parameters(), LR, WARM, COS)
    step = make_train_step(pm, opt, sched, crop_dim=CROP, num_classes_bg=NC_BG, mixup=False,
                           radi_displacement=2, acc_grad_iter=acc_grad_iter)
    d = StepDraws(draws["crop"], torch.from_numpy(draws["lam"]),
                  torch.from_numpy(draws["aug"]),
                  {k: torch.from_numpy(v) for k, v in draws["keep"].items()})
    losses, grads = [], None
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    for _ in range(n_steps):
        with pytest.MonkeyPatch.context() as mp:
            outs = iter(augmented * acc_grad_iter)
            mp.setattr(port_step, "train_preprocess",
                       lambda frames, params: next(outs))
            losses.append(float(step(tb, [d] * acc_grad_iter)["loss"]))
        if grads is None:
            grads = {n: opt.state[p]["exp_avg"] / 0.1 for n, p in pm.named_parameters()}
    return pm, losses, grads


@pytest.fixture(scope="module")
def step_fused():
    """JAX's step 0 with both knobs on, and the port's with and without
    them over 2 steps, all on the JAX kernel's augmented frames."""
    batch, draws = _inputs()
    batch = {k: v for k, v in batch.items() if k in ("frame", "label", "labelD")}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtdeed, "TDEED", functools.partial(jtdeed.TDEED, **FUSED))
        variables, jax_loss, _ = _jax_step(mp, batch, draws, mixup=False)
    augmented = [_jax_augmented(batch, draws, mixup=False)]
    return dict(
        variables=variables, batch=batch, draws=draws, augmented=augmented, jax_loss=jax_loss,
        fused=_port_steps(variables, batch, draws, augmented, 2, **FUSED),
        plain=_port_steps(variables, batch, draws, augmented, 2),
    )


def test_train_step_with_both_knobs_matches_jax(step_fused):
    """Step 0 with fuse_entry and fuse_shift on both sides, mixup off, on
    the same augmented frames and draws: the loss at rtol 1e-4."""
    loss = step_fused["fused"][1][0]
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, step_fused["jax_loss"], rtol=1e-4)


def test_train_step_knobs_on_against_off(step_fused):
    """Two AdamW steps with the knobs on and off from the same weights:
    step 0's loss at rtol 1e-5, step 1's at 1e-2, the weights at atol
    5e-3 / rtol 5e-2, the running statistics at atol 1e-3 / rtol 2e-2."""
    fm, fl, _ = step_fused["fused"]
    pm, pl, _ = step_fused["plain"]
    np.testing.assert_allclose(fl[0], pl[0], rtol=1e-5)
    np.testing.assert_allclose(fl[1], pl[1], rtol=1e-2)
    ps = pm.state_dict()
    for k, t in fm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(to_np(t), to_np(ps[k]), atol=1e-3, rtol=2e-2, err_msg=k)
        elif t.is_floating_point():
            np.testing.assert_allclose(to_np(t), to_np(ps[k]), atol=5e-3, rtol=5e-2, err_msg=k)
        else:
            assert torch.equal(t, ps[k]), k


def test_checkpoint_backbone_composes_with_the_knobs(step_fused):
    """checkpoint_backbone with both knobs: the step-0 loss and gradients
    of the knobs alone (the recompute runs the same ops), and every BN's
    num_batches_tracked advanced by exactly 1 (the recompute writes no
    statistics)."""
    s = step_fused
    _, fl, fg = s["fused"]
    cm, cl, cg = _port_steps(s["variables"], s["batch"], s["draws"], s["augmented"],
                             checkpoint_backbone=True, **FUSED)
    assert cm._features.checkpoint_blocks
    np.testing.assert_allclose(cl[0], fl[0], rtol=1e-6)
    _close_leaves(cg, fg, 1e-5)
    bns = [m for m in cm.modules() if isinstance(m, SplitBatchNorm)]
    assert bns and all(int(m.num_batches_tracked) == 1 for m in bns)


def test_acc_grad_iter_2_records_statistics_once_per_micro_batch(step_fused):
    """acc_grad_iter=2 with both knobs: each BN counts 2 batches, and the
    running statistics are the plain model's bit for bit (the fused
    forward is the plain one's, and weights do not move between the
    micro-batches)."""
    s = step_fused
    batch = {k: np.concatenate([v, v]) for k, v in s["batch"].items()}
    fm, fl, _ = _port_steps(s["variables"], batch, s["draws"], s["augmented"],
                            acc_grad_iter=2, **FUSED)
    pm, pl, _ = _port_steps(s["variables"], batch, s["draws"], s["augmented"], acc_grad_iter=2)
    assert np.isfinite(fl[0])
    ps = pm.state_dict()
    for k, t in fm.state_dict().items():
        if k.endswith("num_batches_tracked"):
            assert int(t) == 2, k
        elif "running" in k:
            assert torch.equal(t, ps[k]), k


def test_eval_and_predict_with_the_knobs_are_the_plain_models(step_fused):
    """Eval mode takes the plain path: the forward and the predict step
    of a model with both knobs give the plain model's bits."""
    s = step_fused
    fused, plain = _port_model(s["variables"], **FUSED), _port_model(s["variables"])
    frames = torch.from_numpy(np.random.default_rng(4).normal(
        size=(2, T, CROP, CROP, 3)).astype(np.float32))
    with torch.no_grad():
        a, b = fused.eval()(frames), plain.eval()(frames)
    for k in b:
        assert torch.equal(a[k], b[k]), k
    clip = torch.from_numpy(s["batch"]["frame"][:, :, :CROP, :CROP])
    outs = [make_predict_step(m, crop_dim=None, radi_displacement=2)(clip)
            for m in (fused, plain)]
    for x, y in zip(*outs):
        assert torch.equal(x, y)
