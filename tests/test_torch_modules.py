"""Backbone modules of the PyTorch port against their JAX counterparts with
the same weights (through params_from_jax) and inputs, in fp32:
kernels/gated_shift.gsf_core, models/shift.{GSF, GatedShift},
models/regnet.{YBlock, RegNetY}, models/common.SplitBatchNorm.

Tolerance rtol 1e-4 / atol 1e-5 unless a test states another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tdeed_tpu.kernels.gated_shift import gsf_core as jax_gsf_core
from tdeed_tpu.models import regnet as jregnet
from tdeed_tpu.models import shift as jshift
from tdeed_tpu.utils.torch_convert import conv2d_kernel, conv3d_kernel
from tdeed_tpu_torch.kernels.gated_shift import gsf_core
from tdeed_tpu_torch.models import regnet, shift
from tests.torch_port_util import port_state, to_np

B, T = 2, 4
RTOL, ATOL = 1e-4, 1e-5


def _nchw(x):  # (N, H, W, C) numpy -> channels_last (N, C, H, W) tensor
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return to_np(t.permute(0, 2, 3, 1))


def _jax_train(module, variables, *args):
    out, upd = jax.jit(
        lambda v, *a: module.apply(v, *a, True, mutable=["batch_stats"])
    )(variables, *args)
    return np.asarray(out), upd["batch_stats"]


def test_gsf_core_matches_jax(rng):
    c = 16
    x = rng.standard_normal((B, T, 5, 6, c)).astype(np.float32)
    xn = np.maximum(rng.standard_normal(x.shape), 0).astype(np.float32)
    gw = rng.normal(0, 0.2, (2, c // 2, 3, 3, 3)).astype(np.float32)
    gb = rng.normal(0, 0.2, (2,)).astype(np.float32)
    cw = [rng.normal(0, 0.3, (1, 2, 3, 3)).astype(np.float32) for _ in range(2)]
    cb = [rng.normal(0, 0.3, (1,)).astype(np.float32) for _ in range(2)]
    want = jax_gsf_core(
        jnp.asarray(x), jnp.asarray(xn), conv3d_kernel(gw), gb,
        conv2d_kernel(cw[0]), cb[0], conv2d_kernel(cw[1]), cb[1],
    )
    t = torch.from_numpy
    got = gsf_core(t(x), t(xn), t(gw), t(gb), t(cw[0]), t(cb[0]), t(cw[1]), t(cb[1]))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("train", [False, True])
def test_gated_shift_matches_jax(rng, train):
    """Bare GatedShift (net=Identity): GSF on the first fold channels, the
    rest passed through; train mode also updates the GSF BN stats."""
    c = 40  # fold_dim_for(40) = 12: a ragged fold
    assert shift.fold_dim_for(c) == jshift.fold_dim_for(c) == 12
    x = rng.standard_normal((B * T, 5, 6, c)).astype(np.float32)
    jm = jshift.GatedShift(clip_len=T, mode="gsf", dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), False)
    pm = shift.GatedShift(c, T, net=torch.nn.Identity(), mode="gsf")
    tree = {"features": {"s1_b1": {"gs": v["params"]}}}
    stats = {"features": {"s1_b1": {"gs": v["batch_stats"]}}}
    pm.load_state_dict(
        port_state(tree, stats, "_features.s1.b1.conv1."), strict=True
    )
    pm.train(train)
    with torch.no_grad():
        got = _nhwc(pm(_nchw(x).contiguous(memory_format=torch.channels_last)))
    np.testing.assert_array_equal(got[..., 12:], x[..., 12:])
    if train:
        want, new_stats = _jax_train(jm, v, jnp.asarray(x))
        bn = new_stats["gs"]["bn"]
        np.testing.assert_allclose(to_np(pm.gs.bn.running_mean), bn["mean"], rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(to_np(pm.gs.bn.running_var), bn["var"], rtol=RTOL, atol=ATOL)
    else:
        want = np.asarray(jm.apply(v, jnp.asarray(x), False))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shifted", [False, True])
def test_yblock_train_forward_and_stats_match_jax(rng, shifted):
    """Stride-2 block with downsample; with ``shifted`` conv1 is wrapped by
    the GSF GatedShift (the s3/s4 form). Train mode: batch statistics
    normalize and update the running stats."""
    in_w, w = 32, 56
    x = rng.standard_normal((B * T, 8, 8, in_w)).astype(np.float32)
    jm = jregnet.YBlock(
        width=w, in_width=in_w, stride=2, group_size=8,
        shift="gsf" if shifted else None, clip_len=T, dtype=jnp.float32,
    )
    v = jm.init(jax.random.PRNGKey(2), jnp.asarray(x), False)
    want, new_stats = _jax_train(jm, v, jnp.asarray(x))
    pm = regnet.YBlock(in_w, w, 2, 8, shift_mode="gsf" if shifted else None, clip_len=T)
    pm.load_state_dict(
        port_state({"features": {"s1_b1": v["params"]}},
                   {"features": {"s1_b1": v["batch_stats"]}}, "_features.s1.b1."),
        strict=True,
    )
    pm.train()
    with torch.no_grad():
        got = _nhwc(pm(_nchw(x).contiguous(memory_format=torch.channels_last)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    sd = port_state({"features": {"s1_b1": v["params"]}},
                    {"features": {"s1_b1": new_stats}}, "_features.s1.b1.")
    for k, t in pm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(to_np(t), to_np(sd[k]), rtol=RTOL, atol=ATOL, err_msg=k)


def test_trunk_eval_forward_matches_jax(rng):
    """The full rny002 trunk with GSF in s3/s4 (13 blocks, widths 24..368),
    eval mode, on 32x32 frames."""
    x = rng.standard_normal((B * T, 32, 32, 3)).astype(np.float32)
    jm = jregnet.RegNetY(arch="rny002", shift_mode="gsf", clip_len=T, dtype=jnp.float32)
    v = jax.jit(jm.init, static_argnums=2)(jax.random.PRNGKey(3), jnp.asarray(x), False)
    # non-default running stats so the eval path reads every leaf
    stats = jax.tree.map(
        lambda a: a + np.abs(rng.normal(0, 0.1, a.shape)).astype(np.float32),
        v["batch_stats"],
    )
    want = jax.jit(lambda p, s, x_: jm.apply({"params": p, "batch_stats": s}, x_, False))(
        v["params"], stats, jnp.asarray(x)
    )
    pm = regnet.RegNetY("rny002", clip_len=T, shift_mode="gsf")
    assert pm.feat_dim == 368
    pm.load_state_dict(
        port_state({"features": v["params"]}, {"features": stats}, "_features."),
        strict=True,
    )
    pm.eval()
    with torch.no_grad():
        got = pm(_nchw(x).contiguous(memory_format=torch.channels_last))
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=RTOL, atol=ATOL)


def test_generate_stages_matches_jax():
    p = jregnet.ARCH_PARAMS["rny002"]
    args = (p["w0"], p["wa"], p["wm"], p["depth"], p["group_size"])
    assert regnet.generate_stages(*args) == jregnet.generate_stages(*args)
    assert regnet.generate_stages(*args) == ([24, 56, 152, 368], [1, 1, 4, 7], [8, 8, 8, 8])


def test_split_batchnorm_keeps_biased_running_var(rng):
    """Flax convention: momentum 0.9 on the old value and the biased batch
    variance, unlike nn.BatchNorm2d's unbiased one."""
    from tdeed_tpu_torch.models.common import SplitBatchNorm

    x = torch.from_numpy(rng.standard_normal((4, 3, 5, 5)).astype(np.float32))
    bn = SplitBatchNorm(3).train()
    bn(x)
    xd = x.double()
    mean = xd.mean((0, 2, 3))
    var = xd.var((0, 2, 3), unbiased=False)
    np.testing.assert_allclose(to_np(bn.running_mean), 0.1 * mean.numpy(), rtol=1e-5)
    np.testing.assert_allclose(to_np(bn.running_var), 0.9 + 0.1 * var.numpy(), rtol=1e-5)
    assert int(bn.num_batches_tracked) == 1


def test_split_batchnorm_gradient_matches_autograd(rng):
    """The training BatchNorm Function's CPU twin (batch_norm_train), with
    and without its ReLU, has the gradient of finite differences (float64
    gradcheck) in the input, the scale and the bias; SplitBatchNorm
    computes a bf16 input's statistics in fp32."""
    from tdeed_tpu_torch.kernels.batchnorm import batch_norm_train
    from tdeed_tpu_torch.models.common import SplitBatchNorm

    x = torch.from_numpy(rng.standard_normal((3, 2, 4, 5))).requires_grad_()
    weight = torch.from_numpy(rng.uniform(0.5, 1.5, 2)).requires_grad_()
    bias = torch.from_numpy(rng.standard_normal(2)).requires_grad_()
    for relu in (False, True):
        assert torch.autograd.gradcheck(
            lambda x_, w_, b_: batch_norm_train(x_, w_, b_, 1e-5, relu)[0], (x, weight, bias))
    xb = torch.from_numpy(rng.standard_normal((2, 4, 3, 3)).astype(np.float32)).to(torch.bfloat16)
    bn = SplitBatchNorm(4).train()
    out = bn(xb.requires_grad_())
    assert out.dtype == torch.bfloat16
    out.float().sum().backward()
    assert xb.grad.dtype == torch.bfloat16
