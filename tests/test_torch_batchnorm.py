"""The training BatchNorm Function (tdeed_tpu_torch/kernels/batchnorm.py)
on the CPU, where it runs the four kernels' plain twins.

The twins are held in float64 against the eager chain SplitBatchNorm ran
before the kernels: the moments by stock ops + ``bn_fold`` + ``x * a + b``
(+ ReLU), differentiated by autograd, with the running statistics written
by ``update_running``. The forward takes the same operations, so it agrees to the
last bit; the backward adds the two sums and applies the coefficient
formula where autograd took the chain's own steps, so the two agree to
float64 rounding (1e-10 of each quantity's largest entry). The launch plan
the kernels take on the card is a pure function checked here too; the
kernels themselves are checked against these twins on the card
(tests/test_torch_kernel_gpu.py).
"""

import numpy as np
import pytest
import torch

from tdeed_tpu_torch.kernels import batchnorm
from tdeed_tpu_torch.kernels.batchnorm import BNPlan, batch_norm_train, bn_plan
from tdeed_tpu_torch.models import common, regnet
from tdeed_tpu_torch.models.common import SplitBatchNorm, bn_fold

EPS = 1e-5
TOL = 1e-10
# the trunk's BatchNorm widths: rny002's stages and stem, and the GSF folds
CHANNELS = (16, 24, 32, 40, 56, 92, 152, 368)


def _close(got, want, what):
    got, want = got.detach().double(), want.detach().double()
    scale = max(float(want.abs().max()), 1.0)
    err = float((got - want).abs().max())
    assert err <= TOL * scale, (what, err, scale)


def _input(layout, c, gen):
    """(x, shape): channels_last NCHW, or the GSF gate's (B, C, T, H, W)
    view of a (B, T, H, W, C) tensor; both keep channels innermost."""
    if layout == "nchw":
        x = torch.randn(3, c, 3, 4, generator=gen, dtype=torch.float64)
        return x.contiguous(memory_format=torch.channels_last)
    return torch.randn(2, 3, 2, 3, c, generator=gen, dtype=torch.float64).permute(0, 4, 1, 2, 3)


def _params(c, gen):
    weight = torch.rand(c, generator=gen, dtype=torch.float64) + 0.5
    bias = 0.5 * torch.randn(c, generator=gen, dtype=torch.float64)
    mean = 0.1 * torch.randn(c, generator=gen, dtype=torch.float64)
    var = torch.rand(c, generator=gen, dtype=torch.float64) + 0.5
    return weight, bias, mean, var


def _moments(x):
    """The per-channel mean and biased variance E[x^2] - E[x]^2 over every
    dim but 1, by stock ops (differentiable)."""
    dims = [d for d in range(x.ndim) if d != 1]
    mean = x.mean(dims)
    return mean, x.square().mean(dims) - mean.square()


def _chain(x, weight, bias, relu, running_mean, running_var, update):
    """The eager chain by autograd: (y, mean, var), the running statistics
    updated as ``update_running`` does."""
    mean, var = _moments(x)
    if update:
        with torch.no_grad():
            running_mean.copy_(0.9 * running_mean + (1 - 0.9) * mean)
            running_var.copy_(0.9 * running_var + (1 - 0.9) * var)
    a, b = bn_fold(mean, var, weight, bias, EPS, x)
    y = x * a + b
    return (torch.relu(y) if relu else y), mean, var


@pytest.mark.parametrize("update", [True, False], ids=["update", "frozen"])
@pytest.mark.parametrize("c", CHANNELS)
@pytest.mark.parametrize("layout", ["nchw", "gsf5d"])
@pytest.mark.parametrize("relu", [False, True], ids=["bn", "bn_relu"])
def test_twin_matches_the_eager_chain(relu, layout, c, update):
    """Forward output, dx, dweight, dbias, the batch mean and biased
    variance and the running statistics after one step; with the running
    statistics frozen (a checkpointed block's recompute) they and the batch
    count stay as they were."""
    gen = torch.Generator().manual_seed(c + 1000 * relu)
    x0 = _input(layout, c, gen)
    cot = torch.randn(x0.shape, generator=gen, dtype=torch.float64)
    weight, bias, run_mean, run_var = _params(c, gen)

    xw, ww, bw = (t.clone().requires_grad_(True) for t in (x0, weight, bias))
    rm_w, rv_w = run_mean.clone(), run_var.clone()
    y_w, mean_w, var_w = _chain(xw, ww, bw, relu, rm_w, rv_w, update)
    (y_w * cot).sum().backward()

    xg, wg, bg = (t.clone().requires_grad_(True) for t in (x0, weight, bias))
    rm_g, rv_g, batches = run_mean.clone(), run_var.clone(), torch.tensor(3)
    running = (rm_g, rv_g, batches) if update else None
    y_g, stats = batch_norm_train(xg, wg, bg, EPS, relu, running)
    (y_g * cot).sum().backward()

    assert torch.equal(y_g, y_w)
    assert y_g.stride() == x0.stride()
    assert not stats.requires_grad
    for what, got, want in (("dx", xg.grad, xw.grad), ("dweight", wg.grad, ww.grad),
                            ("dbias", bg.grad, bw.grad), ("mean", stats[0], mean_w),
                            ("var", stats[1], var_w), ("running mean", rm_g, rm_w),
                            ("running var", rv_g, rv_w)):
        _close(got, want, what)
    assert int(batches) == (4 if update else 3)
    if not update:
        assert torch.equal(rm_g, run_mean) and torch.equal(rv_g, run_var)


@pytest.mark.parametrize("relu", [False, True])
def test_split_batchnorm_module_routes_training_through_the_function(relu, monkeypatch):
    """SplitBatchNorm in training calls batch_norm_train with its ReLU,
    its running statistics (None while ``update_stats`` is off) and its
    process group; in eval it normalises with the running statistics and
    calls nothing."""
    calls = []
    real = common.batch_norm_train

    def spy(x, weight, bias, eps, relu_, running, group):
        calls.append((relu_, running is not None, group))
        return real(x, weight, bias, eps, relu_, running, group)

    monkeypatch.setattr(common, "batch_norm_train", spy)
    bn = SplitBatchNorm(8, relu=relu).double().train()
    x = torch.randn(2, 8, 3, 3, dtype=torch.float64).contiguous(memory_format=torch.channels_last)
    bn(x)
    bn.update_stats = False
    bn(x)
    assert calls == [(relu, True, None), (relu, False, None)]
    assert int(bn.num_batches_tracked) == 1
    bn.eval()
    a, b = bn_fold(bn.running_mean, bn.running_var, bn.weight, bn.bias, bn.eps, x)
    want = torch.relu(x * a + b) if relu else x * a + b
    assert torch.equal(bn(x), want)
    assert len(calls) == 2


def _plain_forward(self, x):
    """SplitBatchNorm.forward as it was before the kernels: the eager chain,
    differentiated by autograd."""
    if self.training:
        mean, var = _moments(x)
        if self.update_stats:
            batchnorm.update_running(
                (self.running_mean, self.running_var, self.num_batches_tracked), mean, var)
    else:
        mean, var = self.running_mean, self.running_var
    a, b = bn_fold(mean, var, self.weight, self.bias, self.eps, x)
    y = x * a + b
    return torch.relu(y) if self.relu else y


def _trunk_step(trunk, x, cot):
    xt = x.clone().requires_grad_(True)
    out = trunk(xt)
    (out * cot).sum().backward()
    grads = {n: p.grad.clone() for n, p in trunk.named_parameters()}
    grads["input"] = xt.grad
    return out.detach(), grads, {k: v.clone() for k, v in trunk.state_dict().items()}


@pytest.mark.parametrize("shift", ["gsf", "gsm"])
def test_checkpoint_backbone_trunk_step_matches_the_eager_chain(shift, monkeypatch):
    """A float64 training step of a checkpointed rny002 trunk (the
    recompute runs the Function with the running statistics frozen) against
    the same trunk on the eager chain without checkpointing: the output,
    every parameter's and the input's gradient, and the running statistics,
    each written once."""
    torch.manual_seed(3)
    trunk = regnet.RegNetY("rny002", clip_len=4, shift_mode=shift, checkpoint_blocks=True)
    trunk = trunk.double().train()
    with torch.no_grad():
        for name, p in trunk.named_parameters():
            if "conv3D" in name or "channel_conv" in name:
                p.normal_(0.0, 0.05)
    state = {k: v.clone() for k, v in trunk.state_dict().items()}
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(8, 3, 32, 32, generator=gen, dtype=torch.float64)
    x = x.contiguous(memory_format=torch.channels_last)
    cot = torch.randn(8, trunk.feat_dim, generator=gen, dtype=torch.float64)

    out, grads, after = _trunk_step(trunk, x, cot)

    trunk.load_state_dict(state)
    trunk.zero_grad(set_to_none=True)
    trunk.checkpoint_blocks = False
    monkeypatch.setattr(SplitBatchNorm, "forward", _plain_forward)
    want_out, want_grads, want_after = _trunk_step(trunk, x, cot)

    _close(out, want_out, "output")
    for name, g in want_grads.items():
        _close(grads[name], g, name)
    for k, v in want_after.items():
        if k.endswith("num_batches_tracked"):
            assert int(after[k]) == int(v) == 1, k
        else:
            _close(after[k], v, k)


# (rows, channels, itemsize, align) of the trunk's BatchNorms in the two
# benchmark cells (bf16): the stem of SoccerNet Ball (400 frames of
# 224 x 398) and of FineDiving (800 of 112 x 112), stage 4 and its GSF fold
# of 92 channels; fp32; a 4-byte aligned view
PLANS = [
    ((400 * 224 * 398, 32, 2, 256), BNPlan(8, 512, 264, 135_079)),
    ((800 * 112 * 112, 32, 2, 256), BNPlan(8, 512, 264, 38_013)),
    ((800 * 7 * 7, 368, 2, 256), BNPlan(8, 506, 264, 149)),
    ((800 * 7 * 7, 92, 2, 256), BNPlan(4, 506, 223, 176)),
    ((800 * 7 * 7, 368, 4, 256), BNPlan(4, 460, 264, 149)),
    ((100, 24, 2, 256), BNPlan(8, 510, 1, 100)),
    ((100_000, 24, 2, 4), BNPlan(2, 504, 264, 379)),
    ((7, 3, 4, 256), BNPlan(1, 510, 1, 7)),
]


@pytest.mark.parametrize("args,want", PLANS)
def test_bn_plan(args, want):
    """The widest access that divides a row and every pointer, whole rows a
    block, two blocks an H100 multiprocessor at most, every row in one
    block and no block empty."""
    rows = args[0]
    plan = bn_plan(*args, sms=132)
    assert plan == want
    lanes = args[1] // plan.vec
    assert plan.threads % lanes == 0 and plan.threads <= batchnorm.THREADS
    assert plan.blocks * plan.rows_per_block >= rows > (plan.blocks - 1) * plan.rows_per_block
    assert plan.blocks <= batchnorm.BLOCKS_PER_SM * 132


@pytest.mark.parametrize("rows,channels,itemsize", [(0, 32, 2), (10, 0, 2), (10, 1026, 4)])
def test_bn_plan_refuses(rows, channels, itemsize):
    with pytest.raises(ValueError):
        bn_plan(rows, channels, itemsize, 16, 132)


def _fold_view(n, c, h, w, f, clip):
    """GatedShift.shift's view of the first f channels of a channels_last
    (n, c, h, w) activation as (B, T, H, W, f), then the gate's
    (B, f, T, H, W) view."""
    x = torch.zeros(n, c, h, w).contiguous(memory_format=torch.channels_last)
    head = x[:, :f].permute(0, 2, 3, 1).reshape(n // clip, clip, h, w, f)
    return head.permute(0, 4, 1, 2, 3)


def test_kernel_inputs_must_hold_channels_innermost():
    """What the kernels take: bf16 or fp32 with channels innermost in memory
    and rows a fixed pitch apart (checked before any launch): (M, C, pitch)
    of channels_last NCHW, the GSF gate's view of a dense fold and of the
    fold channels of a wider activation; contiguous NCHW, a strided row
    dim and float64 raise."""
    x = torch.zeros(2, 8, 3, 5)
    with pytest.raises(ValueError, match="innermost"):
        batchnorm._rows(x, "x")
    assert batchnorm._rows(x.contiguous(memory_format=torch.channels_last), "x") == (30, 8, 8)
    five = torch.zeros(2, 3, 4, 5, 8).permute(0, 4, 1, 2, 3)
    assert batchnorm._rows(five, "x") == (120, 8, 8)
    assert batchnorm._rows(_fold_view(8, 56, 6, 7, 16, 4), "x") == (8 * 42, 16, 56)
    assert batchnorm._rows(torch.zeros(5, 1, 3, 2), "x") == (30, 1, 1)
    with pytest.raises(ValueError, match="innermost"):  # every other column
        batchnorm._rows(five[..., ::2], "x")
    with pytest.raises(TypeError):
        batchnorm._rows(x.double().contiguous(memory_format=torch.channels_last), "x")
    g = batchnorm.channels_innermost(x)
    assert batchnorm.pitch(g) == 8 and torch.equal(g, x)
    fold = _fold_view(8, 56, 6, 7, 16, 4)
    assert batchnorm.channels_innermost(fold) is fold
    dense = batchnorm._dense_like(fold)
    assert dense.shape == fold.shape and batchnorm.pitch(dense) == 16


def test_cpu_tensors_launch_nothing():
    counts = [f.launches for f in (batchnorm.bn_stats, batchnorm.bn_apply,
                                   batchnorm.bn_grad_sums, batchnorm.bn_grad_apply)]
    x = torch.randn(4, 16, 2, 2).contiguous(memory_format=torch.channels_last).requires_grad_()
    w, b = torch.ones(16, requires_grad=True), torch.zeros(16, requires_grad=True)
    y, _ = batch_norm_train(x, w, b, EPS, True)
    y.sum().backward()
    assert counts == [f.launches for f in (batchnorm.bn_stats, batchnorm.bn_apply,
                                           batchnorm.bn_grad_sums, batchnorm.bn_grad_apply)]
    assert np.isfinite(x.grad.numpy()).all()
