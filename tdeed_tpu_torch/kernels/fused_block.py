"""Fused RegNet-Y trunk units for training: a forward that keeps little and
a hand-derived two-pass backward (port of tdeed_tpu/kernels/fused_block.py).

Three ``torch.autograd.Function``s, each the counterpart of one of the JAX
package's ``jax.custom_vjp`` factories:

  * ``FusedConvBNReLU``: conv1x1 + SplitBatchNorm + ReLU, the conv1 of a
    stride-1 YBlock (``make_fused_conv_bn_relu``);
  * ``FusedBlock``: [stem ConvBN ->] stride-2 YBlock without a shift, the
    stem + s1_b1 and s2_b1 entry units (``make_fused_block``);
  * ``FusedShiftBlock``: a stride-2 YBlock whose conv1 reads the
    GatedShift's output ``xs`` while the shortcut reads the block input
    ``x`` (``make_fused_shift_block``).

What they change is what a training step keeps between forward and
backward, and how many passes the backward makes, not the numbers. A unit
keeps only its input and the pre-normalisation conv outputs (``x``, ``vs``,
``v1``, ``v2``, ``vd``, and ``xs``) with the BN statistics: not the
post-ReLU stem output, conv1's post-ReLU ``y1`` or the tail's
intermediates that autograd would keep. The backward re-runs the small
tail (BN2 + ReLU, SE, conv3 + BN3, the shortcut's BN, add + ReLU) under
autograd, then makes the big tensors' backward in two passes: P1 masks
conv1's cotangent and takes BN1's two sums (and conv2's weight gradient),
P2 forms ``dv1`` and the conv transposes.

The forward is the op sequence of models/regnet.py's ConvBN + YBlock and
models/common.py's SplitBatchNorm: the same convs, the fp32 moments E[x]
and E[x^2] and the fold into ``x * a + b`` in the compute dtype through
SplitBatchNorm's own ``batch_stats`` and ``bn_fold`` (the JAX module's
``_stats`` and ``_fold``), ReLU. It therefore gives that eager chain's
bits: the plain modules' on the CPU; on the card the plain modules'
BatchNorms run kernels (kernels/batchnorm.py) whose sums take another
order.
The batch statistics come back as non-differentiable outputs; the caller
writes the running statistics (``SplitBatchNorm.record``).

Under data parallelism (a BN ``process_group`` of more than one rank,
parallel/mesh.py) the units follow ``_BatchMoments``: the forward's
moments are the global batch's, and in the backward the terms that reach
``dv`` through the mean and the variance come from the two sums added
over the ranks with the global row count, while ``dscale`` and ``dbias``
come from the rank's own sums, which is what autograd gives the plain
path. (The JAX package needs none of this: GSPMD gives it global sums.)

No hand kernel here: the JAX package leaves this jnp to XLA, and the port
computes it with stock convs and elementwise ops.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F

from tdeed_tpu_torch.kernels.batchnorm import _bn_bwd_coeffs
from tdeed_tpu_torch.models.common import acc_dtype, batch_stats, bn_fold
from tdeed_tpu_torch.parallel import mesh

# The parameters a unit takes, in order (module paths inside a YBlock; a
# shift block's conv1 is its GatedShift's ``net``).
STEM_PARAMS = ("stem.conv.weight", "stem.bn.weight", "stem.bn.bias")
CONV1_PARAMS = ("conv1.conv.weight", "conv1.bn.weight", "conv1.bn.bias")
TAIL_PARAMS = (
    "conv2.bn.weight", "conv2.bn.bias",
    "se.fc1.weight", "se.fc1.bias", "se.fc2.weight", "se.fc2.bias",
    "conv3.conv.weight", "conv3.bn.weight", "conv3.bn.bias",
    "downsample.bn.weight", "downsample.bn.bias",
)
BLOCK_PARAMS = CONV1_PARAMS + ("conv2.conv.weight", "downsample.conv.weight") + TAIL_PARAMS
# The BatchNorms a block unit returns statistics for, in output order.
BLOCK_BNS = ("conv1", "conv2", "conv3", "downsample")

Stats = Tuple[torch.Tensor, torch.Tensor]


# ---------------------------------------------------------------------------
# Forward building blocks (the op sequence of models/regnet.py + common.py)
# ---------------------------------------------------------------------------


def _conv(x, w, stride: int = 1, pad: int = 0, groups: int = 1, bias=None):
    """The port's Conv2d: weight (and bias) cast to the input's dtype."""
    return F.conv2d(x, w.to(x.dtype), None if bias is None else bias.to(x.dtype),
                    stride, pad, 1, groups)


def _bn_apply(v, scale, bias, eps, group):
    m, var = batch_stats(v, group)
    a, b = bn_fold(m, var, scale, bias, eps, v)
    return v * a + b, (m, var)


def _tail(v2, vd, p: Dict[str, torch.Tensor], eps, group):
    """The block after conv2 and the shortcut's conv, one resolution down:
    BN2 + ReLU, SE, conv3 + BN3, the shortcut's BN, add + ReLU.
    Differentiated by autograd, re-run, in the backward."""
    z2, s2 = _bn_apply(v2, p["conv2.bn.weight"], p["conv2.bn.bias"], eps, group)
    y2 = torch.relu(z2)
    s = y2.mean(dim=(2, 3), keepdim=True)
    s = _conv(torch.relu(_conv(s, p["se.fc1.weight"], bias=p["se.fc1.bias"])),
              p["se.fc2.weight"], bias=p["se.fc2.bias"])
    v3 = _conv(y2 * torch.sigmoid(s), p["conv3.conv.weight"])
    z3, s3 = _bn_apply(v3, p["conv3.bn.weight"], p["conv3.bn.bias"], eps, group)
    zd, sd = _bn_apply(vd, p["downsample.bn.weight"], p["downsample.bn.bias"], eps, group)
    return torch.relu(z3 + zd), (s2, s3, sd)


def _conv_bn_relu(x, w, scale, bias, eps, group, stride=1, pad=0):
    """(v, stats, y): the conv, its batch statistics and relu(bn(v))."""
    v = _conv(x, w, stride, pad)
    m, var = batch_stats(v, group)
    a, b = bn_fold(m, var, scale, bias, eps, v)
    return v, (m, var), torch.relu(v * a + b)


def _front_shift(xs, x, p, groups: int, eps, group):
    """Shift-block front: conv1 reads the shifted input ``xs``, the
    shortcut's conv the block input ``x`` (ref: model/shift.py:89-93)."""
    v1, s1, y1 = _conv_bn_relu(xs, *(p[k] for k in CONV1_PARAMS), eps, group)
    v2 = _conv(y1, p["conv2.conv.weight"], 2, 1, groups)
    vd = _conv(x, p["downsample.conv.weight"], 2, 0)
    return v1, s1, v2, vd


def _front(x, p, groups: int, with_stem: bool, eps, group):
    """Everything up to (v2, vd), with the statistics kept for the backward."""
    vs, stem_stats, xin = None, None, x
    if with_stem:
        vs, stem_stats, xin = _conv_bn_relu(x, *(p[k] for k in STEM_PARAMS), eps, group, 2, 1)
    v1, s1, v2, vd = _front_shift(xin, xin, p, groups, eps, group)
    return vs, stem_stats, v1, s1, v2, vd


# ---------------------------------------------------------------------------
# Backward helpers
# ---------------------------------------------------------------------------


def _bn_bwd(dz, v, m, var, scale, a, eps, group):
    """(dv, dscale, dbias) of SplitBatchNorm's training ``z = v * a + b``,
    given dz = dL/dz: the sums in fp32 (or wider); over several ranks
    k0 and k1 from the global sums, dscale and dbias from this rank's.

    The fp32 work runs over chunks of the batch (``_chunks``): XLA fuses
    these chains, eager PyTorch would hold whole fp32 copies of dz and v,
    twice the bf16 activation each, which at the stem's resolution
    outweighs what the unit saved in the forward."""
    dims = [0, 2, 3]
    acc = acc_dtype(v)
    chunks = _chunks(v)
    local = torch.zeros(2, v.shape[1], dtype=acc, device=v.device)
    for c in chunks:
        dzf = dz[c].to(acc)
        local[0] += dzf.sum(dims)
        local[1] += (dzf * v[c].to(acc)).sum(dims)
    world = mesh.world(group)
    n_rows = v.numel() // v.shape[1] * world
    k0, k1, d_scale, d_bias = _bn_bwd_coeffs(local[0], local[1], m, var, scale, n_rows, eps)
    if world > 1:
        sums = local.clone()
        dist.all_reduce(sums, group=group)
        k0, k1, _, _ = _bn_bwd_coeffs(sums[0], sums[1], m, var, scale, n_rows, eps)
    k0, k1 = k0.view(1, -1, 1, 1), k1.view(1, -1, 1, 1)
    dv = torch.empty_like(dz)
    for c in chunks:
        dv[c] = dz[c] * a + (v[c].to(acc) * k1 + k0).to(v.dtype)
    return dv, d_scale.to(scale.dtype), d_bias.to(scale.dtype)


def _chunks(v, elements: int = 1 << 25):
    """Slices of v's batch dim, each of at most ``elements`` (at least one
    row): a 128 MB fp32 temporary at most."""
    step = max(1, elements // max(1, v[0].numel()))
    return [slice(i, i + step) for i in range(0, v.shape[0], step)]


def _conv_bwd(dv, x, w, stride=1, pad=0, groups=1, need_dx=True):
    """(dx, dw) of ``_conv(x, w, ...)`` given dv, by the call autograd
    makes for it (aten.convolution_backward); dx is None unless asked,
    dw comes back in w's dtype."""
    dx, dw, _ = torch.ops.aten.convolution_backward(
        dv, x, w.to(x.dtype), None, [stride, stride], [pad, pad], [1, 1], False, [0, 0],
        groups, [need_dx, True, False],
    )
    return dx, dw.to(w.dtype)


def _relu_bwd(g, y, inplace: bool = False):
    """ReLU's backward from its output ``y``: g where y > 0, else 0; in
    ``g``'s memory with ``inplace`` (a cotangent this backward made)."""
    if inplace:
        return g.masked_fill_(y <= 0, 0)
    return torch.where(y > 0, g, torch.zeros_like(g))


def _tail_bwd(d_out, v2, vd, p, eps, group):
    """(dv2, dvd, {name: grad}) of the tail, by autograd over its re-run."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_() for t in (v2, vd, *(p[k] for k in TAIL_PARAMS))]
        out, _ = _tail(leaves[0], leaves[1], dict(zip(TAIL_PARAMS, leaves[2:])), eps, group)
        grads = torch.autograd.grad(out, leaves, d_out)
    return grads[0], grads[1], dict(zip(TAIL_PARAMS, grads[2:]))


def _middle_bwd(dv2, dvd, xin, v1, s1, p, groups, eps, group, need_dx_in=True):
    """The heavy middle of a block unit's backward. P1: conv2's input
    gradient and weight gradient, conv1's masked cotangent and BN1's sums;
    P2: dv1, then conv1's and the shortcut conv's transposes.
    Returns (dx1, dxd, {name: grad}); dx1 reaches conv1's input, dxd the
    shortcut's."""
    m1, var1 = s1
    w1, scale1, bias1 = (p[k] for k in CONV1_PARAMS)
    a1, b1 = bn_fold(m1, var1, scale1, bias1, eps, v1)
    y1 = torch.relu(v1 * a1 + b1)
    g1, dw2 = _conv_bwd(dv2, y1, p["conv2.conv.weight"], 2, 1, groups)
    dz1 = _relu_bwd(g1, y1, inplace=True)
    del g1, y1
    dv1, d_scale1, d_bias1 = _bn_bwd(dz1, v1, m1, var1, scale1, a1, eps, group)
    del dz1
    dx1, dw1 = _conv_bwd(dv1, xin[0], w1, need_dx=need_dx_in)
    del dv1
    dxd, dwd = _conv_bwd(dvd, xin[1], p["downsample.conv.weight"], 2, 0, need_dx=need_dx_in)
    grads = {"conv1.conv.weight": dw1, "conv1.bn.weight": d_scale1, "conv1.bn.bias": d_bias1,
             "conv2.conv.weight": dw2, "downsample.conv.weight": dwd}
    return dx1, dxd, grads


def _flat_stats(stats: Sequence[Stats]):
    return [t for s in stats for t in s]


# ---------------------------------------------------------------------------
# The fused units
# ---------------------------------------------------------------------------


class FusedConvBNReLU(torch.autograd.Function):
    """conv1x1 + SplitBatchNorm + ReLU, the conv1 of a stride-1 YBlock:
    ``apply(x, eps, group, w, scale, bias) -> (y, mean, var)``.

    Keeps ``x`` and ``v`` (as the plain path, whose conv2 keeps ``y``
    anyway); the backward masks the cotangent and takes BN's two sums in
    one pass, then forms dv and the conv's transposes in a second."""

    @staticmethod
    def forward(ctx, x, eps, group, w, scale, bias):
        v, (m, var), y = _conv_bn_relu(x, w, scale, bias, eps, group)
        ctx.save_for_backward(x, v, m, var, w, scale, bias)
        ctx.eps, ctx.group = eps, group
        ctx.mark_non_differentiable(m, var)
        return y, m, var

    @staticmethod
    def backward(ctx, g, _m, _var):
        x, v, m, var, w, scale, bias = ctx.saved_tensors
        a, b = bn_fold(m, var, scale, bias, ctx.eps, v)
        dz = _relu_bwd(g, v * a + b)
        dv, d_scale, d_bias = _bn_bwd(dz, v, m, var, scale, a, ctx.eps, ctx.group)
        dx, dw = _conv_bwd(dv, x, w, need_dx=ctx.needs_input_grad[0])
        return dx, None, None, dw, d_scale, d_bias


class FusedBlock(torch.autograd.Function):
    """[stem ConvBN ->] stride-2 YBlock without a shift:
    ``apply(x, with_stem, groups, eps, group, *params) -> (out, *stats)``.

    ``params`` are STEM_PARAMS (with the stem) then BLOCK_PARAMS; the stats
    are (mean, var) of BLOCK_BNS, then of the stem. With the stem ``x`` is
    the frames, else the block input. Keeps x, [vs,] v1, v2, vd."""

    @staticmethod
    def forward(ctx, x, with_stem, groups, eps, group, *params):
        names = (STEM_PARAMS if with_stem else ()) + BLOCK_PARAMS
        p = dict(zip(names, params))
        vs, stem_stats, v1, s1, v2, vd = _front(x, p, groups, with_stem, eps, group)
        out, tail_stats = _tail(v2, vd, p, eps, group)
        stats = _flat_stats((s1, *tail_stats) + ((stem_stats,) if with_stem else ()))
        ctx.save_for_backward(x, vs, v1, v2, vd, *stats, *params)
        ctx.names, ctx.with_stem, ctx.groups, ctx.eps, ctx.group = (
            names, with_stem, groups, eps, group)
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, d_out, *_):
        x, vs, v1, v2, vd, *rest = ctx.saved_tensors
        n_stats = 2 * (len(BLOCK_BNS) + ctx.with_stem)
        stats, params = rest[:n_stats], rest[n_stats:]
        p = dict(zip(ctx.names, params))
        eps, group = ctx.eps, ctx.group
        dv2, dvd, grads = _tail_bwd(d_out, v2, vd, p, eps, group)
        if ctx.with_stem:
            ms, vars_ = stats[-2:]
            ws, scale_s, bias_s = (p[k] for k in STEM_PARAMS)
            a_s, b_s = bn_fold(ms, vars_, scale_s, bias_s, eps, vs)
            xin = torch.relu(vs * a_s + b_s)
        else:
            xin = x
        dx, dxd, mid = _middle_bwd(dv2, dvd, (xin, xin), v1, stats[:2], p, ctx.groups, eps,
                                   group, ctx.with_stem or ctx.needs_input_grad[0])
        grads.update(mid)
        if dx is not None:
            dx += dxd
        del dv2, dvd, dxd
        if ctx.with_stem:
            dzs = _relu_bwd(dx, xin, inplace=True)
            del dx, xin
            dvs, d_scale_s, d_bias_s = _bn_bwd(dzs, vs, ms, vars_, scale_s, a_s, eps, group)
            del dzs
            # the frames' gradient: computed only when asked (they are data)
            dx, grads["stem.conv.weight"] = _conv_bwd(dvs, x, ws, 2, 1,
                                                      need_dx=ctx.needs_input_grad[0])
            grads["stem.bn.weight"], grads["stem.bn.bias"] = d_scale_s, d_bias_s
        return (dx, None, None, None, None, *(grads[k] for k in ctx.names))


class FusedShiftBlock(torch.autograd.Function):
    """Stride-2 YBlock whose conv1 input went through a temporal shift:
    ``apply(xs, x, groups, eps, group, *params) -> (out, *stats)``.

    ``xs`` is the GatedShift's output (computed and differentiated by
    autograd outside), ``x`` the block input feeding the shortcut;
    ``params`` are BLOCK_PARAMS, the stats (mean, var) of BLOCK_BNS. The
    cotangents of ``xs`` and ``x`` come back apart, so autograd chains the
    shift's backward and the shortcut's fan-out. Keeps xs, x, v1, v2, vd."""

    @staticmethod
    def forward(ctx, xs, x, groups, eps, group, *params):
        p = dict(zip(BLOCK_PARAMS, params))
        v1, s1, v2, vd = _front_shift(xs, x, p, groups, eps, group)
        out, tail_stats = _tail(v2, vd, p, eps, group)
        stats = _flat_stats((s1, *tail_stats))
        ctx.save_for_backward(xs, x, v1, v2, vd, *stats, *params)
        ctx.groups, ctx.eps, ctx.group = groups, eps, group
        ctx.mark_non_differentiable(*stats)
        return (out, *stats)

    @staticmethod
    def backward(ctx, d_out, *_):
        xs, x, v1, v2, vd, *rest = ctx.saved_tensors
        stats, params = rest[:2 * len(BLOCK_BNS)], rest[2 * len(BLOCK_BNS):]
        p = dict(zip(BLOCK_PARAMS, params))
        dv2, dvd, grads = _tail_bwd(d_out, v2, vd, p, ctx.eps, ctx.group)
        need = ctx.needs_input_grad[0] or ctx.needs_input_grad[1]
        dxs, dxd, mid = _middle_bwd(dv2, dvd, (xs, x), v1, stats[:2], p, ctx.groups, ctx.eps,
                                    ctx.group, need)
        grads.update(mid)
        return (dxs, dxd, None, None, None, *(grads[k] for k in BLOCK_PARAMS))


# ---------------------------------------------------------------------------
# Entry points over the port's modules (models/regnet.py)
# ---------------------------------------------------------------------------


def _unit_params(block, stem=None) -> Tuple[torch.Tensor, ...]:
    """The parameters of ``[stem ->] block`` in a unit's order."""
    mods = {"stem": stem, "conv1": block.conv1_bn, "conv2": block.conv2, "se": block.se,
            "conv3": block.conv3, "downsample": block.downsample}
    names = (STEM_PARAMS if stem is not None else ()) + BLOCK_PARAMS
    out = []
    for name in names:
        mod, attr = name.split(".", 1)
        out.append(mods[mod].get_parameter(attr))
    return tuple(out)


def _bn_args(block) -> Tuple[float, Optional[object]]:
    bn = block.conv2.bn
    return bn.eps, bn.process_group


def _stats_dict(stats, with_stem: bool) -> Dict[str, Stats]:
    keys = BLOCK_BNS + (("stem",) if with_stem else ())
    return {k: (stats[2 * i], stats[2 * i + 1]) for i, k in enumerate(keys)}


def fused_conv_bn_relu(x, convbn) -> Tuple[torch.Tensor, Stats]:
    """relu(bn(conv(x))) of a 1x1 ConvBN through FusedConvBNReLU:
    (y, (batch mean, batch var))."""
    bn = convbn.bn
    y, m, var = FusedConvBNReLU.apply(x, bn.eps, bn.process_group, convbn.conv.weight,
                                      bn.weight, bn.bias)
    return y, (m, var)


def fused_block(x, block, stem=None) -> Tuple[torch.Tensor, Dict[str, Stats]]:
    """``[stem ->] block`` (a stride-2 YBlock without a shift) through
    FusedBlock: (out, {bn: (batch mean, batch var)}) over BLOCK_BNS and,
    with the stem, 'stem'."""
    eps, group = _bn_args(block)
    out, *stats = FusedBlock.apply(x, stem is not None, block.conv2.conv.groups, eps, group,
                                   *_unit_params(block, stem))
    return out, _stats_dict(stats, stem is not None)


def fused_shift_block(xs, x, block) -> Tuple[torch.Tensor, Dict[str, Stats]]:
    """A stride-2 shift YBlock through FusedShiftBlock, from the shifted
    input ``xs`` and the block input ``x``: (out, {bn: (mean, var)})."""
    eps, group = _bn_args(block)
    out, *stats = FusedShiftBlock.apply(xs, x, block.conv2.conv.groups, eps, group,
                                        *_unit_params(block))
    return out, _stats_dict(stats, False)
