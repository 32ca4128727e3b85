"""Training-mode BatchNorm (+ ReLU) of the trunk as four CUDA kernels
(csrc/batchnorm.cu), with fp32 statistics and a compute-dtype application:
models/common.py's SplitBatchNorm runs it in training.

Replaces no TPU kernel: the JAX package leaves the chain to XLA, which
fuses it; eager PyTorch ran it as ~18 full-tensor passes and ~50 launches
a BatchNorm a step. The four steps, each a kernel for a CUDA tensor and its
plain PyTorch twin (``*_reference``) for a CPU tensor, with no fallback
from one to the other:

  ``bn_stats``       x -> (E[x], E[x^2]) per channel, fp32
  ``bn_apply``       -> y = relu?(x * a + b), a and b SplitBatchNorm's fold
                     (``bn_fold``) in the compute dtype; the batch mean and
                     biased variance, and the running statistics written
  ``bn_grad_sums``   g -> (sum dz, sum dz * x), dz g masked by ReLU
  ``bn_grad_apply``  -> dx = dz * a + cast(x * k1 + k0) (``_bn_bwd_coeffs``),
                     dweight, dbias

``TrainBatchNorm`` chains them for autograd, with the all-reduce of the
moments and of the sums between them when the BatchNorm's process group
has more than one rank. It keeps x and per-channel vectors
for the backward, no fp32 copy of an activation, and recomputes ReLU's
mask from x. Each ``bn_*`` function counts its kernel launches in
``<fn>.launches``.

The kernels take bf16 or fp32 activations with channels innermost in
memory (NCHW in channels_last memory, or the GSF gate's (B, C, T, H, W)
view of a (B, T, H, W, C) tensor): an (M, C) row-major array. They raise
on any other dtype or layout; the launch's shape is ``bn_plan``, a pure
function the CPU tests check.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from tdeed_tpu_torch.parallel import mesh

MOMENTUM = 0.9  # flax convention: weight of the old running value

# csrc/batchnorm.cu's launch constants
THREADS = 512  # MAX_THREADS: a block's most threads
BLOCKS_PER_SM = 2  # the kernels' launch bounds keep two blocks an SM resident
MIN_STEPS = 8  # row steps a thread takes at least before the grid grows
GROUP = 16  # blocks whose partial sums one block adds up first
TICKETS = 1024  # a stream's ticket counters: one a group and one more
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}

Running = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype statistics accumulate in: fp32, or the input's if wider."""
    return torch.promote_types(x.dtype, torch.float32)


def _channel_view(v: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    shape = [1] * x.ndim
    shape[1] = x.shape[1]
    return v.view(shape)


def bn_fold(mean, var, weight, bias, eps: float, x):
    """(a, b) of SplitBatchNorm, so that the normalisation is the one
    ``x * a + b``: with inv = weight / sqrt(var + eps) in the statistics'
    dtype, a = inv and b = bias - mean * inv, cast to the dtype of ``x``
    and shaped to broadcast over its dim 1."""
    inv = weight * torch.rsqrt(var + eps)
    return (_channel_view(inv.to(x.dtype), x),
            _channel_view((bias - mean * inv).to(x.dtype), x))


def _bn_bwd_coeffs(S0, S1, m, var, scale, n_rows, eps):
    """From the two sums of BN's output cotangent dz, S0 = sum(dz) and
    S1 = sum(dz * v) (fp32), everything SplitBatchNorm's training backward
    needs:

      dv = dz * a + cast(v * k1 + k0),  dscale, dbias.

    dv is linear in v because var = E[v^2] - E[v]^2. The kernel
    tdeed_bn_grad_apply computes the same formula in the same order."""
    r = torch.rsqrt(var + eps)
    inv = scale * r
    d_inv = S1 - m * S0
    d_scale = d_inv * r
    d_bias = S0
    d_var = scale * d_inv * (-0.5) * r * r * r
    d_mean = -inv * S0 - 2.0 * m * d_var
    k1 = 2.0 * d_var / n_rows
    k0 = d_mean / n_rows
    return k0, k1, d_scale, d_bias


def update_running(running: Running, mean, var) -> None:
    """Mix a batch's (mean, biased var) into the running statistics
    (momentum MOMENTUM on the old value) and count the batch."""
    running_mean, running_var, batches = running
    with torch.no_grad():
        running_mean.copy_(MOMENTUM * running_mean + (1 - MOMENTUM) * mean)
        running_var.copy_(MOMENTUM * running_var + (1 - MOMENTUM) * var)
        batches.add_(1)


# ---------------------------------------------------------------------------
# The plain PyTorch twins (CPU tensors)
# ---------------------------------------------------------------------------


def _dims(x):
    return [d for d in range(x.ndim) if d != 1]


def bn_stats_reference(x):
    """(2, C): E[x] and E[x^2] of each channel in fp32 (or wider)."""
    xf = x.to(acc_dtype(x))
    return torch.stack([xf.mean(_dims(x)), xf.square().mean(_dims(x))])


def _normalise(x, stats, weight, bias, eps, relu):
    a, b = bn_fold(stats[0], stats[1], weight, bias, eps, x)
    y = x * a + b
    return (torch.relu(y) if relu else y), a


def bn_apply_reference(x, moments, weight, bias, eps: float, relu: bool,
                       running: Optional[Running] = None):
    """(y, stats): y = relu?(x * a + b) and stats (2, C) the batch mean and
    biased variance; with ``running``, the running statistics updated."""
    mean, sq = moments.unbind(0)
    stats = torch.stack([mean, sq - mean.square()])
    y, _ = _normalise(x, stats, weight, bias, eps, relu)
    if running is not None:
        update_running(running, stats[0], stats[1])
    return y, stats


def _masked(x, g, stats, weight, bias, eps, relu):
    """(dz, a): g masked where the forward's ReLU output was <= 0."""
    y, a = _normalise(x, stats, weight, bias, eps, relu)
    return (g.masked_fill(y <= 0, 0) if relu else g), a


def bn_grad_sums_reference(x, g, stats, weight, bias, eps: float, relu: bool):
    """(2, C): sum(dz) and sum(dz * x) of each channel in fp32 (or wider)."""
    dz, _ = _masked(x, g, stats, weight, bias, eps, relu)
    acc = acc_dtype(x)
    dzf = dz.to(acc)
    return torch.stack([dzf.sum(_dims(x)), (dzf * x.to(acc)).sum(_dims(x))])


def bn_grad_apply_reference(x, g, stats, weight, bias, eps: float, relu: bool, sums,
                            global_sums, n_rows: int):
    """(dx, dweight, dbias): k0 and k1 from ``global_sums`` and ``n_rows``
    (every rank's rows), dweight and dbias from this rank's ``sums``."""
    dz, a = _masked(x, g, stats, weight, bias, eps, relu)
    mean, var = stats.unbind(0)
    k0, k1, _, _ = _bn_bwd_coeffs(global_sums[0], global_sums[1], mean, var, weight,
                                  n_rows, eps)
    _, _, d_weight, d_bias = _bn_bwd_coeffs(sums[0], sums[1], mean, var, weight, n_rows, eps)
    lin = x.to(acc_dtype(x)) * _channel_view(k1, x) + _channel_view(k0, x)
    return dz * a + lin.to(x.dtype), d_weight, d_bias


# ---------------------------------------------------------------------------
# The kernels (CUDA tensors)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BNPlan:
    """How the kernels cover an (M, C) array: ``blocks`` blocks of
    ``threads`` threads, block i over rows [i * rows_per_block, (i + 1) *
    rows_per_block), a thread over ``vec`` consecutive channels of every
    ``threads / (C / vec)``-th row of its block's slab."""

    vec: int
    threads: int
    blocks: int
    rows_per_block: int


def bn_plan(rows: int, channels: int, itemsize: int, align: int, sms: int) -> BNPlan:
    """The launch for ``rows`` x ``channels`` elements of ``itemsize``
    bytes whose pointers are all multiples of ``align`` bytes on a card of
    ``sms`` multiprocessors: accesses of up to 16 bytes that divide a row,
    as many rows a block as THREADS threads hold, and blocks enough to
    fill the card (BLOCKS_PER_SM an SM) unless the rows run out first."""
    if rows <= 0 or channels <= 0:
        raise ValueError(f"no rows or channels to normalise: {rows} x {channels}")
    vec = next(v for v in (8, 4, 2, 1)
               if v * itemsize <= 16 and channels % v == 0 and align % (v * itemsize) == 0)
    lanes = channels // vec
    if lanes > THREADS:
        raise ValueError(f"{channels} channels of {itemsize} bytes need {lanes} threads a "
                         f"row, over a block's {THREADS}")
    row_step = THREADS // lanes
    blocks = max(1, min(BLOCKS_PER_SM * sms, -(-rows // (row_step * MIN_STEPS))))
    rows_per_block = -(-rows // blocks)
    blocks = -(-rows // rows_per_block)
    return BNPlan(vec, row_step * lanes, blocks, rows_per_block)


def _groups(blocks: int) -> int:
    return -(-blocks // GROUP)


@functools.lru_cache(maxsize=None)
def _lib():
    from tdeed_tpu_torch.kernels.build import load

    lib = load("batchnorm").lib
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    shape = [i, ll, i, i, i, i, ll]  # dtype, rows, channels, vec, threads, blocks, rows a block
    # x, g: a pointer and a row pitch; y, dx: a pointer
    lib.tdeed_bn_stats_launch.argtypes = [p, ll, *shape, p, p, p, p, p]
    lib.tdeed_bn_apply_launch.argtypes = [
        p, ll, p, *shape, p, p, p, f, i, p, p, p, p, i, f, f, p]
    lib.tdeed_bn_grad_sums_launch.argtypes = [
        p, ll, p, ll, *shape, p, p, p, f, i, p, p, p, p, p]
    lib.tdeed_bn_grad_apply_launch.argtypes = [
        p, ll, p, ll, p, *shape, p, p, p, f, i, p, p, ctypes.c_double, p, p, p]
    for fn in (lib.tdeed_bn_stats_launch, lib.tdeed_bn_apply_launch,
               lib.tdeed_bn_grad_sums_launch, lib.tdeed_bn_grad_apply_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# A stream's ticket counters, zero between launches: the last block of a
# reduction sets each back to 0. Kernels on one stream run one at a time,
# so a stream needs one set; two streams never share one.
_TICKETS = {}
# the counters of the CUDA graphs being captured, by (device, stream)
_CAPTURING = {}


def _tickets(device: torch.device, stream: int) -> torch.Tensor:
    key = (device.index, stream)
    if key in _CAPTURING:
        return _CAPTURING[key]
    if key not in _TICKETS:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("a BatchNorm kernel captured into a CUDA graph needs "
                               "ticket counters of its own (captured_tickets)")
        _TICKETS[key] = torch.zeros(TICKETS, dtype=torch.int32, device=device)
    return _TICKETS[key]


def graph_tickets(device: torch.device) -> torch.Tensor:
    """Ticket counters for the kernels of CUDA graphs, all zero: allocate
    them before a capture and keep them as long as the graphs."""
    return torch.zeros(TICKETS, dtype=torch.int32, device=device)


@contextlib.contextmanager
def captured_tickets(tickets: torch.Tensor, stream: int):
    """Within, the kernels launched on ``stream`` (a capturing one) take
    ``tickets`` (``graph_tickets``) for their counters. No eager launch
    sees them, and each replay leaves them at zero, as every launch does.
    A captured stream's kernels run one at a time, so graphs replayed one
    after another on one stream can share one set."""
    key = (tickets.device.index, stream)
    _CAPTURING[key] = tickets
    try:
        yield
    finally:
        del _CAPTURING[key]


def pitch(x: torch.Tensor) -> Optional[int]:
    """The elements between consecutive rows of ``x`` seen as an (M, C)
    array, C its channels (dim 1) innermost in memory: C for a dense
    channels_last tensor, more for a view of the first C channels of a
    wider one (the GSF gate's fold). None when ``x`` has no such view."""
    c = x.shape[1] if x.ndim >= 2 else 0
    if c == 0 or (c > 1 and x.stride(1) != 1):
        return None
    ld, span = None, None
    for d in reversed([d for d in range(x.ndim) if d != 1]):
        if x.shape[d] == 1:
            continue
        if ld is None:
            ld = x.stride(d)
        elif x.stride(d) != span:
            return None
        span = x.stride(d) * x.shape[d]
    ld = c if ld is None else ld
    return ld if ld >= c else None


def _rows(x: torch.Tensor, what: str) -> Tuple[int, int, int]:
    """(M, C, pitch) of a CUDA activation; raises on a dtype or layout the
    kernels do not take."""
    if x.dtype not in _DTYPES:
        raise TypeError(f"{what} must be bfloat16 or float32 on the card, got {x.dtype}")
    ld = pitch(x)
    if ld is None:
        raise ValueError(f"{what} must hold its channels (dim 1) innermost in memory, as "
                         f"channels_last does: shape {tuple(x.shape)}, strides {x.stride()}")
    c = x.shape[1]
    return x.numel() // c, c, ld


def _dense_like(x: torch.Tensor) -> torch.Tensor:
    """An empty tensor of the shape of ``x``, its channels innermost and its
    rows dense, in the order of the other dims of ``x``."""
    return torch.empty(x.movedim(1, -1).shape, dtype=x.dtype, device=x.device).movedim(-1, 1)


def _check_vectors(c: int, device, *vectors: torch.Tensor) -> None:
    """Each of ``vectors`` is (C,) or (2, C) contiguous fp32 on ``device``."""
    for v in vectors:
        if (v.dtype != torch.float32 or v.device != device or not v.is_contiguous()
                or v.shape not in ((c,), (2, c))):
            raise ValueError(f"per-channel vectors must be (C,) or (2, C) contiguous float32 "
                             f"on {device}, C = {c}; got {tuple(v.shape)} {v.dtype} on "
                             f"{v.device}")


def _plan(x: torch.Tensor, *pitched: Tuple[torch.Tensor, int]) -> BNPlan:
    """The launch over ``x``, its accesses as wide as every tensor's
    address and row pitch in ``pitched`` (tensor, pitch) allow."""
    align = 16
    for t, ld in pitched:
        bits = t.data_ptr() | ld * t.element_size() | 16
        align = min(align, bits & -bits)
    return bn_plan(x.numel() // x.shape[1], x.shape[1], x.element_size(), align,
                   _sms(x.device.index))


def _launch(fn, x: torch.Tensor, *args) -> None:
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def _shape_args(x: torch.Tensor, plan: BNPlan) -> list:
    return [_DTYPES[x.dtype], x.numel() // x.shape[1], x.shape[1], plan.vec, plan.threads,
            plan.blocks, plan.rows_per_block]


def _reduce(x: torch.Tensor, plan: BNPlan):
    """(sums, scratch pointers, tickets) of a two-sum reduction launch."""
    c = x.shape[1]
    if _groups(plan.blocks) + 1 > TICKETS:
        raise ValueError(f"{plan.blocks} blocks need more than {TICKETS} tickets")
    out = torch.empty((2, c), dtype=torch.float32, device=x.device)
    scratch = torch.empty((plan.blocks + _groups(plan.blocks)) * 2 * c, dtype=torch.float32,
                          device=x.device)
    group_sums = scratch.data_ptr() + plan.blocks * 2 * c * 4
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return out, scratch, group_sums, _tickets(x.device, stream)


def bn_stats(x: torch.Tensor) -> torch.Tensor:
    """(2, C) fp32: E[x] and E[x^2] of each channel (dim 1) of ``x``."""
    if x.device.type == "cpu":
        return bn_stats_reference(x)
    _, _, ldx = _rows(x, "x")
    plan = _plan(x, (x, ldx))
    moments, scratch, group_sums, tickets = _reduce(x, plan)
    _launch(_lib().tdeed_bn_stats_launch, x, x.data_ptr(), ldx, *_shape_args(x, plan),
            scratch.data_ptr(), group_sums, tickets.data_ptr(), moments.data_ptr())
    bn_stats.launches += 1
    return moments


def bn_apply(x, moments, weight, bias, eps: float, relu: bool,
             running: Optional[Running] = None):
    """(y, stats): y = relu?(x * a + b) in the dtype of ``x``, with a and b
    folded from ``moments`` (E[x], E[x^2]) as ``bn_fold`` does; stats (2, C)
    the batch mean and biased variance in fp32. With ``running`` (mean,
    var, batch count) the running statistics are updated."""
    if x.device.type == "cpu":
        return bn_apply_reference(x, moments, weight, bias, eps, relu, running)
    _, c, ldx = _rows(x, "x")
    y = _dense_like(x)
    plan = _plan(x, (x, ldx), (y, c))
    _check_vectors(c, x.device, weight, bias, moments)
    stats = torch.empty((2, c), dtype=torch.float32, device=x.device)
    ptrs = [0, 0, 0]
    if running is not None:
        _check_vectors(c, x.device, *running[:2])
        ptrs = [t.data_ptr() for t in running]
    _launch(_lib().tdeed_bn_apply_launch, x, x.data_ptr(), ldx, y.data_ptr(),
            *_shape_args(x, plan), moments.data_ptr(), weight.data_ptr(), bias.data_ptr(),
            eps, int(relu), stats.data_ptr(), *ptrs, int(running is not None), MOMENTUM,
            1 - MOMENTUM)
    bn_apply.launches += 1
    return y, stats


def bn_grad_sums(x, g, stats, weight, bias, eps: float, relu: bool) -> torch.Tensor:
    """(2, C) fp32: sum(dz) and sum(dz * x) of each channel, dz the output
    gradient ``g`` masked where relu?(x * a + b) was <= 0."""
    if x.device.type == "cpu":
        return bn_grad_sums_reference(x, g, stats, weight, bias, eps, relu)
    ldx, ldg = _pitches(x, g)
    plan = _plan(x, (x, ldx), (g, ldg))
    _check_vectors(x.shape[1], x.device, weight, bias, stats)
    sums, scratch, group_sums, tickets = _reduce(x, plan)
    _launch(_lib().tdeed_bn_grad_sums_launch, x, x.data_ptr(), ldx, g.data_ptr(), ldg,
            *_shape_args(x, plan), stats.data_ptr(), weight.data_ptr(), bias.data_ptr(), eps,
            int(relu), scratch.data_ptr(), group_sums, tickets.data_ptr(), sums.data_ptr())
    bn_grad_sums.launches += 1
    return sums


def bn_grad_apply(x, g, stats, weight, bias, eps: float, relu: bool, sums, global_sums,
                  n_rows: int):
    """(dx, dweight, dbias) of the normalisation: dx from ``global_sums``
    over ``n_rows`` rows (every rank's), dweight and dbias (fp32) from this
    rank's ``sums``."""
    if x.device.type == "cpu":
        return bn_grad_apply_reference(x, g, stats, weight, bias, eps, relu, sums,
                                       global_sums, n_rows)
    ldx, ldg = _pitches(x, g)
    dx = _dense_like(x)
    c = x.shape[1]
    plan = _plan(x, (x, ldx), (g, ldg), (dx, c))
    _check_vectors(c, x.device, weight, bias, stats, sums, global_sums)
    d_weight = torch.empty(c, dtype=torch.float32, device=x.device)
    d_bias = torch.empty(c, dtype=torch.float32, device=x.device)
    _launch(_lib().tdeed_bn_grad_apply_launch, x, x.data_ptr(), ldx, g.data_ptr(), ldg,
            dx.data_ptr(), *_shape_args(x, plan), stats.data_ptr(), weight.data_ptr(),
            bias.data_ptr(), eps, int(relu), sums.data_ptr(), global_sums.data_ptr(),
            float(n_rows), d_weight.data_ptr(), d_bias.data_ptr())
    bn_grad_apply.launches += 1
    return dx, d_weight, d_bias


for _fn in (bn_stats, bn_apply, bn_grad_sums, bn_grad_apply):
    _fn.launches = 0


def _pitches(x: torch.Tensor, g: torch.Tensor) -> Tuple[int, int]:
    """The row pitches of ``x`` and of its gradient ``g``, which must match
    its shape and dtype."""
    if g.shape != x.shape or g.dtype != x.dtype:
        raise ValueError(f"the gradient must match x: {tuple(g.shape)} {g.dtype} against "
                         f"{tuple(x.shape)} {x.dtype}")
    return _rows(x, "x")[2], _rows(g, "the gradient")[2]


def channels_innermost(g: torch.Tensor) -> torch.Tensor:
    """``g`` with its channels (dim 1) innermost in memory (``pitch``):
    itself when they are, else a copy. Autograd chooses an output
    gradient's layout."""
    if pitch(g) is not None:
        return g
    return g.movedim(1, -1).contiguous().movedim(-1, 1)


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class TrainBatchNorm(torch.autograd.Function):
    """Training-mode SplitBatchNorm (+ ReLU): (y, stats), stats the batch
    mean and biased variance (2, C), not differentiable. Over a
    ``group`` of W > 1 ranks the moments are the global batch's (one
    all-reduce forward); in the backward dx takes its coefficients from the
    sums added over the ranks and the global row count, while dweight and
    dbias come from the rank's own sums (a second all-reduce). Each rank
    differentiates its own loss L_r and the step averages the parameter
    gradients over the ranks, the gradient of the mean of the L_r; the
    moments feed every rank's loss, so rank r's dx is d(sum_s L_s)/dx_r,
    as in the local gradients of the other layers."""

    @staticmethod
    def forward(ctx, x, weight, bias, running: Optional[Running], eps: float, relu: bool,
                group=None):
        moments = bn_stats(x)
        world = mesh.world(group)
        if world > 1:
            dist.all_reduce(moments, group=group)
            moments = moments / world
        y, stats = bn_apply(x, moments, weight, bias, eps, relu, running)
        ctx.save_for_backward(x, weight, bias, stats)
        ctx.eps, ctx.relu, ctx.group, ctx.world = eps, relu, group, world
        ctx.mark_non_differentiable(stats)
        return y, stats

    @staticmethod
    def backward(ctx, g, _stats):
        x, weight, bias, stats = ctx.saved_tensors
        g = channels_innermost(g) if g.is_cuda else g
        args = (stats, weight, bias, ctx.eps, ctx.relu)
        sums = bn_grad_sums(x, g, *args)
        global_sums = sums
        if ctx.world > 1:
            global_sums = sums.clone()
            dist.all_reduce(global_sums, group=ctx.group)
        n_rows = x.numel() // x.shape[1] * ctx.world
        dx, d_weight, d_bias = bn_grad_apply(x, g, *args, sums, global_sums, n_rows)
        return dx, d_weight.to(weight.dtype), d_bias.to(bias.dtype), None, None, None, None


def batch_norm_train(x, weight, bias, eps: float, relu: bool = False,
                     running: Optional[Running] = None, group=None):
    """relu?(SplitBatchNorm(x)) in training: y, with the batch mean and
    biased variance (2, C); ``running`` (mean, var, batch count) updated
    when given."""
    return TrainBatchNorm.apply(x, weight, bias, running, eps, relu, group)

