"""The RegNet-Y blocks' squeeze-and-excitation (SE): the gate's product
and the backward as three CUDA kernels (csrc/se.cu). models/regnet.py's
``SEModule`` runs them for a CUDA tensor, outside any ``torch.compile`` or
``torch.export`` trace.

Replaces no TPU kernel: the JAX package leaves the SE to XLA, which fuses
it. Eager PyTorch ran it as 13 passes over the block's tensor a training
step, among them autograd's add of the mean's NCHW-contiguous gradient
into the product's channels_last one, which ATen runs in its unvectorised
elementwise kernel. The three steps, each a kernel for a CUDA tensor and
its plain PyTorch twin (``*_reference``) for a CPU tensor, with no
fallback from one to the other:

  ``se_excite``      x (N, C, H, W), s (N, C) -> y = x * s, rounded once
                     from fp32 as ATen's product is
  ``se_grad_sums``   g, x -> (N, C) fp32: the sum over H, W of g * x
  ``se_grad_apply``  g, s, dm (N, C) -> dx = g * s + dm / HW, in fp32 and
                     rounded once

``SqueezeExcite`` chains them for autograd. Its forward keeps ATen's mean
and the module's gate (stock ops on (N, C) vectors) and the excite
gives ATen's product's bits, so the forward is the stock ops' bit for bit,
as an exported program (ATen's ops) gives it. A mean summed in another
order would not be: random weights turn one bf16 ulp in a few means into
a different prediction. In the backward x's gradient is written by one
kernel, with no accumulation add. Each ``se_*`` function counts its kernel
launches in ``<fn>.launches``.

The kernels take bf16 or fp32 activations in dense channels_last memory
and raise on any other dtype or layout; their sums are fp32 in an order
fixed by the launch, with no float atomics, so two runs give the same
bits. The launch's shape is ``se_plan``, a pure function the CPU tests
check.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

from tdeed_tpu_torch.kernels.batchnorm import acc_dtype
from tdeed_tpu_torch.kernels.upsample import _align

# csrc/se.cu's launch constants
THREADS = 512  # MAX_THREADS: a block's most threads
MIN_THREADS = 128  # samples are packed into a block while it has fewer threads
MIN_STEPS = 16  # rows a thread takes at least, where a sample has them
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


# ---------------------------------------------------------------------------
# The plain PyTorch twins (CPU tensors)
# ---------------------------------------------------------------------------


def _hw(x: torch.Tensor) -> int:
    return x.shape[2] * x.shape[3]


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[:, :, None, None]


def se_excite_reference(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x * s, s (N, C) a channel's gate, in channels_last memory."""
    return (x * _per_channel(s)).contiguous(memory_format=torch.channels_last)


def se_grad_sums_reference(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N, C) in fp32 (or wider): the sum over H, W of g * x."""
    acc = acc_dtype(x)
    return (g.to(acc) * x.to(acc)).sum((2, 3))


def se_grad_apply_reference(g: torch.Tensor, s: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """g * s + dm / HW in fp32 (or wider), rounded once to g's dtype, in
    channels_last memory."""
    acc = acc_dtype(g)
    dx = g.to(acc) * _per_channel(s.to(acc)) + _per_channel(dm.to(acc) / _hw(g))
    return dx.to(g.dtype).contiguous(memory_format=torch.channels_last)


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SEPlan:
    """How the kernels cover N samples of (HW, C) rows: ``blocks`` blocks of
    ``threads`` threads, each over ``units`` whole samples (packed where one
    sample's rows would leave it small); a thread owns ``vec`` consecutive
    channels of every ``rows``-th row of its sample's rows."""

    vec: int
    units: int
    rows: int
    threads: int
    blocks: int


def se_plan(n: int, hw: int, channels: int, itemsize: int, align: int) -> SEPlan:
    """The launch for ``n`` samples of ``hw`` rows of ``channels`` elements of
    ``itemsize`` bytes, every pointer a multiple of ``align`` bytes: accesses
    of up to 16 bytes that divide a row; as many row groups a block as
    THREADS threads hold, but few enough that each thread takes MIN_STEPS
    rows, where the sample has them (a block's sums through shared memory
    cost the same whatever its rows); samples packed into a block while it
    has fewer than MIN_THREADS threads. On the card, blocks of THREADS
    threads ran slower than smaller ones where a thread had under 16 rows,
    and splitting a sample's rows over several blocks gained nothing at the
    shipped configs' 200-800 samples a training micro-batch."""
    if min(n, hw, channels) <= 0:
        raise ValueError(f"nothing to squeeze: {n} samples of {hw} rows x {channels} channels")
    vec = next(v for v in (8, 4, 2, 1)
               if v * itemsize <= 16 and channels % v == 0 and align % (v * itemsize) == 0)
    lanes = channels // vec
    if lanes > THREADS:
        raise ValueError(f"{channels} channels of {itemsize} bytes need {lanes} threads a row, "
                         f"over a block's {THREADS}")
    rows = max(1, min(THREADS // lanes, hw // MIN_STEPS))
    units = max(1, min(n, MIN_THREADS // (rows * lanes)))
    return SEPlan(vec, units, rows, units * rows * lanes, -(-n // units))


@functools.lru_cache(maxsize=None)
def _lib():
    from tdeed_tpu_torch.kernels.build import load

    lib = load("se").lib
    p, i = ctypes.c_void_p, ctypes.c_int
    plan = [i] * 7  # dtype, N, HW, C, vec, units, rows; then threads
    lib.tdeed_se_excite_launch.argtypes = [p, p, p, *plan, i, p]
    lib.tdeed_se_grad_sums_launch.argtypes = [p, p, p, *plan, i, p]
    lib.tdeed_se_grad_apply_launch.argtypes = [p, p, p, p, *plan, i, p]
    for fn in (lib.tdeed_se_excite_launch, lib.tdeed_se_grad_sums_launch,
               lib.tdeed_se_grad_apply_launch):
        fn.restype = ctypes.c_int
    return lib


def _slab(t: torch.Tensor, what: str) -> None:
    """Raise unless ``t`` is a CUDA (N, C, H, W) activation the kernels take."""
    if t.dtype not in _DTYPES:
        raise TypeError(f"{what} must be bfloat16 or float32 on the card, got {t.dtype}")
    if t.ndim != 4 or not t.is_contiguous(memory_format=torch.channels_last):
        raise ValueError(f"{what} must be (N, C, H, W) in dense channels_last memory: shape "
                         f"{tuple(t.shape)}, strides {t.stride()}")


def _check_vector(x: torch.Tensor, what: str, v: torch.Tensor) -> None:
    """Raise unless ``v`` is a contiguous (N, C) tensor of x's dtype and device."""
    if (v.shape != x.shape[:2] or v.dtype != x.dtype or v.device != x.device
            or not v.is_contiguous()):
        raise ValueError(f"{what} must be contiguous {tuple(x.shape[:2])} {x.dtype} on "
                         f"{x.device}; got {tuple(v.shape)} {v.dtype} on {v.device}")


def _launch(fn, x: torch.Tensor, pointers, *slabs: torch.Tensor) -> None:
    """Launch ``fn`` over x's samples, its accesses as wide as the addresses
    of ``slabs`` allow."""
    n, c = x.shape[:2]
    plan = se_plan(n, _hw(x), c, x.element_size(), min(map(_align, slabs)))
    with torch.cuda.device(x.device):
        err = fn(*pointers, _DTYPES[x.dtype], n, _hw(x), c, plan.vec, plan.units, plan.rows,
                 plan.threads, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")


def se_excite(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x * s, s (N, C) each sample's channel gate in x's dtype."""
    if x.device.type == "cpu":
        return se_excite_reference(x, s)
    _slab(x, "x")
    _check_vector(x, "the gate", s)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    _launch(_lib().tdeed_se_excite_launch, x, (x.data_ptr(), s.data_ptr(), y.data_ptr()), x, y)
    se_excite.launches += 1
    return y


def se_grad_sums(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """(N, C) fp32: the sum of g * x over each sample's H, W."""
    if x.device.type == "cpu":
        return se_grad_sums_reference(g, x)
    _slab(x, "x")
    _slab(g, "the gradient")
    if g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"the gradient must match x: {tuple(g.shape)} {g.dtype} on {g.device} "
                         f"against {tuple(x.shape)} {x.dtype} on {x.device}")
    sums = torch.empty(x.shape[:2], dtype=torch.float32, device=x.device)
    _launch(_lib().tdeed_se_grad_sums_launch, x, (g.data_ptr(), x.data_ptr(), sums.data_ptr()),
            g, x)
    se_grad_sums.launches += 1
    return sums


def se_grad_apply(g: torch.Tensor, s: torch.Tensor, dm: torch.Tensor) -> torch.Tensor:
    """dx = g * s + dm / HW, s and dm (N, C) in g's dtype."""
    if g.device.type == "cpu":
        return se_grad_apply_reference(g, s, dm)
    _slab(g, "the gradient")
    _check_vector(g, "the gate", s)
    _check_vector(g, "dm", dm)
    dx = torch.empty_like(g, memory_format=torch.channels_last)
    _launch(_lib().tdeed_se_grad_apply_launch, g,
            (g.data_ptr(), s.data_ptr(), dm.data_ptr(), dx.data_ptr()), g, dx)
    se_grad_apply.launches += 1
    return dx


for _fn in (se_excite, se_grad_sums, se_grad_apply):
    _fn.launches = 0


# ---------------------------------------------------------------------------
# Autograd
# ---------------------------------------------------------------------------


class SqueezeExcite(torch.autograd.Function):
    """y = x * gate(mean_hw(x)): ATen's mean, the gate (a module's stock ops
    on the (N, C, 1, 1) mean, reading ``params``) and ``se_excite``. The
    backward runs the gate again under grad on the detached mean and takes
    the mean's and the parameters' gradients from autograd; x's gradient is
    g * s plus the mean's share, in one kernel. The gate's graph is not
    kept from the forward: a checkpointed block's saved-tensor hooks would
    pack its tensors, and the nested backward, a graph task of its own,
    would recompute the whole block a second time. Keeps x, the mean and
    the gate for the backward."""

    @staticmethod
    def forward(ctx, x, gate, *params):
        m = x.mean(dim=(2, 3), keepdim=True)
        s = gate(m)
        ctx.save_for_backward(x, m, s)
        ctx.gate, ctx.params = gate, params
        return se_excite(x, s.flatten(1))

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, m, s = ctx.saved_tensors
        g = g.contiguous(memory_format=torch.channels_last)
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            m = m.detach().requires_grad_()
            z = ctx.gate(m)
        ds = se_grad_sums(g, x).to(x.dtype).view_as(z)
        dm, *dp = torch.autograd.grad(z, [m, *(p for p, n in zip(ctx.params, need) if n)], ds)
        dp.reverse()
        return (se_grad_apply(g, s.flatten(1), dm.flatten(1)), None,
                *(dp.pop() if n else None for n in need))


def squeeze_excite(x: torch.Tensor, gate, params) -> torch.Tensor:
    """The SE of x (N, C, H, W) through ``gate``, a function of its (N, C,
    1, 1) mean that reads the tensors ``params``, by the kernels for a CUDA
    tensor and their twins for a CPU one."""
    return SqueezeExcite.apply(x, gate, *params)
