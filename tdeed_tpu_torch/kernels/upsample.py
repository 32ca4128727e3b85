"""The SGP-Mixer's linear align-corners upsample along time as two CUDA
kernels (csrc/upsample.cu), forward and backward: ops/temporal.py's
``linear_upsample`` runs them for a CUDA tensor, outside any
``torch.compile`` or ``torch.export`` trace.

Replaces no TPU kernel: the JAX package multiplies by a fixed (T_out, T_in)
matrix (tdeed_tpu/ops/temporal.py). Eager PyTorch ran ATen's
``upsample_linear1d``, whose kernels run one thread per output time step
over every (batch, channel) row, the backward with bf16 atomic adds.

  ``upsample_forward``   x (B, C, T_in) at any strides -> y (B, C, T_out)
  ``upsample_backward``  dy (B, C, T_out) at any strides -> dx (B, C, T_in)

Both write dense (B, C, T) tensors, the layout eager ``F.interpolate`` and
its backward give. Both compute ATen's align-corners source index in fp32
(``source_index``), take bf16 or fp32, accumulate in fp32 and round once;
the backward gathers each input element's terms (``gather_window``), with
no atomics, so two runs give the same bits. Each counts its launches in
``<fn>.launches``. The launch's shape is ``upsample_plan``, a pure
function the CPU tests check.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import List, Tuple

import numpy as np
import torch

THREADS = 512  # a block's most threads
CT = 8  # channels a block, where its shared memory holds them
SMEM_BYTES = 227 * 1024  # csrc/upsample.cu's MAX_SMEM: a block's most shared memory
_DTYPES = {torch.bfloat16: 0, torch.float32: 1}


# ---------------------------------------------------------------------------
# ATen's align-corners arithmetic, in the kernels' fp32
# ---------------------------------------------------------------------------


def rwidth(t_in: int, t_out: int) -> np.float32:
    """(T_in - 1) / (T_out - 1) in fp32, 0 for one output step."""
    if t_out <= 1:
        return np.float32(0.0)
    return np.float32(t_in - 1) / np.float32(t_out - 1)


def source_index(t_in: int, t_out: int):
    """(w1, w1p, lambda0, lambda1) of each output step, as the kernels
    compute them: y[i] = lambda0 x[w1] + lambda1 x[w1 + w1p]."""
    w1r = rwidth(t_in, t_out) * np.arange(t_out, dtype=np.float32)
    w1 = w1r.astype(np.int64)
    w1p = (w1 < t_in - 1).astype(np.int64)
    l1 = w1r - w1.astype(np.float32)
    return w1, w1p, np.float32(1.0) - l1, l1


def gather_window(j: int, t_in: int, t_out: int) -> Tuple[int, int]:
    """The outputs [lo, hi] the backward scans for input element j: those
    whose source lies within one step of j, widened by one on each side so
    that fp32 rounding cannot drop a term (every output when rwidth is 0)."""
    r = rwidth(t_in, t_out)
    if r == 0:
        return 0, t_out - 1
    a = np.floor(np.float32(j - 1) / r)
    b = np.floor(np.float32(j + 1) / r)
    return max(0, int(max(a, -1.0)) - 1), min(t_out - 1, int(min(b, float(t_out))) + 1)


def gather_pairs(t_in: int, t_out: int) -> List[List[Tuple[int, float]]]:
    """For each input element j, the (output i, weight) terms the backward
    adds, in its order: ascending i, lambda0's before lambda1's."""
    if t_in == t_out:
        return [[(j, 1.0)] for j in range(t_in)]
    w1, w1p, l0, l1 = source_index(t_in, t_out)
    pairs = []
    for j in range(t_in):
        lo, hi = gather_window(j, t_in, t_out)
        terms = []
        for i in range(lo, hi + 1):
            if w1[i] == j:
                terms.append((i, float(l0[i])))
            if w1[i] + w1p[i] == j:
                terms.append((i, float(l1[i])))
        pairs.append(terms)
    return pairs


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class UpsamplePlan:
    """A grid of (ceil(C / ct), B) blocks of ``threads`` threads; a block
    stages ``ct`` channels of one batch row, whole in time, at ``pitch``
    floats a channel, computes its result slab in shared memory and writes
    it. ``along_c``: the staging loads walk channels (the source's
    unit-stride axis), else its (c, t) elements. ``vec_read``/``vec_write``:
    elements a load / a store (1, or 16 bytes). ``smem_bytes``: the
    block's dynamic shared memory (csrc/upsample.cu's smem_bytes)."""

    ct: int
    blocks: Tuple[int, int]
    threads: int
    pitch: int
    vec_read: int
    along_c: bool
    vec_write: int
    smem_bytes: int


def _smem(ct: int, pitch: int, t_in: int, t_out: int, itemsize: int, backward: bool) -> int:
    """The result slab (rounded up to 16 bytes), the staged fp32 slab, the
    source table of 4 words an output step and the backward's window of 2
    words an input step."""
    t_write = t_in if backward else t_out
    return (-(-ct * t_write * itemsize // 16) * 16
            + 4 * (ct * pitch + 4 * t_out + (2 * t_in if backward else 0)))


def upsample_plan(batch: int, channels: int, t_in: int, t_out: int, backward: bool,
                  itemsize: int, strides: Tuple[int, int, int], align_read: int,
                  align_write: int) -> UpsamplePlan:
    """The launch of the forward (reads (B, C, t_in), writes (B, C, t_out))
    or the backward (reads (B, C, t_out), writes (B, C, t_in)): the source
    read at ``strides`` (elements) from an address that is a multiple of
    ``align_read`` bytes, the dense result written at a multiple of
    ``align_write``. CT channels a block, fewer where the shared memory
    holds fewer; 16-byte accesses where every block's addresses allow,
    else one element; a thread for each element of the result slab, up to
    THREADS."""
    t_read, t_write = (t_out, t_in) if backward else (t_in, t_out)
    if min(batch, channels, t_in, t_out) <= 0:
        raise ValueError(f"nothing to upsample: batch {batch}, channels {channels}, "
                         f"lengths {t_in} -> {t_out}")
    if batch > 65535:
        raise ValueError(f"a batch of {batch} rows is over the grid's 65,535")
    sb, sc, st = strides
    pitch = t_read + 1 - t_read % 2  # odd: a channel's row starts on another bank
    ct = min(CT, channels)
    while ct > 0 and _smem(ct, pitch, t_in, t_out, itemsize, backward) > SMEM_BYTES:
        ct -= 1
    if ct < 1:
        raise ValueError(f"rows of {t_in} -> {t_out} time steps are over a block's "
                         f"{SMEM_BYTES} bytes of shared memory")
    v = 16 // itemsize
    along_c = sc == 1 and st != 1 and channels > 1
    if along_c:
        ok = channels % v == 0 and ct % v == 0 and sb % v == 0 and st % v == 0
    else:
        ok = (st == 1 and (sc == t_read or ct == 1) and sb % v == 0 and (ct * sc) % v == 0
              and (ct * t_read) % v == 0 and (channels * t_read) % v == 0)
    vec_read = v if ok and align_read % 16 == 0 else 1
    ok = (channels * t_write) % v == 0 and (ct * t_write) % v == 0 and align_write % 16 == 0
    vec_write = v if ok else 1
    stage = (ct // vec_read) * t_read if along_c else ct * t_read // vec_read
    threads = min(THREADS, max(32, -(-max(stage, ct * t_write) // 32) * 32))
    return UpsamplePlan(ct, (-(-channels // ct), batch), threads, pitch, vec_read, along_c,
                        vec_write, _smem(ct, pitch, t_in, t_out, itemsize, backward))


@functools.lru_cache(maxsize=None)
def _lib():
    from tdeed_tpu_torch.kernels.build import load

    lib = load("upsample").lib
    p, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    # src, its strides, out, dtype, B, C, T_in, T_out, rwidth, ct, threads,
    # pitch, vec_read, along_c, vec_write, stream
    args = [p, ll, ll, ll, p, i, i, i, i, i, f, i, i, i, i, i, i, p]
    for fn in (lib.tdeed_upsample_fwd_launch, lib.tdeed_upsample_bwd_launch):
        fn.argtypes = args
        fn.restype = ctypes.c_int
    return lib


def _align(t: torch.Tensor) -> int:
    bits = t.data_ptr() | 16
    return bits & -bits


def _run(src: torch.Tensor, t_in: int, t_out: int, backward: bool) -> torch.Tensor:
    """The dense (B, C, T) result of one kernel over ``src``, its launch
    counted."""
    if src.device.type != "cuda":
        raise ValueError(f"the upsample kernels take a CUDA tensor, got one on {src.device}")
    if src.dtype not in _DTYPES:
        raise TypeError(f"the upsample kernels take bfloat16 or float32, got {src.dtype}")
    if src.ndim != 3:
        raise ValueError(f"the upsample kernels take (B, C, T), got {tuple(src.shape)}")
    b, c, _ = src.shape
    out = torch.empty((b, c, t_in if backward else t_out), dtype=src.dtype, device=src.device)
    if out.numel() == 0:
        return out
    plan = upsample_plan(b, c, t_in, t_out, backward, src.element_size(), tuple(src.stride()),
                         _align(src), _align(out))
    lib = _lib()
    fn = lib.tdeed_upsample_bwd_launch if backward else lib.tdeed_upsample_fwd_launch
    with torch.cuda.device(src.device):
        err = fn(src.data_ptr(), *src.stride(), out.data_ptr(), _DTYPES[src.dtype], b, c,
                 t_in, t_out, float(rwidth(t_in, t_out)), plan.ct, plan.threads, plan.pitch,
                 plan.vec_read, int(plan.along_c), plan.vec_write,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{fn.__name__} failed: CUDA error {err}")
    (upsample_backward if backward else upsample_forward).launches += 1
    return out


def upsample_forward(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """(B, C, T_in) -> dense (B, C, t_out), linear with align_corners."""
    return _run(x, x.shape[-1], t_out, backward=False)


def upsample_backward(dy: torch.Tensor, t_in: int) -> torch.Tensor:
    """The input gradient, dense (B, C, t_in), of ``upsample_forward`` to
    dy's (B, C, T_out)."""
    return _run(dy, t_in, dy.shape[-1], backward=True)


for _fn in (upsample_forward, upsample_backward):
    _fn.launches = 0


class LinearUpsample(torch.autograd.Function):
    """``upsample_forward`` for autograd; it keeps no tensor, as the map is
    linear."""

    @staticmethod
    def forward(ctx, x, t_out: int):
        ctx.t_in = x.shape[-1]
        return upsample_forward(x, t_out)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, dy):
        return upsample_backward(dy, ctx.t_in), None


def linear_upsample(x: torch.Tensor, t_out: int) -> torch.Tensor:
    """F.interpolate(x, t_out, mode='linear', align_corners=True) of a CUDA
    (B, C, T) tensor, by the kernels."""
    return LinearUpsample.apply(x, t_out)
