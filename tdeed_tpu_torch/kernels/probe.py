"""Access-pattern probe kernels: P1 (port of the three Pallas bodies of
tools/profile_pallas_probe.py:run).

On x, (H, W, C, N) bf16 with the batch N minor:
  ``stream(x)``     -> bf16(x * 1.03125)                    (stream_kernel)
  ``perpix(x, wt)`` -> bf16(wt @ x[h, w]) per pixel, fp32 sums (perpix_kernel)
  ``outerp(x)``     -> (stream(x), sum over (h, w) of x[h, w] @ x[h, w]^T
                        in fp32, (C, C))                     (outerp_kernel)
with C <= 64 and wt (C, C) bf16.

A CUDA tensor launches the kernel (csrc/probe.cu) on the current stream
and adds one to ``<fn>.launches``; a CPU tensor runs the plain version
(``*_reference``), because the caller asked for the CPU. Any other device
raises. There is no fallback from one to the other. The launch plans of
perpix and outerp are ``perpix_plan`` and ``outerp_plan``, pure functions
the CPU tests check.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import torch

SCALE = 1.03125  # exact in bf16: x * SCALE rounds once
MAX_C = 64

PERPIX_STAGES = 3  # csrc/probe.cu:kPerpixStages, tiles in a block's ring
OUTERP_STAGES = 3  # csrc/probe.cu:kOuterStages
H100_SMS = 132
BLOCK_SHARED_MAX = 232_448  # 227 KB: the most one block may use on sm_90


def stream_reference(x: torch.Tensor) -> torch.Tensor:
    """bf16(x * 1.03125), the product taken in fp32 (exact there)."""
    return (x.float() * SCALE).to(torch.bfloat16)


def perpix_reference(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Per pixel (h, w): bf16(wt @ x[h, w]) with fp32 sums."""
    return torch.einsum("cd,hwdn->hwcn", wt.float(), x.float()).to(torch.bfloat16)


def outerp_reference(x: torch.Tensor):
    """(stream_reference(x), sum over (h, w) of x[h, w] @ x[h, w]^T in fp32)."""
    xf = x.float()
    return stream_reference(x), torch.einsum("hwcn,hwdn->cd", xf, xf)


def _check(x: torch.Tensor, wt=None) -> None:
    if x.ndim != 4:
        raise ValueError(f"x must be (H, W, C, N), got {tuple(x.shape)}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.numel() == 0:
        raise ValueError(f"x is empty: {tuple(x.shape)}")
    c = x.shape[2]
    if c > MAX_C:
        raise ValueError(f"C = {c} exceeds {MAX_C}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if wt is None:
        return
    if wt.shape != (c, c) or wt.dtype != torch.bfloat16:
        raise ValueError(f"wt must be ({c}, {c}) bfloat16, got {tuple(wt.shape)} {wt.dtype}")
    if wt.device != x.device:
        raise ValueError(f"wt on {wt.device}, x on {x.device}")
    if not wt.is_contiguous():
        raise ValueError("wt must be contiguous")


@dataclass(frozen=True)
class TilePlan:
    """How the perpix or outerp kernel covers (npix, C, N): work items are
    (pixel, column tile) in order, ``tiles`` tiles of ``bn`` columns per
    pixel (the last one ragged); block b of ``grid`` takes items
    [items * b // grid, items * (b + 1) // grid), as csrc/probe.cu's
    kernels compute it."""

    c: int
    n: int
    npix: int
    c_pad: int  # C rounded up to 16: the kernel's instantiation
    bn: int  # columns of a tile, a multiple of 16
    tiles: int
    smem_bytes: int  # dynamic shared memory of one block
    grid: int


def _tile_plan(what: str, c: int, n: int, npix: int, sms: int, fixed, per_column) -> TilePlan:
    """C padded to the next multiple of 16; the fewest tiles per pixel whose
    width fits a block's 227 KB, whose shared memory is fixed(c_pad) +
    per_column(c_pad) * (bn + 8), cut evenly and rounded up to 16; one
    block per SM, or one per item if fewer."""
    if not (1 <= c <= MAX_C and n >= 1 and npix >= 1):
        raise ValueError(f"{what} takes 1 <= C <= {MAX_C}, N >= 1, npix >= 1; "
                         f"got C={c} N={n} npix={npix}")
    c_pad = -(-c // 16) * 16
    bn_cap = ((BLOCK_SHARED_MAX - fixed(c_pad)) // per_column(c_pad) - 8) // 16 * 16
    tiles = -(-n // bn_cap)
    bn = -(-(-(-n // tiles)) // 16) * 16
    if npix * tiles > 2**31 - 1:  # the kernel counts items in 32 bits
        raise ValueError(f"{what} takes at most 2^31 - 1 work items, got {npix * tiles}")
    return TilePlan(c, n, npix, c_pad, bn, tiles,
                    fixed(c_pad) + per_column(c_pad) * (bn + 8), min(npix * tiles, sms))


def perpix_plan(c: int, n: int, npix: int, sms: int = H100_SMS) -> TilePlan:
    """The perpix launch for npix pixels of (C, N): shared memory per block
    for the (C_pad, C_pad) weight, the ring of PERPIX_STAGES tiles and an
    output tile, each (C_pad, bn + 8) (the layout of csrc/probe.cu:
    perpix_smem, which refuses a smaller figure); tiles as ``_tile_plan``."""
    return _tile_plan("perpix", c, n, npix, sms, lambda cp: 2 * cp * cp,
                      lambda cp: 2 * (PERPIX_STAGES + 1) * cp)


def outerp_plan(c: int, n: int, npix: int, sms: int = H100_SMS) -> TilePlan:
    """The outerp launch for npix pixels of (C, N): shared memory per block
    for the ring of OUTERP_STAGES tiles, each (C_pad, bn + 8) bf16, and the
    block's (C_pad, C_pad) fp32 sum (csrc/probe.cu:outerp_smem, which
    refuses a smaller figure); tiles as ``_tile_plan``: at N = 800 one tile
    is a whole pixel up to C = 32. Each block writes one (C, C) partial."""
    return _tile_plan("outerp", c, n, npix, sms, lambda cp: 4 * cp * cp,
                      lambda cp: 2 * OUTERP_STAGES * cp)


@functools.lru_cache(maxsize=None)
def _lib():
    from tdeed_tpu_torch.kernels.build import load

    lib = load("probe").lib
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.tdeed_probe_stream.argtypes = [ptr, ptr, i64, ptr]
    lib.tdeed_probe_perpix.argtypes = [ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i32, ptr]
    lib.tdeed_probe_outerp.argtypes = [ptr, ptr, ptr, ptr, i64, i32, i32, i32, i32, i32, i32,
                                       ptr]
    for fn in (lib.tdeed_probe_stream, lib.tdeed_probe_perpix, lib.tdeed_probe_outerp):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _on_card(x: torch.Tensor, what: str) -> bool:
    """True for a CUDA tensor, False for a CPU one; raise for the rest."""
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"{what} runs on cuda or cpu, not {x.device}")
    return True


def _launch(what: str, fn, x: torch.Tensor, *args) -> None:
    with torch.cuda.device(x.device):
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"probe {what} kernel launch failed: CUDA error {err}")


def stream(x: torch.Tensor) -> torch.Tensor:
    """bf16(x * 1.03125) over (H, W, C, N) bf16 x."""
    if not _on_card(x, "stream"):
        return stream_reference(x)
    _check(x)
    y = torch.empty_like(x)
    _launch("stream", _lib().tdeed_probe_stream, x, x.data_ptr(), y.data_ptr(), x.numel())
    stream.launches += 1
    return y


def perpix(x: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
    """Per pixel (h, w): bf16(wt @ x[h, w]), fp32 sums; x (H, W, C, N) and
    wt (C, C) bf16.

    On the card: bf16 tensor-core MMAs (fp32 sums, within 1 bf16 ulp of
    ``perpix_reference``; two calls give the same bits) on tiles of C rows
    of a pixel that cp.async brings into shared memory, one block per SM
    walking its items through a ring of three tiles, as
    ``perpix_plan(C, N, H * W)`` lays them out for the card's SMs. A
    misaligned x or N % 8 != 0 takes the kernel's element-wise copies
    instead of its 16-byte ones."""
    if not _on_card(x, "perpix"):
        return perpix_reference(x, wt)
    _check(x, wt)
    h, w, c, n = x.shape
    p = perpix_plan(c, n, h * w, _sm_count(x.device))
    o = torch.empty_like(x)
    _launch("perpix", _lib().tdeed_probe_perpix, x,
            x.data_ptr(), wt.data_ptr(), o.data_ptr(), h * w, c, n,
            p.c_pad, p.bn, p.smem_bytes, p.grid)
    perpix.launches += 1
    return o


def outerp(x: torch.Tensor):
    """(bf16(x * 1.03125), (C, C) fp32 sum over (h, w) of x[h, w] @
    x[h, w]^T) for (H, W, C, N) bf16 x.

    On the card: one pass reads each tile of C rows of a pixel into shared
    memory with cp.async, stores its scaled copy, and adds its Gram to
    bf16 tensor-core MMAs with fp32 sums, one block per SM walking its
    items through a ring of three tiles as ``outerp_plan(C, N, H * W)``
    lays them out; each block writes a (C, C) partial, and a second pass
    adds the partials in a fixed order. No atomics: two calls give the same
    bits. A misaligned x or N % 8 != 0 takes the kernel's element-wise
    copies and stores."""
    if not _on_card(x, "outerp"):
        return outerp_reference(x)
    _check(x)
    h, w, c, n = x.shape
    p = outerp_plan(c, n, h * w, _sm_count(x.device))
    o = torch.empty_like(x)
    partial = torch.empty(p.grid, c, c, dtype=torch.float32, device=x.device)
    acc = torch.empty(c, c, dtype=torch.float32, device=x.device)
    _launch("outerp", _lib().tdeed_probe_outerp, x, x.data_ptr(), o.data_ptr(),
            partial.data_ptr(), acc.data_ptr(), h * w, c, n,
            p.c_pad, p.bn, p.smem_bytes, p.grid)
    outerp.launches += 1
    return o, acc


stream.launches = 0
perpix.launches = 0
outerp.launches = 0
