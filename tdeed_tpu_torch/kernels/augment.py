"""Fused photometric augmentation: kernel K1 (port of
tdeed_tpu/kernels/augment.py:photometric_planar).

One pass per frame: /255 -> gated hflip -> gated hue shift -> saturation ->
brightness -> contrast toward the frame's gray mean (each clamped to
[0, 1]) -> gated separable 5-tap reflect-padded blur -> ImageNet
standardization -> bf16. Frames stay in the (B, T, H, W, 3) layout the
model reads; the TPU kernel's planar transposes, exchange-matrix flip and
cast chain are gone.

``photometric`` launches the CUDA kernel (csrc/photometric.cu) for a CUDA
tensor and runs ``photometric_reference``, the same chain in eager fp32
PyTorch, for a CPU tensor. There is no fallback from one to the other.
The kernel's launch plan is ``photometric_plan``, a pure function the CPU
tests check.

Per-clip parameters, (B, 16) fp32 (the JAX package's layout, :38-46):
   0: hue gate        1: hue shift
   2: sat gate        3: sat factor
   4: bright gate     5: bright factor
   6: contrast gate   7: contrast factor
   8: blur gate       9..13: blur taps k0..k4
  14: hflip gate     15: pad
A gate is on when its value is > 0.5.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

N_PARAMS = 16
MAX_FRAMES = 65535  # B * T a call takes

# csrc/photometric.cu's launch constants
MAX_CLUSTER = 8  # CTAs of a frame's cluster: the portable most
MAX_CHUNK = 8  # rows a CTA computes between two barriers
HALO = 2  # rows above and below a chunk the 5-tap blur reads
SMEM_HEADER = 128  # params, warp sums and a band's partial sum
BAND_ROWS = 56  # rows of a band the plan aims at: 4 bands at 224 rows
BLOCK_SHARED_MAX = 232_448  # 227 KB: the most one block may use on sm_90
BLOCKS_PER_SM = (3, 2, 1)  # the plan takes the largest chunk that fits the most blocks
_IN_BYTES = {torch.uint8: 1, torch.bfloat16: 2}

_MEAN = (0.485, 0.456, 0.406)
_STD = (0.229, 0.224, 0.225)


def sample_params(generator: torch.Generator, batch: int) -> torch.Tensor:
    """Draw per-clip parameters on the generator's device with the JAX
    package's distributions (:49-75): gates p=.25; hue U(-.2, .2);
    saturation, brightness, contrast U(.7, 1.2); blur sigma U(.1, 2) ->
    normalized 5-tap kernel. Slot 14 is the hflip gate, p=.5 (the JAX
    wrapper draws it apart and writes it there). Returns (B, 16) fp32."""
    dev = generator.device

    def rand():
        return torch.rand(batch, generator=generator, device=dev)

    def gate(p):
        return (rand() < p).float()

    def uniform(lo, hi):
        return lo + (hi - lo) * rand()

    cols = [
        gate(0.25), uniform(-0.2, 0.2),
        gate(0.25), uniform(0.7, 1.2),
        gate(0.25), uniform(0.7, 1.2),
        gate(0.25), uniform(0.7, 1.2),
        gate(0.25),
    ]
    sigma = uniform(0.1, 2.0)
    offs = torch.arange(-2, 3, dtype=torch.float32, device=dev)
    taps = torch.exp(-0.5 * (offs[None, :] / sigma[:, None]).square())
    taps = taps / taps.sum(dim=1, keepdim=True)
    flip = gate(0.5)
    return torch.cat(
        [torch.stack(cols, 1), taps, flip[:, None], torch.zeros(batch, 1, device=dev)],
        dim=1,
    )


def _hue_shift(r, g, b, shift):
    """rgb->hsv, shift h, hsv->rgb (torchvision adjust_hue math, the JAX
    package's _hue_shift op for op)."""
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    delta = maxc - minc
    one = torch.ones_like(delta)
    safe = torch.where(delta > 0, delta, one)
    rc = (maxc - r) / safe
    gc = (maxc - g) / safe
    bc = (maxc - b) / safe
    h = torch.where(
        maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc)
    )
    h = torch.where(delta > 0, h, torch.zeros_like(h))
    h = torch.remainder(h / 6.0, 1.0)
    s = torch.where(maxc > 0, delta / torch.where(maxc > 0, maxc, one), 0.0)
    v = maxc

    h = torch.remainder(h + shift, 1.0)
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    pp = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    i6 = i.long() % 6  # h6 can round up to 6.0

    def sel(*cands):
        out = cands[5]
        for idx in (4, 3, 2, 1, 0):
            out = torch.where(i6 == idx, cands[idx], out)
        return out

    return sel(v, q, pp, pp, t, v), sel(t, v, v, q, pp, pp), sel(pp, pp, t, v, v, q)


def _blur_reflect(c, taps):
    """Separable 5-tap blur of (B, T, H, W) with width-2 reflect padding,
    H then W; taps (B, 5)."""
    h, w = c.shape[-2:]
    k = [taps[:, j].view(-1, 1, 1, 1) for j in range(5)]
    xp = F.pad(c, (0, 0, 2, 2), mode="reflect")
    y = k[0] * xp[..., 0:h, :]
    for j in range(1, 5):
        y = y + k[j] * xp[..., j:j + h, :]
    xp = F.pad(y, (2, 2, 0, 0), mode="reflect")
    y = k[0] * xp[..., 0:w]
    for j in range(1, 5):
        y = y + k[j] * xp[..., j:j + w]
    return y


def photometric_reference(frames: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """The kernel's function in eager fp32 PyTorch. frames: (B, T, H, W, 3)
    uint8 or float 0..255; params: (B, 16). Returns (B, T, H, W, 3) bf16."""
    bsz = frames.shape[0]
    p = params.float()

    def col(i):
        return p[:, i].view(bsz, 1, 1, 1)

    def on(i):
        return (p[:, i] > 0.5).view(bsz, 1, 1, 1)

    x = frames.float() / 255.0
    x = torch.where(on(14)[..., None], x.flip(3), x)
    r, g, b = x.unbind(-1)

    hr, hg, hb = _hue_shift(r, g, b, col(1))
    r, g, b = (torch.where(on(0), n, o) for n, o in ((hr, r), (hg, g), (hb, b)))

    def gray():
        return 0.299 * r + 0.587 * g + 0.114 * b

    sat = torch.where(on(2), col(3), 1.0)
    gy = gray()
    r, g, b = ((sat * c + (1.0 - sat) * gy).clamp(0.0, 1.0) for c in (r, g, b))
    bri = torch.where(on(4), col(5), 1.0)
    r, g, b = ((c * bri).clamp(0.0, 1.0) for c in (r, g, b))
    con = torch.where(on(6), col(7), 1.0)
    mean = gray().mean(dim=(2, 3), keepdim=True)
    r, g, b = ((con * c + (1.0 - con) * mean).clamp(0.0, 1.0) for c in (r, g, b))

    taps = p[:, 9:14]
    r, g, b = (torch.where(on(8), _blur_reflect(c, taps), c) for c in (r, g, b))
    out = [(c - m) / s for c, m, s in zip((r, g, b), _MEAN, _STD)]
    return torch.stack(out, dim=-1).to(torch.bfloat16)


def _check(frames: torch.Tensor, params: torch.Tensor) -> None:
    if frames.ndim != 5 or frames.shape[-1] != 3:
        raise ValueError(f"frames must be (B, T, H, W, 3), got {tuple(frames.shape)}")
    if frames.dtype not in (torch.uint8, torch.bfloat16):
        raise TypeError(f"frames must be uint8 or bfloat16, got {frames.dtype}")
    bsz, t, h, w, _ = frames.shape
    if params.shape != (bsz, N_PARAMS) or params.dtype != torch.float32:
        raise ValueError(
            f"params must be ({bsz}, {N_PARAMS}) float32, got "
            f"{tuple(params.shape)} {params.dtype}"
        )
    if params.device != frames.device:
        raise ValueError(f"params on {params.device}, frames on {frames.device}")
    if not (frames.is_contiguous() and params.is_contiguous()):
        raise ValueError("frames and params must be contiguous")
    if h < 3 or w < 3:
        raise ValueError(f"frames must be at least 3x3 for the blur, got {h}x{w}")
    if bsz * t > MAX_FRAMES:
        raise ValueError(f"B*T = {bsz * t} frames exceeds {MAX_FRAMES}")


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def _rows_bytes(n: int, px: int, in_bytes: int, per_row: bool) -> int:
    """n rows of px pixels: one range with 16 bytes for a misaligned head,
    or (per_row) a 16-byte slot a row with room for its own head."""
    if per_row:
        return n * _up16(3 * px * in_bytes + 16)
    return _up16(3 * n * px * in_bytes + 16)


def photometric_smem(seg_w: int, in_bytes: int, chunk: int, segmented: bool) -> int:
    """Dynamic shared memory of one block (csrc/photometric.cu:
    photometric_smem, which refuses a smaller figure): a header, a ring of
    chunk + 4 fp32 rows for the blur, two input stages of chunk + 4 rows
    and an output tile of chunk bf16 rows, each row ``seg_w`` pixels (the
    frame's width with one segment). With one segment the rows of a stage
    or the tile are one range with 16 bytes for a misaligned head;
    ``segmented``, each row has a slot of its own and an input row holds the
    blur's 2 + 2 halo columns too."""
    rows = chunk + 2 * HALO
    halo = 2 * HALO if segmented else 0
    return (SMEM_HEADER + _up16(4 * rows * 3 * seg_w)
            + 2 * _rows_bytes(rows, seg_w + halo, in_bytes, segmented)
            + _rows_bytes(chunk, seg_w, 2, segmented))


@dataclass(frozen=True)
class PhotometricPlan:
    """How the photometric kernel covers an (H, W) frame: a cluster of
    ``bands`` x ``segments`` CTAs per frame; CTA r takes the band of rows
    [b * rows, min(H, (b + 1) * rows)) with b = r // segments, across the
    columns [s * seg_w, min(W, (s + 1) * seg_w)) with s = r % segments,
    in chunks of ``chunk`` rows."""

    h: int
    w: int
    bands: int
    rows: int
    segments: int
    seg_w: int  # columns of a segment, the last one's at most; W with one
    chunk: int
    smem_bytes: int

    @property
    def cluster(self) -> int:
        """CTAs of a frame's cluster."""
        return self.bands * self.segments


def max_width(in_dtype: torch.dtype) -> int:
    """The widest frame photometric_plan takes: MAX_CLUSTER segments, each
    as wide as a one-row chunk's layout fits in a block's 227 KB."""
    in_bytes = _IN_BYTES[in_dtype]
    seg_w = 1
    while photometric_smem(seg_w + 1, in_bytes, 1, True) <= BLOCK_SHARED_MAX:
        seg_w += 1
    return MAX_CLUSTER * seg_w


def photometric_plan(h: int, w: int, in_dtype: torch.dtype) -> PhotometricPlan:
    """The photometric kernel's launch for (H, W) frames of ``in_dtype``:
    one column segment, the whole width, when a one-row chunk of it fits a
    block's 227 KB (up to 1,843 bf16 or 2,419 uint8 pixels wide), else the
    fewest segments, cut evenly, that fit; then bands of at most BAND_ROWS
    rows, cut evenly, as many as the cluster's MAX_CLUSTER CTAs leave room
    for (longer bands beyond 448 rows, or beyond fewer rows when segments
    take some of the 8), none empty; then the largest chunk (at most
    MAX_CHUNK rows, at most the band) whose shared memory lets the most
    blocks share an SM. Raises ValueError beyond ``max_width`` (14,712
    bf16 or 19,328 uint8 pixels). The grid is one cluster per frame, so the
    plan does not depend on the card's SM count."""
    if h < 3 or w < 3:
        raise ValueError(f"frames must be at least 3x3 for the blur, got {h}x{w}")
    in_bytes = _IN_BYTES[in_dtype]
    for segments in range(1, MAX_CLUSTER + 1):
        seg_w = -(-w // segments)
        if photometric_smem(seg_w, in_bytes, 1, segments > 1) <= BLOCK_SHARED_MAX:
            break
    else:
        raise ValueError(
            f"frames {w} pixels wide exceed the photometric kernel's widest, "
            f"{max_width(in_dtype)} pixels of {in_dtype}: {MAX_CLUSTER} column segments "
            f"of a block's {BLOCK_SHARED_MAX} bytes of shared memory")
    segments = -(-w // seg_w)  # no empty segment
    segmented = segments > 1
    bands = min(MAX_CLUSTER // segments, -(-h // BAND_ROWS))
    rows = -(-h // bands)
    bands = -(-h // rows)  # no empty band
    chunks = range(min(MAX_CHUNK, rows), 0, -1)
    for blocks in BLOCKS_PER_SM:  # the last, one block, takes a one-row chunk
        budget = BLOCK_SHARED_MAX // blocks - (1024 if blocks > 1 else 0)
        chunk = next((c for c in chunks
                      if photometric_smem(seg_w, in_bytes, c, segmented) <= budget), 0)
        if chunk:
            break
    return PhotometricPlan(h, w, bands, rows, segments, seg_w, chunk,
                           photometric_smem(seg_w, in_bytes, chunk, segmented))


@functools.lru_cache(maxsize=None)
def _kernel():
    from tdeed_tpu_torch.kernels.build import load

    built = load("photometric")
    fn = built.lib.tdeed_photometric
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [ptr, i32, ptr, ptr, i32, i32, i32, i32, i32, i32, i32, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn


def photometric(frames: torch.Tensor, params: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fused photometric augmentation, (B, T, H, W, 3) uint8 or bf16 0..255
    -> standardized (B, T, H, W, 3) bf16, written into ``out`` when given
    (a contiguous bf16 tensor of the frames' shape on their device).

    A CUDA tensor launches the kernel on the current stream, one launch
    laid out by ``photometric_plan``, allocating nothing but its output
    (it raises on any launch error; two calls give the same bits); a CPU
    tensor runs ``photometric_reference``. ``photometric.launches`` counts
    kernel launches."""
    if out is not None and (out.shape != frames.shape or out.dtype != torch.bfloat16
                            or out.device != frames.device or not out.is_contiguous()):
        raise ValueError(f"out must be contiguous bf16 {tuple(frames.shape)} on "
                         f"{frames.device}, got {out.dtype} {tuple(out.shape)} on {out.device}")
    if frames.device.type == "cpu":
        y = photometric_reference(frames, params)
        return y if out is None else out.copy_(y)
    if frames.device.type != "cuda":
        raise ValueError(f"photometric runs on cuda or cpu, not {frames.device}")
    _check(frames, params)
    bsz, t, h, w, _ = frames.shape
    plan = photometric_plan(h, w, frames.dtype)
    fn = _kernel()
    if out is None:
        out = torch.empty(frames.shape, dtype=torch.bfloat16, device=frames.device)
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(
            frames.data_ptr(), 0 if frames.dtype == torch.uint8 else 1,
            params.data_ptr(), out.data_ptr(), bsz, t, h, w,
            plan.bands, plan.rows, plan.segments, plan.seg_w, plan.chunk, plan.smem_bytes,
            stream,
        )
    if err != 0:
        raise RuntimeError(f"photometric kernel launch failed: CUDA error {err}")
    photometric.launches += 1
    return out


photometric.launches = 0


def _staged(frames: torch.Tensor) -> torch.Tensor:
    """uint8 frames as they are; the float mixup blend rounded to bf16."""
    return frames if frames.dtype == torch.uint8 else frames.to(torch.bfloat16)


def train_preprocess(frames: torch.Tensor, params: torch.Tensor,
                     out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The training step's augmentation (the JAX package's
    train_preprocess_pallas after its crop): frames (B, T, H, W, 3) uint8,
    or the float mixup blend 0..255, which is staged as bf16; params
    (B, 16) from sample_params with the flip gate in slot 14. Returns
    standardized bf16 (B, T, H, W, 3), in ``out`` when given.
    ``photometric``: the kernel on a CUDA tensor, the plain chain on a
    CPU one."""
    frames = _staged(frames).contiguous()
    params = params.to(frames.device).contiguous()
    return photometric(frames, params) if out is None else photometric(frames, params, out)


def train_preprocess_plain(frames: torch.Tensor, params: torch.Tensor) -> torch.Tensor:
    """train_preprocess through the plain chain on any device, the kernel
    never launched (the config's ``pallas_augment: false``): the same bf16
    staging of the blend, then ``photometric_reference``."""
    frames = _staged(frames)
    return photometric_reference(frames, params.to(frames.device))
