"""Plain float32 training steps of T-DEED: the benchmark's reference for
the training cells.

One step, as the published training loop defines it (T-DEED
model/model.py:193-332, train_tdeed.py:79-87): one random crop offset for
the batch, a per-clip mixup blend with Beta(0.2, 0.2) weights and soft
labels, the photometric augmentation (hue, saturation, brightness,
contrast, Gaussian blur, horizontal flip), ImageNet standardisation, the
model, the foreground-weighted soft cross-entropy (weight 5 on events;
with two heads each clip takes its own head's) plus the displacement
MSE, the backward pass and AdamW (betas 0.9/0.999, eps 1e-8, decay 0.01)
under the chained linear-warm-up and cosine schedule.

Every random value is an input (``Draws``), so the program under test and
this reference take the same ones.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import model as M

FG_WEIGHT = 5.0
BETAS = (0.9, 0.999)
EPS = 1e-8
WEIGHT_DECAY = 0.01


@dataclass
class Draws:
    """The random values of one step over a batch of B clips."""

    crop: Optional[Tuple[int, int]]  # batch-wide crop offset (i, j)
    lam: Optional[torch.Tensor]  # (B,) mixup weights
    aug: torch.Tensor  # (B, 16): gates and factors, see photometric()
    keep: Dict[str, torch.Tensor]  # head name -> (B, T, D) bool dropout keep mask


def draw(generator: torch.Generator, b: int, t: int, hw: Tuple[int, int], crop: Optional[int],
         mixup: bool, feat_dim: int, heads: Sequence[str]) -> Draws:
    """One step's random values from ``generator`` (on the host): a crop
    offset uniform over the valid positions, Beta(0.2, 0.2) mixup weights,
    the augmentation's gates (p 0.25, the flip 0.5) and factors (hue
    U(-0.2, 0.2); saturation, brightness, contrast U(0.7, 1.2); blur sigma
    U(0.1, 2)) and the heads' dropout masks (p 0.5)."""
    off = None
    if crop is not None:
        off = (int(torch.randint(0, hw[0] - crop + 1, (), generator=generator)),
               int(torch.randint(0, hw[1] - crop + 1, (), generator=generator)))
    lam = None
    if mixup:
        rng = np.random.default_rng(int(torch.randint(0, 2**62, (), generator=generator)))
        lam = torch.from_numpy(rng.beta(0.2, 0.2, size=b).astype(np.float32))
    r = torch.rand(16, b, generator=generator)
    aug = torch.zeros(b, 16)
    for i in (0, 2, 4, 6, 8):
        aug[:, i] = (r[i] < 0.25).float()
    aug[:, 1] = -0.2 + 0.4 * r[1]
    for i in (3, 5, 7):
        aug[:, i] = 0.7 + 0.5 * r[i]
    sigma = 0.1 + 1.9 * r[9]
    offs = torch.arange(-2, 3, dtype=torch.float32)
    taps = torch.exp(-0.5 * (offs[None, :] / sigma[:, None]).square())
    aug[:, 9:14] = taps / taps.sum(1, keepdim=True)
    aug[:, 14] = (r[14] < 0.5).float()
    keep = {h: torch.rand(b, t, feat_dim, generator=generator) >= M.DROPOUT for h in heads}
    return Draws(off, lam, aug, keep)


def crop(frames, offset, size):
    if size is None:
        return frames
    i, j = offset
    return frames[:, :, i:i + size, j:j + size, :]


def _hsv_hue(r, g, b, shift):
    """Shift the hue of an RGB image in [0, 1] by ``shift`` turns
    (torchvision's adjust_hue)."""
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    cr = maxc - minc
    s = cr / torch.where(maxc > 0, maxc, torch.ones_like(maxc))
    crd = torch.where(cr > 0, cr, torch.ones_like(cr))
    rc, gc, bc = (maxc - r) / crd, (maxc - g) / crd, (maxc - b) / crd
    h = torch.where(maxc == r, bc - gc, torch.where(maxc == g, 2.0 + rc - bc, 4.0 + gc - rc))
    h = torch.where(cr > 0, h, torch.zeros_like(h))
    h = torch.remainder(torch.remainder(h / 6.0, 1.0) + shift, 1.0)
    i = torch.floor(h * 6.0)
    f = h * 6.0 - i
    i = i.long() % 6
    p = v * (1.0 - s)
    q = v * (1.0 - s * f)
    t = v * (1.0 - s * (1.0 - f))
    sel = [(v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)]
    out = []
    for ch in range(3):
        o = sel[5][ch]
        for k in range(4, -1, -1):
            o = torch.where(i == k, sel[k][ch], o)
        out.append(o)
    return out


def _blur(c, taps):
    """Separable 5-tap blur of (B, T, H, W), reflect padding of 2."""
    h, w = c.shape[-2:]
    x = F.pad(c, (0, 0, 2, 2), mode="reflect")
    y = sum(taps[:, k].view(-1, 1, 1, 1) * x[..., k:k + h, :] for k in range(5))
    x = F.pad(y, (2, 2, 0, 0), mode="reflect")
    return sum(taps[:, k].view(-1, 1, 1, 1) * x[..., k:k + w] for k in range(5))


def photometric(frames, aug):
    """Frames 0..255 (B, T, H, W, 3) -> augmented, standardised float32.
    ``aug`` columns: 0/1 hue gate and shift, 2/3 saturation, 4/5
    brightness, 6/7 contrast, 8 blur gate, 9..13 blur taps, 14 flip gate;
    a gate is on above 0.5."""
    bsz = frames.shape[0]

    def col(i):
        return aug[:, i].view(bsz, 1, 1, 1)

    def on(i):
        return (aug[:, i] > 0.5).view(bsz, 1, 1, 1)

    x = frames.to(aug.dtype) / 255.0
    x = torch.where(on(14)[..., None], x.flip(3), x)
    r, g, b = x.unbind(-1)
    hr, hg, hb = _hsv_hue(r, g, b, col(1))
    r, g, b = (torch.where(on(0), n, o) for n, o in ((hr, r), (hg, g), (hb, b)))
    gray = 0.299 * r + 0.587 * g + 0.114 * b
    sat = torch.where(on(2), col(3), torch.ones_like(col(3)))
    r, g, b = ((sat * c + (1 - sat) * gray).clamp(0, 1) for c in (r, g, b))
    bri = torch.where(on(4), col(5), torch.ones_like(col(5)))
    r, g, b = ((c * bri).clamp(0, 1) for c in (r, g, b))
    con = torch.where(on(6), col(7), torch.ones_like(col(7)))
    mean = (0.299 * r + 0.587 * g + 0.114 * b).mean((2, 3), keepdim=True)
    r, g, b = ((con * c + (1 - con) * mean).clamp(0, 1) for c in (r, g, b))
    taps = aug[:, 9:14]
    r, g, b = (torch.where(on(8), _blur(c, taps), c) for c in (r, g, b))
    return M.standardize(torch.stack([r, g, b], dim=-1))


def class_weights(n: int, device, dtype=torch.float32) -> torch.Tensor:
    w = torch.full((n,), FG_WEIGHT, device=device, dtype=dtype)
    w[0] = 1.0
    return w


def loss_of(P, spec: M.Spec, batch: Dict[str, torch.Tensor], d: Draws, crop_dim: Optional[int],
            mixup: bool, quant: M.Quant = None, checkpoint: bool = False,
            outputs: Optional[list] = None) -> torch.Tensor:
    """The train-mode loss of one batch (tensors on the device); the
    model's logits and displacements are appended to ``outputs``."""
    dev, dt = batch["frame"].device, P["temp_enc"].dtype
    frames = crop(batch["frame"].to(dt), d.crop, crop_dim)
    label = batch["label"].long()
    two = spec.two_heads
    ds = batch.get("dataset")
    c1 = spec.num_classes + 1
    n_cls = sum(two) if two else c1
    if two and ds is not None:
        label = torch.where(ds[:, None] == 2, label + c1, label)
    soft = F.one_hot(label, n_cls).to(dt)
    label_d = batch.get("labelD")
    if mixup:
        lam = d.lam.to(dev, dt)
        frames2 = crop(batch["frame2"].to(dt), d.crop, crop_dim)
        l5 = lam.view(-1, 1, 1, 1, 1)
        frames = l5 * frames + (1 - l5) * frames2
        label2 = batch["label2"].long()
        if two and ds is not None:
            label2 = torch.where(ds[:, None] == 2, label2 + c1, label2)
        lt = lam[:, None, None]
        soft = soft * lt + F.one_hot(label2, n_cls).to(dt) * (1 - lt)
        if label_d is not None:
            label_d = lam[:, None] * label_d + (1 - lam[:, None]) * batch["labelD2"]
    with torch.no_grad():  # the inputs' chain: nothing in it is trained
        x = photometric(frames, d.aug.to(dev, dt))
    keep = {k: v.to(dev) for k, v in d.keep.items()}
    logits, displ = M.forward(P, spec, x, M.State(train=True, quant=quant), keep, checkpoint)
    if outputs is not None:
        outputs.append((logits.detach(), None if displ is None else displ.detach()))
    if two and ds is not None:
        def per_clip(lg, tg, w):
            if mixup:
                return (-(w * tg * torch.log_softmax(lg, -1)).sum(-1)).mean(1)
            wy = (w * tg).sum(-1)  # hard labels: each clip's class-weighted mean
            return (-(wy * (tg * torch.log_softmax(lg, -1)).sum(-1))).sum(1) / wy.sum(1).clamp_min(1e-12)

        l1 = per_clip(logits[..., :c1], soft[..., :c1], class_weights(c1, dev, dt))
        l2 = per_clip(logits[..., c1:], soft[..., c1:], class_weights(two[1], dev, dt))
        loss = torch.where(ds == 1, l1, l2).sum() / logits.shape[0]
    elif mixup:
        w = class_weights(n_cls, dev, dt)
        loss = (-(w * soft * torch.log_softmax(logits, -1)).sum(-1)).mean()
    else:  # hard labels: the class-weighted mean
        w = class_weights(n_cls, dev, dt)[label]
        nll = -torch.log_softmax(logits, -1).gather(-1, label[..., None])[..., 0]
        loss = (w * nll).sum() / w.sum()
    if spec.radi_displacement > 0 and label_d is not None:
        loss = loss + (displ - label_d.to(dt)).square().mean()
    return loss


def learning_rate(base: float, warmup_steps: int, cosine_steps: int, t: int) -> float:
    """lr of optimizer step t (from 0): linear warm-up from 1% times a
    cosine decay, the two published schedulers chained."""
    w, c = max(1, warmup_steps), max(1, cosine_steps)
    return base * (0.01 + 0.99 * min(t, w) / w) * 0.5 * (1 + math.cos(math.pi * t / c))


def adamw(P: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor], m, v, t: int, lr: float):
    """One AdamW update of the trainable tensors, in place (t from 1)."""
    b1, b2 = BETAS
    with torch.no_grad():
        for n, g in grads.items():
            p = P[n]
            p.mul_(1 - lr * WEIGHT_DECAY)
            m[n].mul_(b1).add_(g, alpha=1 - b1)
            v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
            denom = (v[n].sqrt() / math.sqrt(1 - b2 ** t)).add_(EPS)
            p.addcdiv_(m[n], denom, value=-lr / (1 - b1 ** t))


@dataclass
class Trajectory:
    """What the comparison reads from the first steps of training."""

    losses: List[float]
    grad: Dict[str, torch.Tensor]  # the first step's gradient, by tensor
    change: Dict[str, torch.Tensor]  # the tensors' change over the steps
    outputs: Tuple[torch.Tensor, Optional[torch.Tensor]]  # the first step's logits, displacements


def train(P0: Dict[str, torch.Tensor], spec: M.Spec, batches: Sequence[Dict[str, torch.Tensor]],
          draws: Sequence[Draws], *, crop_dim, mixup: bool, lr: float, warmup_steps: int,
          cosine_steps: int, quant: M.Quant = None, checkpoint: bool = False) -> Trajectory:
    """Train a copy of ``P0`` one step on each of ``batches`` with its
    ``draws``; the losses, the first gradient and the change of each
    trainable tensor, and the first step's outputs."""
    names = M.param_names(P0)
    P = {n: t.detach().clone() for n, t in P0.items()}
    m = {n: torch.zeros_like(P[n]) for n in names}
    v = {n: torch.zeros_like(P[n]) for n in names}
    losses, first, outputs = [], None, []
    for t, (batch, d) in enumerate(zip(batches, draws)):
        for n in names:
            P[n].requires_grad_(True)
        loss = loss_of(P, spec, batch, d, crop_dim, mixup, quant, checkpoint,
                       outputs if t == 0 else None)
        grads = torch.autograd.grad(loss, [P[n] for n in names], allow_unused=True)
        grads = {n: torch.zeros_like(P[n]) if g is None else g for n, g in zip(names, grads)}
        for n in names:
            P[n] = P[n].detach()
        if first is None:
            first = {n: g.clone() for n, g in grads.items()}
        losses.append(float(loss.detach()))
        adamw(P, grads, m, v, t + 1, learning_rate(lr, warmup_steps, cosine_steps, t))
    return Trajectory(losses, first, {n: P[n] - P0[n] for n in names}, outputs[0])
