"""Plain T-DEED in float32 PyTorch: the benchmark's reference model.

Written from the T-DEED paper (arXiv 2404.05392) and its published code
(github.com/arturxe2/T-DEED, model/model.py, model/modules.py,
model/shift.py, model/impl/gsf.py): a RegNet-Y trunk (timm's
regnety_002/008 widths) with Gate-Shift-Fuse in every block of stages 3
and 4, an additive temporal embedding, the SGP encoder-decoder with
SGP-Mixer fusion, and the class and displacement heads.

The model is a function of a dict of tensors. The keys are the published
state_dict's names, so one dict of weights, made by the benchmark from its
seed, loads into the program under test as it is. No kernel, cache or
batching trick: plain ``torch`` and ``torch.nn.functional`` calls.
Departures from the published code, each without effect on the numbers
compared: BatchNorm's running statistics are not updated in training (the
compared numbers are all train-mode ones), and ``checkpoint`` recomputes
trunk blocks in the backward pass so that a full-frame batch fits.

``quant``, when given, rounds the input, the weight and the output of
every convolution and linear layer and the output of every normalisation:
the benchmark's control computes in a lower precision through it
(``fp8``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint as _checkpoint

# timm's RegNet-Y generation parameters (regnety_002, regnety_008)
ARCHS = {
    "rny002": dict(w0=24, wa=36.44, wm=2.49, depth=13, group_size=8),
    "rny008": dict(w0=56, wa=38.84, wm=2.4, depth=14, group_size=16),
}
STEM = 32
SE_RATIO = 0.25
BN_EPS = 1e-5
LN_EPS = 1e-5
DROPOUT = 0.5
# The scale of the BatchNorm that ends each trunk block's residual branch in
# the benchmark's random weights. At 1 a random BatchNorm ResNet magnifies a
# change of its input some 40 times over the trunk (85 times to the logits),
# so that any rounding of the input reads as a different model; trained
# weights do not. timm initialises this scale to 0 (zero_init_last); 0.1
# keeps the trunk's magnification near 2 while its convolutions still get
# gradients.
LAST_GAMMA = 0.1
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def stages(arch: str) -> Tuple[List[int], List[int], List[int]]:
    """(widths, depths, groups) of the four stages: timm's RegNet rule,
    widths quantised to 8 and made divisible by the group width."""
    p = ARCHS[arch]
    cont = p["w0"] + p["wa"] * np.arange(p["depth"])
    ks = np.round(np.log(cont / p["w0"]) / np.log(p["wm"]))
    widths = (np.round(p["w0"] * np.power(p["wm"], ks) / 8) * 8).astype(int)
    ws, ds = np.unique(widths, return_counts=True)
    gs = [min(p["group_size"], int(w)) for w in ws]
    ws = [int(round(w / g) * g) for w, g in zip(ws, gs)]
    return ws, [int(d) for d in ds], gs


@dataclass(frozen=True)
class Spec:
    """The sizes a T-DEED model is built from."""

    arch: str
    clip_len: int
    n_layers: int
    sgp_ks: int
    sgp_r: float
    num_classes: int  # head 1's classes, background excluded
    radi_displacement: int
    two_heads: Optional[Tuple[int, int]] = None  # (C1+1, C2+1)

    @staticmethod
    def of(cfg: dict, two_heads=None) -> "Spec":
        """From a configuration file's keys (feature_arch rny002_gsf etc.)."""
        arch = cfg["feature_arch"].split("_")[0]
        if not cfg["feature_arch"].endswith("_gsf"):
            raise ValueError(f"the reference builds GSF trunks only, not {cfg['feature_arch']}")
        return Spec(arch, cfg["clip_len"], cfg["n_layers"], cfg["sgp_ks"], float(cfg["sgp_r"]),
                    cfg["num_classes"], cfg["radi_displacement"],
                    None if two_heads is None else tuple(two_heads))

    @property
    def feat_dim(self) -> int:
        return stages(self.arch)[0][-1]

    @property
    def n_out(self) -> int:
        return sum(self.two_heads) if self.two_heads else self.num_classes + 1


def fold_dim(channels: int) -> int:
    """Channels GSF shifts: ceil((C // 4) / 4) * 4 (model/shift.py)."""
    return math.ceil(channels // 4 / 4) * 4


def _wide_kernel(ks: int, r: float) -> int:
    up = round((ks + 1) * r)
    return up + 1 if up % 2 == 0 else up


def _blocks(spec: Spec):
    """(prefix, in_width, width, stride, groups, shifted) of every trunk block."""
    widths, depths, groups = stages(spec.arch)
    in_w = STEM
    out = []
    for si, (w, d, g) in enumerate(zip(widths, depths, groups)):
        for bi in range(d):
            out.append((f"_features.s{si + 1}.b{bi + 1}", in_w, w, 2 if bi == 0 else 1,
                        w // g, si >= 2))
            in_w = w
    return out


def shapes(spec: Spec) -> Dict[str, Tuple[Tuple[int, ...], str]]:
    """name -> (shape, init) of every tensor of the model's state, in the
    published names; init is 'fan_out', 'fan_in', 'dw', 'embed', 'one',
    'zero' or 'last'."""
    s: Dict[str, Tuple[Tuple[int, ...], str]] = {}

    def bn(p, c):
        s[p + ".weight"] = ((c,), "one")
        s[p + ".bias"] = ((c,), "zero")
        s[p + ".running_mean"] = ((c,), "zero")
        s[p + ".running_var"] = ((c,), "one")

    def convbn(p, cin, cout, k, groups=1):
        s[p + ".conv.weight"] = ((cout, cin // groups, k, k), "fan_out")
        bn(p + ".bn", cout)

    def last(p):  # the BatchNorm that ends a residual branch
        s[p + ".bn.weight"] = (s[p + ".bn.weight"][0], "last")

    convbn("_features.stem", 3, STEM, 3)
    for p, cin, w, stride, groups, shifted in _blocks(spec):
        c1 = p + ".conv1"
        if shifted:
            f = fold_dim(cin)
            g = c1 + ".gs"
            s[g + ".conv3D.weight"] = ((2, f // 2, 3, 3, 3), "fan_in")
            s[g + ".conv3D.bias"] = ((2,), "zero")
            bn(g + ".bn", f)
            for i in (1, 2):
                s[g + f".channel_conv{i}.weight"] = ((1, 2, 3, 3), "fan_in")
                s[g + f".channel_conv{i}.bias"] = ((1,), "zero")
            c1 += ".net"
        convbn(c1, cin, w, 1)
        convbn(p + ".conv2", w, w, 3, groups)
        rd = int(round(cin * SE_RATIO))
        s[p + ".se.fc1.weight"] = ((rd, w, 1, 1), "fan_out")
        s[p + ".se.fc1.bias"] = ((rd,), "zero")
        s[p + ".se.fc2.weight"] = ((w, rd, 1, 1), "fan_out")
        s[p + ".se.fc2.bias"] = ((w,), "zero")
        convbn(p + ".conv3", w, w, 1)
        last(p + ".conv3")
        if stride != 1 or cin != w:
            convbn(p + ".downsample", cin, w, 1)
    d = spec.feat_dim
    s["temp_enc"] = ((spec.clip_len, d), "embed")
    up = _wide_kernel(spec.sgp_ks, spec.sgp_r)

    def dw(p, k):
        s[p + ".weight"] = ((d, 1, k), "dw")
        s[p + ".bias"] = ((d,), "zero")

    def ffn(p):
        s[p + ".gn.weight"] = ((d,), "one")
        s[p + ".gn.bias"] = ((d,), "zero")
        s[p + ".mlp.0.weight"] = ((4 * d, d, 1), "fan_in")
        s[p + ".mlp.0.bias"] = ((4 * d,), "zero")
        s[p + ".mlp.2.weight"] = ((d, 4 * d, 1), "fan_in")
        s[p + ".mlp.2.bias"] = ((d,), "zero")

    def ln(p):
        s[p + ".weight"] = ((1, d, 1), "one")
        s[p + ".bias"] = ((1, d, 1), "zero")

    for i in range(2 * spec.n_layers + 1):
        p = f"_temp_fine._sgp.{i}"
        ln(p + ".ln")
        for name, k in (("psi", spec.sgp_ks), ("fc", 1), ("convw", spec.sgp_ks),
                        ("convkw", up), ("global_fc", 1)):
            dw(f"{p}.{name}", k)
        ffn(p)
    for i in range(spec.n_layers):
        p = f"_temp_fine._sgpMixer.{i}"
        ln(p + ".ln1")
        ln(p + ".ln2")
        for j in (1, 2):
            for name, k in (("psi", spec.sgp_ks), ("convw", spec.sgp_ks), ("convkw", up),
                            ("fc", 1), ("global_fc", 1)):
                dw(f"{p}.{name}{j}", k)
        s[p + ".concat_fc.weight"] = ((d, 6 * d, 1), "dw")
        s[p + ".concat_fc.bias"] = ((d,), "zero")
        ffn(p)
    if spec.radi_displacement > 0:
        s["_pred_displ._fc_out.weight"] = ((1, d), "fan_in")
        s["_pred_displ._fc_out.bias"] = ((1,), "zero")
    if spec.two_heads:
        for i, c in enumerate(spec.two_heads):
            s[f"_pred_fine._fc{i + 1}._fc_out.weight"] = ((c, d), "fan_in")
            s[f"_pred_fine._fc{i + 1}._fc_out.bias"] = ((c,), "zero")
    else:
        s["_pred_fine._fc_out.weight"] = ((spec.num_classes + 1, d), "fan_in")
        s["_pred_fine._fc_out.bias"] = ((spec.num_classes + 1,), "zero")
    return s


def init_weights(spec: Spec, generator: torch.Generator) -> Dict[str, torch.Tensor]:
    """Every tensor of the model's state, float32, on the generator's
    device, from one normal draw cut into leaves: N(0, 2/fan_out) for the
    trunk's convolutions, N(0, 1/fan_in) for the other dense weights,
    N(0, 0.1^2) for the SGP's depthwise kernels and N(0, 1/clip_len^2) for
    the temporal embedding (the published inits' scales); ones and zeros
    for norms and biases, and LAST_GAMMA for the BatchNorm scale that ends
    each trunk block's residual branch."""
    s = shapes(spec)
    dev = generator.device
    const = {"one": 1.0, "zero": 0.0, "last": LAST_GAMMA}
    drawn = [(n, shp, kind) for n, (shp, kind) in s.items() if kind not in const]
    total = sum(math.prod(shp) for _, shp, _ in drawn)
    flat = torch.randn(total, generator=generator, device=dev, dtype=torch.float32)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for n, shp, kind in drawn:
        k = math.prod(shp)
        rf = math.prod(shp[2:]) if len(shp) > 2 else 1
        if kind == "fan_out":
            std = math.sqrt(2.0 / (shp[0] * rf))
        elif kind == "fan_in":
            std = math.sqrt(1.0 / (shp[1] * rf))
        elif kind == "dw":
            std = 0.1
        else:  # embed
            std = 1.0 / spec.clip_len
        out[n] = (flat[at:at + k] * std).view(shp)
        at += k
    for n, (shp, kind) in s.items():
        if kind in const:
            out[n] = torch.full(shp, const[kind], device=dev)
    return {n: out[n] for n in s}


# -- layers ---------------------------------------------------------------------


def _q(quant: Quant, *xs):
    return xs if quant is None else tuple(quant(x) for x in xs)


def conv(x, w, b=None, quant: Quant = None, **kw):
    x, w = _q(quant, x, w)
    return _q(quant, {3: F.conv1d, 4: F.conv2d, 5: F.conv3d}[w.ndim](x, w, b, **kw))[0]


def linear(x, w, b, quant: Quant = None):
    x, w = _q(quant, x, w)
    return _q(quant, F.linear(x, w, b))[0]


class State:
    """What a forward pass needs besides the weights: train or eval mode
    and the control's quantiser."""

    def __init__(self, train: bool, quant: Quant = None):
        self.train = train
        self.quant = quant


def batchnorm(P, name, x, st: State):
    """BatchNorm over dim 1: the batch's mean and biased variance in
    training, the running statistics in eval."""
    w, b = P[name + ".weight"], P[name + ".bias"]
    if st.train:
        y = F.batch_norm(x, None, None, w, b, training=True, eps=BN_EPS)
    else:
        y = F.batch_norm(x, P[name + ".running_mean"], P[name + ".running_var"], w, b,
                         training=False, eps=BN_EPS)
    return _q(st.quant, y)[0]


def convbn(P, name, x, st: State, stride=1, groups=1, act=True):
    w = P[name + ".conv.weight"]
    y = conv(x, w, None, st.quant, stride=stride, padding=w.shape[-1] // 2, groups=groups)
    y = batchnorm(P, name + ".bn", y, st)
    return torch.relu(y) if act else y


def _regroup(y):
    """Each half's channel regroup (model/impl/gsf.py): (2, C/2) -> (C/2, 2)."""
    b, c = y.shape[:2]
    return y.reshape(b, 2, c // 2, *y.shape[2:]).transpose(1, 2).reshape(y.shape)


def gsf(P, name, x5, st: State):
    """Gate-Shift-Fuse on (B, C, T, H, W)."""
    c = x5.shape[1]
    xn = torch.relu(batchnorm(P, name + ".bn", x5, st))
    gate = torch.tanh(conv(xn, P[name + ".conv3D.weight"], P[name + ".conv3D.bias"], st.quant,
                           padding=1, groups=2))
    x1, x2 = x5[:, :c // 2], x5[:, c // 2:]
    y1, y2 = gate[:, 0:1] * x1, gate[:, 1:2] * x2
    r1, r2 = x1 - y1, x2 - y2
    zero = torch.zeros_like(y1[:, :, :1])
    y1 = torch.cat([y1[:, :, 1:], zero], dim=2)  # y[t] = y[t + 1]: back one frame
    y2 = torch.cat([zero, y2[:, :, :-1]], dim=2)  # y[t] = y[t - 1]: forward one frame

    def fuse(y, r, i):
        stat = torch.stack([y.mean((3, 4)), r.mean((3, 4))], dim=1)  # (B, 2, C', T)
        wmap = torch.sigmoid(conv(stat, P[f"{name}.channel_conv{i}.weight"],
                                  P[f"{name}.channel_conv{i}.bias"], st.quant, padding=1))
        wm = wmap[:, 0][..., None, None]
        return y * wm + r * (1 - wm)

    return torch.cat([_regroup(fuse(y1, r1, 1)), _regroup(fuse(y2, r2, 2))], dim=1)


def block(P, p, x, st: State, stride: int, groups: int, shifted: bool, clip_len: int):
    """RegNet-Y block; with ``shifted`` the first fold channels of conv1's
    input pass through GSF over clips of ``clip_len`` frames."""
    has_down = (p + ".downsample.conv.weight") in P
    shortcut = convbn(P, p + ".downsample", x, st, stride=stride, act=False) if has_down else x
    c1 = p + ".conv1"
    h = x
    if shifted:
        n, c, hh, ww = x.shape
        f = fold_dim(c)
        head = x[:, :f].reshape(n // clip_len, clip_len, f, hh, ww).transpose(1, 2)
        head = gsf(P, c1 + ".gs", head, st).transpose(1, 2).reshape(n, f, hh, ww)
        h = torch.cat([head, x[:, f:]], dim=1)
        c1 += ".net"
    h = convbn(P, c1, h, st)
    h = convbn(P, p + ".conv2", h, st, stride=stride, groups=groups)
    s = h.mean((2, 3), keepdim=True)
    s = torch.relu(conv(s, P[p + ".se.fc1.weight"], P[p + ".se.fc1.bias"], st.quant))
    s = torch.sigmoid(conv(s, P[p + ".se.fc2.weight"], P[p + ".se.fc2.bias"], st.quant))
    h = convbn(P, p + ".conv3", h * s, st, act=False)
    return torch.relu(h + shortcut)


def trunk(P, spec: Spec, x, st: State, checkpoint: bool = False):
    """(N, 3, H, W) -> (N, D) pooled features."""

    def run(fn, *args):
        if checkpoint and st.train and torch.is_grad_enabled():
            return _checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    x = run(lambda t: convbn(P, "_features.stem", t, st, stride=2), x)
    for p, _, _, stride, groups, shifted in _blocks(spec):
        x = run(lambda t, p=p, s=stride, g=groups, sh=shifted:
                block(P, p, t, st, s, g, sh, spec.clip_len), x)
    return x.mean((2, 3))


def layernorm_c(P, name, x, st: State):
    """LayerNorm over C of (B, C, T)."""
    mu = x.mean(1, keepdim=True)
    var = (x - mu).square().mean(1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + LN_EPS) * P[name + ".weight"] + P[name + ".bias"]
    return _q(st.quant, y)[0]


def _dw(P, name, x, st: State):
    w = P[name + ".weight"]
    return conv(x, w, P[name + ".bias"], st.quant, padding=w.shape[-1] // 2, groups=x.shape[1])


def _ffn(P, p, x, st: State):
    h = _q(st.quant, F.group_norm(x, 16, P[p + ".gn.weight"], P[p + ".gn.bias"], 1e-5))[0]
    h = F.gelu(conv(h, P[p + ".mlp.0.weight"], P[p + ".mlp.0.bias"], st.quant))
    return x + conv(h, P[p + ".mlp.2.weight"], P[p + ".mlp.2.bias"], st.quant)


def sgp_block(P, p, x, st: State):
    """SGP block on (B, C, T) (model/modules.py SGPBlock)."""
    out = layernorm_c(P, p + ".ln", x, st)
    phi = torch.relu(_dw(P, p + ".global_fc", out.mean(2, keepdim=True), st))
    out = (_dw(P, p + ".fc", out, st) * phi
           + (_dw(P, p + ".convw", out, st) + _dw(P, p + ".convkw", out, st))
           * _dw(P, p + ".psi", out, st) + out)
    return _ffn(P, p, x + out, st)


def sgp_mixer(P, p, x, z, st: State):
    """SGP-Mixer on (B, C, T): decoder state x upsampled to the skip z's length."""
    z = layernorm_c(P, p + ".ln1", z, st)
    x = layernorm_c(P, p + ".ln2", x, st)
    x = F.interpolate(x, size=z.shape[2], mode="linear", align_corners=True)
    phi1 = torch.relu(_dw(P, p + ".global_fc1", z.mean(2, keepdim=True), st))
    phi2 = torch.relu(_dw(P, p + ".global_fc2", x.mean(2, keepdim=True), st))
    out1 = (_dw(P, p + ".convw1", z, st) + _dw(P, p + ".convkw1", z, st)) * _dw(P, p + ".psi1", z, st)
    out2 = (_dw(P, p + ".convw2", x, st) + _dw(P, p + ".convkw2", x, st)) * _dw(P, p + ".psi2", x, st)
    out3 = _dw(P, p + ".fc1", z, st) * phi1
    out4 = _dw(P, p + ".fc2", x, st) * phi2
    cat = torch.cat([out1, out2, out3, out4, z, x], dim=1)
    out = F.gelu(conv(cat, P[p + ".concat_fc.weight"], P[p + ".concat_fc.bias"], st.quant))
    return _ffn(P, p, out, st)


def temporal(P, spec: Spec, x, st: State):
    """SGP U-Net on (B, C, T)."""
    n = spec.n_layers
    lens = [math.ceil(spec.clip_len / 2 ** i) for i in range(n + 1)]
    skips = []
    for i in range(n):
        x = sgp_block(P, f"_temp_fine._sgp.{i}", x, st)
        skips.append(x)
        x = F.adaptive_max_pool1d(x, lens[i + 1])
    x = sgp_block(P, f"_temp_fine._sgp.{n}", x, st)
    for i in range(n):
        j = n - 1 - i
        x = sgp_mixer(P, f"_temp_fine._sgpMixer.{j}", x, skips[j], st)
        x = sgp_block(P, f"_temp_fine._sgp.{n + i + 1}", x, st)
    return x


def _head(P, name, x, keep, st: State):
    if keep is not None:
        x = torch.where(keep, x / (1.0 - DROPOUT), torch.zeros_like(x))
    return linear(x, P[name + ".weight"], P[name + ".bias"], st.quant)


def forward(P, spec: Spec, frames, st: State, keep: Optional[Dict[str, torch.Tensor]] = None,
            checkpoint: bool = False):
    """Standardised frames (B, T, H, W, 3) -> (logits (B, T, n_out), displ
    (B, T) or None). ``keep`` maps the dropout masks (B, T, D) by head:
    'pred_fine' or 'pred_fine.fc1'/'pred_fine.fc2', and 'pred_displ'."""
    b, t, h, w, _ = frames.shape
    keep = keep or {}
    x = frames.reshape(b * t, h, w, 3).permute(0, 3, 1, 2)
    feat = trunk(P, spec, x, st, checkpoint).reshape(b, t, -1) + P["temp_enc"]
    feat = temporal(P, spec, feat.transpose(1, 2), st).transpose(1, 2)
    displ = None
    if spec.radi_displacement > 0:
        displ = _head(P, "_pred_displ._fc_out", feat, keep.get("pred_displ"), st)[..., 0]
    if spec.two_heads:
        logits = torch.cat([_head(P, "_pred_fine._fc1._fc_out", feat, keep.get("pred_fine.fc1"), st),
                            _head(P, "_pred_fine._fc2._fc_out", feat, keep.get("pred_fine.fc2"), st)],
                           dim=-1)
    else:
        logits = _head(P, "_pred_fine._fc_out", feat, keep.get("pred_fine"), st)
    return logits, displ


def standardize(x):
    """x in [0, 1], channels last -> ImageNet-standardised."""
    mean = torch.tensor(IMAGENET_MEAN, dtype=x.dtype, device=x.device)
    std = torch.tensor(IMAGENET_STD, dtype=x.dtype, device=x.device)
    return (x - mean) / std


def _fp8_round(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to a float8 format with one scale a tensor: its largest
    magnitude onto ``top``."""
    amax = x.abs().amax().clamp_min(1e-30)
    scale = top / amax
    return (x * scale).to(dtype).to(x.dtype) / scale


class _FP8(torch.autograd.Function):
    """Forward: e4m3 rounding; backward: the incoming gradient rounded to
    e5m2: the float8 training recipe's two formats."""

    @staticmethod
    def forward(ctx, x):
        return _fp8_round(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _fp8_round(g, torch.float8_e5m2, 57344.0)


def fp8(x: torch.Tensor) -> torch.Tensor:
    """The control's precision: x rounded to float8 e4m3 with one scale a
    tensor, and the gradient that flows back through it to e5m2."""
    return _FP8.apply(x)


def param_names(P: Dict[str, torch.Tensor]) -> List[str]:
    """The trainable tensors of a state dict: all but the running statistics."""
    return [n for n in P if not n.endswith((".running_mean", ".running_var"))]
