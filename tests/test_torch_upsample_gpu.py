"""The SGP-Mixer's upsample kernels (tdeed_tpu_torch/csrc/upsample.cu,
kernels/upsample.py) against ATen's ``upsample_linear1d`` on the card.
Needs a CUDA GPU and nvcc; every test skips without a card. The card's
machine has no JAX, and tests/conftest.py imports it, so run this file
there without the conftest:

    python -m pytest tests/test_torch_upsample_gpu.py -m gpu --noconftest -q

- Forward against ``F.interpolate``: fp32 within 1 ulp, bf16 equal or
  within 1 ulp, at the magnitude of the blend's terms (both blend in fp32
  and round once; the compiler may fuse the blend's multiply-add in
  another order, and two terms of opposite sign cancel).
- Backward against float64 sums of ATen's fp32 weights: within one
  rounding of the dtype at the magnitude of each element's terms, plus
  fp32's own error over its few terms; against float64 autograd of
  ``F.interpolate`` that and the weights' fp32 rounding; two runs give the
  same bits.
- The output and the gradient take the strides eager gives, for the
  mixer's channels-innermost view and for a contiguous input.
- A flagship training step launches each kernel twice a micro-batch
  (two SGP-Mixers), graphed and eager.
- A predictor exported on the card keeps ATen's operator and launches
  neither kernel.
"""

import os

import pytest
import torch
import torch.nn.functional as F

from tdeed_tpu_torch.kernels import upsample
from tdeed_tpu_torch.models import graphs
from tdeed_tpu_torch.ops import temporal

pytestmark = pytest.mark.gpu

MANTISSA = {torch.bfloat16: 7, torch.float32: 23}
# (B, C, T_in, T_out): the mixers of both cells (FineDiving batch 8,
# SoccerNet Ball batch 4; 25 -> 50 and 50 -> 100), a 3-layer config's
# 13 -> 25, and the CPU tests' lengths at odd widths
SHAPES = [(8, 368, 25, 50), (8, 368, 50, 100), (4, 368, 25, 50), (4, 368, 50, 100),
          (2, 368, 13, 25), (3, 40, 1, 7), (3, 40, 7, 7), (2, 24, 7, 100), (2, 5, 13, 25),
          (1, 3, 100, 7)]
LAYOUTS = ["mixer", "contiguous", "misaligned"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _input(shape, dtype, layout, device, seed=0):
    """(B, C, T_in): the mixer's view of a (B, T, C) tensor (channels at
    unit stride), a contiguous tensor, or the mixer's view one element off
    a 16-byte boundary."""
    b, c, t_in, _ = shape
    g = torch.Generator(device=device).manual_seed(seed)
    if layout == "contiguous":
        return torch.randn((b, c, t_in), generator=g, device=device).to(dtype)
    off = 1 if layout == "misaligned" else 0
    buf = torch.randn(b * t_in * c + off, generator=g, device=device).to(dtype)
    return buf[off:].view(b, t_in, c).transpose(1, 2)


def _ulps(got, want, dtype, mag=None):
    """|got - want| in ulps of ``dtype`` at the magnitude ``mag`` (the
    larger of the two where None), floored at the smallest normal."""
    g, w = got.double(), want.double()
    if mag is None:
        mag = torch.maximum(g.abs(), w.abs())
    mag = mag.clamp_min(torch.finfo(dtype).tiny)
    return (g - w).abs() / torch.exp2(torch.floor(torch.log2(mag)) - MANTISSA[dtype])


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_interpolate(cuda, shape, dtype, layout):
    x = _input(shape, dtype, layout, cuda)
    before = upsample.upsample_forward.launches
    got = upsample.linear_upsample(x, shape[3])
    want = F.interpolate(x, size=shape[3], mode="linear", align_corners=True)
    assert upsample.upsample_forward.launches == before + 1
    assert got.shape == want.shape and got.stride() == want.stride()
    # at the magnitude of the blend's terms: two of opposite sign cancel
    mag = F.interpolate(x.abs().float(), size=shape[3], mode="linear", align_corners=True)
    assert float(_ulps(got, want, dtype, mag).max()) <= 1.0


def _backward64(x, t_out, dy):
    x64 = x.detach().double().requires_grad_()
    y = F.interpolate(x64, size=t_out, mode="linear", align_corners=True)
    return torch.autograd.grad(y, x64, dy.double())[0]


def _weights(t_in, t_out, device):
    """(T_out, T_in) float64 matrix of ATen's fp32 weights, the ones the
    kernels use."""
    m = torch.zeros((t_out, t_in), dtype=torch.float64)
    for j, terms in enumerate(upsample.gather_pairs(t_in, t_out)):
        for i, w in terms:
            m[i, j] += w
    return m.to(device)


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", SHAPES)
def test_backward_is_within_one_rounding_of_float64(cuda, shape, dtype, layout):
    """Against float64 sums of ATen's fp32 weights: one rounding to the
    dtype at the magnitude of each element's terms, and fp32's sum of at
    most ~2 / rwidth + 3 terms. Against float64 autograd of F.interpolate,
    whose weights are float64, that and the weights' own fp32 rounding
    (2^-22 * T_in of each term's |dy|, as tests/test_torch_upsample.py
    shows; a term the fp32 source index moves to the next step counts in
    both)."""
    b, c, t_in, t_out = shape
    x = _input(shape, dtype, layout, cuda).requires_grad_()
    g = torch.Generator(device=cuda).manual_seed(1)
    dy = torch.randn((b, c, t_out), generator=g, device=cuda).to(dtype)
    if layout != "contiguous":  # a gradient at other strides
        dy = dy.transpose(1, 2).contiguous().transpose(1, 2)
    y = upsample.linear_upsample(x, t_out)
    before = upsample.upsample_backward.launches
    (dx,) = torch.autograd.grad(y, x, dy)
    assert upsample.upsample_backward.launches == before + 1
    m = _weights(t_in, t_out, cuda)
    want = dy.double() @ m
    mag = dy.double().abs() @ m.abs()  # each element's sum of |terms|
    terms = 2 * t_out / max(t_in - 1, 1) + 3
    bound = (torch.exp2(torch.floor(torch.log2(mag.clamp_min(torch.finfo(dtype).tiny)))
                        - MANTISSA[dtype]) + terms * 2.0 ** -24 * mag)
    err = (dx.double() - want).abs()
    assert bool((err <= bound).all()), float((err / bound).max())
    # a term of either matrix, its weight off by up to 2^-22 * T_in
    m64 = F.interpolate(torch.eye(t_in, dtype=torch.float64, device=cuda)[None], size=t_out,
                        mode="linear", align_corners=True)[0].t()
    support = dy.double().abs() @ ((m != 0) | (m64 != 0)).double()
    err = (dx.double() - _backward64(x, t_out, dy)).abs()
    assert bool((err <= bound + 2.0 ** -22 * t_in * support).all())
    (again,) = torch.autograd.grad(upsample.linear_upsample(x, t_out), x, dy)
    assert torch.equal(dx, again)


@pytest.mark.parametrize("layout", ["mixer", "contiguous"])
def test_output_and_gradient_take_eager_strides(cuda, layout):
    shape = (8, 368, 50, 100)
    x = _input(shape, torch.bfloat16, layout, cuda).requires_grad_()
    dy = torch.randn((8, 368, 100), device=cuda).to(torch.bfloat16)
    y = upsample.linear_upsample(x, 100)
    want = F.interpolate(x, size=100, mode="linear", align_corners=True)
    assert y.stride() == want.stride() == (368 * 100, 100, 1)
    (dx,) = torch.autograd.grad(y, x, dy)
    (dx_eager,) = torch.autograd.grad(want, x, dy)
    assert dx.stride() == dx_eager.stride()
    assert dx.shape == x.shape


def test_the_call_site_runs_the_kernels_on_the_card_only(cuda):
    x = torch.randn(2, 25, 368, device=cuda, dtype=torch.bfloat16)
    before = upsample.upsample_forward.launches
    got = temporal.linear_upsample(x, 50)
    assert upsample.upsample_forward.launches == before + 1
    want = F.interpolate(x.transpose(1, 2), size=50, mode="linear",
                         align_corners=True).transpose(1, 2)
    mag = F.interpolate(x.transpose(1, 2).abs().float(), size=50, mode="linear",
                        align_corners=True).transpose(1, 2)
    assert float(_ulps(got, want, torch.bfloat16, mag).max()) <= 1.0
    temporal.linear_upsample(x.cpu(), 50)
    assert upsample.upsample_forward.launches == before + 1


def test_kernels_refuse_other_dtypes(cuda):
    before = (upsample.upsample_forward.launches, upsample.upsample_backward.launches)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        upsample.upsample_forward(torch.randn(2, 3, 5, device=cuda, dtype=torch.float64), 9)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        upsample.upsample_backward(torch.randn(2, 3, 9, device=cuda, dtype=torch.float16), 5)
    assert (upsample.upsample_forward.launches,
            upsample.upsample_backward.launches) == before


@pytest.mark.parametrize("eager", [False, True], ids=["graphed", "eager"])
@pytest.mark.parametrize("acc", [1, 2])
def test_flagship_step_launches_each_kernel_twice_a_micro_batch(cuda, monkeypatch, acc, eager):
    """FineDiving_small (two SGP-Mixers) at its batch and clip: 2 forward
    and 2 backward launches a micro-batch, replayed from the graphs (a
    replay counts what its capture recorded) or run eagerly."""
    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step
    from tdeed_tpu_torch.utils import profiling

    if eager:
        monkeypatch.setattr(graphs, "MAX_KEYS", 0)
    ring = profiling.StepRecorder()
    monkeypatch.setattr(profiling, "STEPS", ring)
    root = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
    cfg = load_config("FineDiving_small", config_root=root)
    torch.manual_seed(0)
    model = build_model(cfg, device="cuda")
    opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, 100, 10_000)
    step = make_train_step(model, opt, sched, crop_dim=cfg.crop_dim,
                           num_classes_bg=cfg.num_classes_bg, mixup=cfg.mixup,
                           radi_displacement=cfg.radi_displacement, acc_grad_iter=acc)
    g = torch.Generator(device=cuda).manual_seed(0)
    shape = (cfg.batch_size, cfg.clip_len, 256, 256, 3)
    batch = {k: torch.randint(0, 256, shape, generator=g, device=cuda, dtype=torch.uint8)
             for k in ("frame", "frame2")}
    batch.update({k: torch.randint(0, cfg.num_classes_bg, shape[:2], generator=g, device=cuda)
                  for k in ("label", "label2")})
    fns = (upsample.upsample_forward, upsample.upsample_backward)
    for _ in range(2):  # the first graphed step captures
        before = [f.launches for f in fns]
        assert torch.isfinite(step(batch)["loss"])
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(fns, before)] == [2 * acc, 2 * acc]
    graphed = [r.graph_layers > 0 for r in ring.records]
    assert graphed == [not eager] * 2


def test_a_predictor_exported_on_the_card_keeps_aten_upsample(cuda, tmp_path):
    from tdeed_tpu_torch.config import TDEEDConfig
    from tdeed_tpu_torch.infer.export import export_predictor
    from tdeed_tpu_torch.models.tdeed import build_model

    cfg = TDEEDConfig(dataset="finediving", num_classes=4, clip_len=16, crop_dim=64,
                      feature_arch="rny002_gsf", n_layers=2, sgp_ks=7, sgp_r=4,
                      radi_displacement=2, dtype="bfloat16")
    torch.manual_seed(0)
    model = build_model(cfg, device="cuda")
    classes = {f"class{i}": i for i in range(1, cfg.num_classes + 1)}
    before = (upsample.upsample_forward.launches, upsample.upsample_backward.launches)
    out = str(tmp_path / "artifact")
    export_predictor(cfg, model.state_dict(), classes, out, batch_size=2, frame_hw=(72, 72),
                     device="cuda")
    assert (upsample.upsample_forward.launches,
            upsample.upsample_backward.launches) == before
    programs = [f for f in os.listdir(out) if f.endswith(".pt2")]
    assert programs
    for name in programs:
        program = torch.export.load(os.path.join(out, name))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert sum("upsample_linear1d" in t for t in targets) == 2, targets
        assert not any("tdeed" in t or "ctypes" in t for t in targets)
