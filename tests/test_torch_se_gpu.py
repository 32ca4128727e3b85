"""The squeeze-and-excitation kernels (tdeed_tpu_torch/csrc/se.cu,
kernels/se.py) on the card. Needs a CUDA GPU and nvcc; every test skips
without a card. The card's machine has no JAX, and tests/conftest.py
imports it, so run this file there without the conftest:

    python -m pytest tests/test_torch_se_gpu.py -m gpu --noconftest -q

- Each kernel at every block shape of the three benchmark cells (bf16) and
  at odd widths, addresses and sizes (bf16 and fp32) against float64: the
  gated product bit for bit ATen's, the gate's gradient within fp32's sum
  error, x's gradient within one rounding of the dtype; two runs give the
  same bits.
- ``SEModule`` on the card, through the kernels: y bit for bit the stock
  ops', and against its float64 stock ops the gradients of x, fc1 and fc2
  no farther than the same stock ops in bf16 on the card.
- A training step launches each kernel once a block a micro-batch (13
  blocks on rny002, 14 on rny008), graphed and eager.
- A predictor exported on the card holds ATen's mean and sigmoid, launches
  no kernel, and loads and runs where the package cannot be imported; the
  eager predictor, through the excite kernel, gives its probabilities
  within 1e-3 (chip_smoke.py's phase 9c bound).
"""

import os
import subprocess
import sys

import pytest
import torch

from tdeed_tpu_torch.kernels import se
from tdeed_tpu_torch.models import graphs
from tdeed_tpu_torch.models.regnet import SEModule

pytestmark = pytest.mark.gpu

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANTISSA = {torch.bfloat16: 7, torch.float32: 23}
# (N, H, W, C) of every block's SE in the three cells: FineDiving_small
# (800 frames of 224 crops, rny002), SoccerNetBall_challenge1 (400 full
# 448x796 frames, rny002) and SoccerNetBall_challenge2 (200, rny008)
CELLS = [(800, 56, 56, 24), (800, 28, 28, 56), (800, 14, 14, 152), (800, 7, 7, 368),
         (400, 112, 199, 24), (400, 56, 100, 56), (400, 28, 50, 152), (400, 14, 25, 368),
         (200, 112, 199, 64), (200, 56, 100, 128), (200, 28, 50, 320), (200, 14, 25, 768)]
# odd widths (2- and 4-byte accesses), a 1x1 map, samples packed into a
# block, a large map over few samples at one block's width
ODD = [(5, 7, 7, 6), (3, 1, 1, 40), (9, 2, 2, 24), (4, 3, 5, 12), (2, 700, 100, 8)]
STEPS = [("FineDiving_small", 1, 13), ("FineDiving_small", 2, 13), ("FineDiving_big", 1, 14)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return torch.device("cuda")


def _slab(shape, dtype, device, seed, offset=0, scale=1.0, shift=0.0):
    """(N, C, H, W) in dense channels_last memory, ``offset`` elements past
    the start of its buffer."""
    n, h, w, c = shape
    g = torch.Generator(device=device).manual_seed(seed)
    buf = torch.randn(n * h * w * c + offset, generator=g, device=device) * scale + shift
    return buf.to(dtype)[offset:].view(n, h, w, c).permute(0, 3, 1, 2)


def _ulp(v, dtype):
    mag = v.abs().clamp_min(torch.finfo(dtype).tiny)
    return torch.exp2(torch.floor(torch.log2(mag)) - MANTISSA[dtype])


def _sum_error(plan, hw):
    """Terms of fp32 rounding in a sum: a thread's row steps, a block's row
    groups, one more for the product."""
    return -(-hw // plan.rows) + plan.rows + 1


def _plan(x):
    """The wrapper's plan for x, its accesses as wide as x's address allows."""
    n, c, h, w = x.shape
    bits = x.data_ptr() | 16
    return se.se_plan(n, h * w, c, x.element_size(), bits & -bits)


def _check_kernels(shape, dtype, device, offset=0):
    n, h, w, c = shape
    x = _slab(shape, dtype, device, 0, offset, scale=1.5, shift=0.3)
    g = _slab(shape, dtype, device, 1, offset)
    gen = torch.Generator(device=device).manual_seed(2)
    s = torch.rand((n, c), generator=gen, device=device).to(dtype)
    dm = torch.randn((n, c), generator=gen, device=device).to(dtype)
    plan = _plan(x)
    terms = _sum_error(plan, h * w)
    counts = [f.launches for f in (se.se_excite, se.se_grad_sums, se.se_grad_apply)]

    y = se.se_excite(x, s)
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, x * s[:, :, None, None]), "the product is not ATen's"

    sums = se.se_grad_sums(g, x)
    assert sums.dtype == torch.float32
    x64 = x.double()
    gx = g.double() * x64
    bound = terms * 2.0 ** -24 * gx.abs().sum((2, 3)) + 1e-30
    assert bool(((sums.double() - gx.sum((2, 3))).abs() <= bound).all()), "the gate's sums"
    del gx

    dx = se.se_grad_apply(g, s, dm)
    assert dx.is_contiguous(memory_format=torch.channels_last)
    part = dm.double()[:, :, None, None] / (h * w)
    want = g.double() * s.double()[:, :, None, None] + part
    bound = (0.5 * _ulp(want, dtype) + 2.0 ** -23 * want.abs()
             + 2.0 ** -24 * part.abs() + 1e-30)
    assert bool(((dx.double() - want).abs() <= bound).all()), "x's gradient"
    del want, part, x64

    assert torch.equal(y, se.se_excite(x, s)) and torch.equal(sums, se.se_grad_sums(g, x))
    assert torch.equal(dx, se.se_grad_apply(g, s, dm))
    now = [f.launches for f in (se.se_excite, se.se_grad_sums, se.se_grad_apply)]
    assert [a - b for a, b in zip(now, counts)] == [2, 2, 2]


@pytest.mark.parametrize("shape", CELLS, ids=[f"{n}x{h}x{w}x{c}" for n, h, w, c in CELLS])
def test_kernels_at_the_cells_block_shapes(cuda, shape):
    _check_kernels(shape, torch.bfloat16, cuda)
    torch.cuda.empty_cache()


@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape", ODD + CELLS[3:4] + CELLS[-1:])
def test_kernels_at_odd_shapes(cuda, shape, dtype, offset):
    if offset and shape[3] > se.THREADS:  # one element a thread: a row over a block
        x = _slab(shape, dtype, cuda, 0, offset)
        before = se.se_grad_sums.launches
        with pytest.raises(ValueError, match="over a block's"):
            se.se_grad_sums(x, x)
        assert se.se_grad_sums.launches == before
        return
    _check_kernels(shape, dtype, cuda, offset)


def test_the_kernels_refuse_other_dtypes_and_layouts(cuda):
    before = se.se_excite.launches
    s = torch.zeros(2, 8, device=cuda)
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        se.se_excite(torch.zeros(2, 8, 3, 3, device=cuda, dtype=torch.float64), s.double())
    with pytest.raises(ValueError, match="channels_last"):
        se.se_excite(torch.zeros(2, 8, 3, 3, device=cuda), s)
    assert se.se_excite.launches == before


@pytest.mark.parametrize("shape", [(800, 7, 7, 368), (16, 28, 50, 152), (4, 112, 199, 64)])
def test_the_module_on_the_card_holds_to_float64(cuda, shape):
    """The forward gives the stock ops' bits; against the stock ops in
    float64 on the CPU the kernels' gradients err no more than the stock
    ops' in bf16 on the card (x's gradient there adds an NCHW gradient into
    a channels_last one, the mixed-layout add)."""
    n, h, w, c = shape
    torch.manual_seed(0)
    module = SEModule(c, max(1, c // 4))
    for p in module.parameters():
        torch.nn.init.normal_(p, std=0.3)
    module64 = SEModule(c, max(1, c // 4)).double()
    module64.load_state_dict(module.state_dict())
    module = module.to(cuda)
    x = _slab(shape, torch.bfloat16, cuda, 3).requires_grad_()
    g = _slab(shape, torch.bfloat16, cuda, 4)

    def stock(mod, x):
        s = torch.sigmoid(mod.fc2(torch.relu(mod.fc1(x.mean(dim=(2, 3), keepdim=True)))))
        return x * s

    x64 = x.detach().cpu().double().requires_grad_()
    want_y = stock(module64, x64)
    want = torch.autograd.grad(want_y, [x64, *module64.parameters()], g.cpu().double())
    before = se.se_grad_apply.launches
    y = module(x)
    got = torch.autograd.grad(y, [x, *module.parameters()], g)
    assert se.se_grad_apply.launches == before + 1
    eager_y = stock(module, x)
    eager = torch.autograd.grad(eager_y, [x, *module.parameters()], g)
    assert torch.equal(y, eager_y), "the forward is not the stock ops' bits"

    def err(a, b):
        return float((a.detach().cpu().double() - b.detach()).abs().max())

    names = ("y", "x", "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias")
    for name, a, e, b in zip(names, (y, *got), (eager_y, *eager), (want_y, *want)):
        assert a.shape == b.shape and a.dtype == e.dtype, name
        floor = 2.0 ** -7 * float(b.detach().abs().max())  # a bf16 ulp of the largest
        assert err(a, b) <= max(1.25 * err(e, b), floor), (name, err(a, b), err(e, b))


@pytest.mark.parametrize("eager", [False, True], ids=["graphed", "eager"])
@pytest.mark.parametrize("config,acc,blocks", STEPS)
def test_a_training_step_launches_each_kernel_once_a_block_a_micro_batch(
        cuda, monkeypatch, config, acc, blocks, eager):
    """A config's training step at its batch and clip: each SE kernel once a
    block a micro-batch, replayed from the graphs (a replay counts what its
    capture recorded) or run eagerly."""
    from tdeed_tpu_torch import load_config
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.schedule import make_optimizer
    from tdeed_tpu_torch.train.step import make_train_step
    from tdeed_tpu_torch.utils import profiling

    if eager:
        monkeypatch.setattr(graphs, "MAX_KEYS", 0)
    ring = profiling.StepRecorder()
    monkeypatch.setattr(profiling, "STEPS", ring)
    cfg = load_config(config, config_root=os.path.join(ROOT, "configs"))
    torch.manual_seed(0)
    model = build_model(cfg, device="cuda")
    opt, sched = make_optimizer(model.parameters(), cfg.learning_rate, 100, 10_000)
    step = make_train_step(model, opt, sched, crop_dim=cfg.crop_dim,
                           num_classes_bg=cfg.num_classes_bg, mixup=cfg.mixup,
                           radi_displacement=cfg.radi_displacement, acc_grad_iter=acc)
    gen = torch.Generator(device=cuda).manual_seed(0)
    shape = (cfg.batch_size, cfg.clip_len, 256, 256, 3)
    batch = {k: torch.randint(0, 256, shape, generator=gen, device=cuda, dtype=torch.uint8)
             for k in ("frame", "frame2")}
    batch.update({k: torch.randint(0, cfg.num_classes_bg, shape[:2], generator=gen,
                                   device=cuda) for k in ("label", "label2")})
    fns = (se.se_excite, se.se_grad_sums, se.se_grad_apply)
    for _ in range(2):  # the first graphed step captures
        before = [f.launches for f in fns]
        assert torch.isfinite(step(batch)["loss"])
        torch.cuda.synchronize()
        assert [f.launches - n for f, n in zip(fns, before)] == [blocks * acc] * 3
    assert [r.graph_layers > 0 for r in ring.records] == [not eager] * 2


def test_a_predictor_exported_on_the_card_keeps_atens_ops(cuda, tmp_path):
    from tdeed_tpu_torch.config import TDEEDConfig
    from tdeed_tpu_torch.infer.export import ExportedPredictor, export_predictor
    from tdeed_tpu_torch.models.tdeed import build_model
    from tdeed_tpu_torch.train.step import make_predict_step

    cfg = TDEEDConfig(dataset="finediving", num_classes=4, clip_len=16, crop_dim=64,
                      feature_arch="rny002_gsf", n_layers=2, sgp_ks=7, sgp_r=4,
                      radi_displacement=2, dtype="bfloat16")
    torch.manual_seed(0)
    model = build_model(cfg, device="cuda")
    classes = {f"class{i}": i for i in range(1, cfg.num_classes + 1)}
    fns = (se.se_excite, se.se_grad_sums, se.se_grad_apply)
    before = [f.launches for f in fns]
    out = str(tmp_path / "artifact")
    export_predictor(cfg, model.state_dict(), classes, out, batch_size=2, frame_hw=(72, 72),
                     device="cuda")
    assert [f.launches for f in fns] == before
    programs = sorted(f for f in os.listdir(out) if f.endswith(".pt2"))
    assert programs
    for name in programs:
        program = torch.export.load(os.path.join(out, name))
        targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
        assert sum("aten.mean" in t for t in targets) >= 13, targets
        assert sum("aten.sigmoid" in t for t in targets) >= 13, targets
        assert not any("tdeed" in t or "ctypes" in t for t in targets)
    # the eager predictor runs the excite kernel and gives the program's bits
    # (random weights would turn a mean an ulp apart into other probabilities)
    frames = torch.randint(0, 256, (2, 16, 72, 72, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(1))
    predict = make_predict_step(model, crop_dim=cfg.crop_dim,
                                radi_displacement=cfg.radi_displacement)
    exported = ExportedPredictor(out)
    for hflip in (False, True):
        before = se.se_excite.launches
        _, want = predict(frames, hflip)
        assert se.se_excite.launches > before
        _, probs = exported(frames, hflip=hflip)
        assert float((probs.float() - want.float()).abs().max()) <= 1e-3
    # the package cannot be imported: the programs load and run all the same
    script = (
        "import os, sys\n"
        "sys.modules['tdeed_tpu_torch'] = None\n"
        "import torch\n"
        f"out = {out!r}\n"
        "for name in sorted(f for f in os.listdir(out) if f.endswith('.pt2')):\n"
        "    program = torch.export.load(os.path.join(out, name)).module()\n"
        "    frames = torch.zeros((2, 16, 72, 72, 3), dtype=torch.uint8, device='cuda')\n"
        "    leaves = torch.utils._pytree.tree_leaves(program(frames))\n"
        "    assert leaves and all(bool(torch.isfinite(t).all()) for t in leaves)\n"
        "print('loaded', flush=True)\n")
    done = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                          cwd=str(tmp_path), timeout=600)
    assert done.returncode == 0 and "loaded" in done.stdout, done.stderr[-4000:]
