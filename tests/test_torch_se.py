"""The squeeze-and-excitation kernels' host side (tdeed_tpu_torch/kernels/
se.py) on the CPU, where the kernels themselves do not run (they are held
against float64 on the card by tests/test_torch_se_gpu.py):

- ``se_plan`` at every SE shape the shipped configs train, and its
  refusals; the plan replayed thread by thread as csrc/se.cu walks it
  covers each element once, and its sums (each thread's rows, then a
  block's row groups in two passes) add up each sample's channel;
- the three plain twins, and ``SqueezeExcite`` on them, against
  ``SEModule``'s eager autograd in float64: y, and the gradients of x,
  ``fc1`` and ``fc2``, also inside a checkpointed block and with frozen
  parameters; its forward is the stock ops' bit for bit in bf16 and fp32;
- ``SEModule`` keeps its stock ops on the CPU and under ``torch.export``'s
  trace, and launches nothing.
"""

import json
import os

import numpy as np
import pytest
import torch

from tdeed_tpu_torch.kernels import se
from tdeed_tpu_torch.kernels.se import MIN_STEPS, THREADS, se_plan
from tdeed_tpu_torch.models import regnet
from tdeed_tpu_torch.models.regnet import SEModule

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "configs")
FULL_FRAME = (448, 796)  # the SoccerNet frames a config with crop_dim -1 trains on


def _se_shapes(arch, h, w):
    """(HW, C) of each block's SE in a RegNet-Y trunk over h x w frames: the
    stem and each stage's first block halve H and W (3x3, stride 2, pad 1)."""
    p = regnet.ARCH_PARAMS[arch]
    widths, depths, _ = regnet.generate_stages(p["w0"], p["wa"], p["wm"], p["depth"],
                                               p["group_size"])
    h, w = -(-h // 2), -(-w // 2)
    shapes = []
    for width, depth in zip(widths, depths):
        h, w = -(-h // 2), -(-w // 2)
        shapes += [(h * w, width)] * depth
    return shapes


def _shipped():
    """(config, arch, N, H, W) of every shipped config's training micro-batch."""
    out = []
    for group in sorted(os.listdir(CONFIGS)):
        folder = os.path.join(CONFIGS, group)
        if not os.path.isdir(folder):
            continue
        for name in sorted(os.listdir(folder)):
            with open(os.path.join(folder, name)) as f:
                cfg = json.load(f)
            h, w = FULL_FRAME if cfg["crop_dim"] in (None, -1) else (cfg["crop_dim"],) * 2
            n = cfg["batch_size"] // (cfg.get("acc_grad_iter") or 1) * cfg["clip_len"]
            out.append((name[:-5], cfg["feature_arch"].split("_")[0], n, h, w))
    return out


SHIPPED = _shipped()


def test_the_shape_arithmetic_is_the_trunks():
    """``_se_shapes`` against the SE inputs a trunk's forward sees."""
    seen = []
    trunk = regnet.RegNetY("rny002").eval()
    for module in trunk.modules():
        if isinstance(module, SEModule):
            module.register_forward_hook(lambda m, args, out: seen.append(tuple(args[0].shape)))
    with torch.no_grad():
        trunk(torch.zeros(2, 3, 45, 70))
    assert [(h * w, c) for _, c, h, w in seen] == _se_shapes("rny002", 45, 70)
    assert len(SHIPPED) == 14


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("config,arch,n,h,w", SHIPPED, ids=[s[0] for s in SHIPPED])
def test_plan_at_every_shipped_se_shape(config, arch, n, h, w, dtype):
    """Every block's SE in training (N = batch x clip) and in serving one
    clip (N = 100): 16-byte accesses; as many row groups a block as THREADS
    threads hold, unless a thread would take fewer than MIN_STEPS rows;
    one sample a block; at the training batch more blocks than an H100's
    132 multiprocessors."""
    itemsize = torch.finfo(dtype).bits // 8
    for batch in (n, 100):
        for hw, c in _se_shapes(arch, h, w):
            plan = se_plan(batch, hw, c, itemsize, 16)
            lanes = c // plan.vec
            assert plan.vec * itemsize == 16
            assert plan.threads == plan.units * plan.rows * lanes <= THREADS
            assert plan.units == 1
            assert hw // plan.rows >= MIN_STEPS
            assert plan.rows == THREADS // lanes or hw // (plan.rows + 1) < MIN_STEPS
            assert plan.blocks == batch
    assert n >= 200


def test_plan_adapts_to_the_shape():
    # challenge 2's first stage: 200 samples of 22,288 rows, a block each
    assert se_plan(200, 22288, 64, 2, 16) == se.SEPlan(8, 1, 64, 512, 200)
    assert se_plan(16, 22288, 64, 2, 16) == se.SEPlan(8, 1, 64, 512, 16)
    # FineDiving's last stage: 49 rows a sample, 3 row groups of 16 rows
    assert se_plan(800, 49, 368, 2, 16) == se.SEPlan(8, 1, 3, 138, 800)
    # a few rows a sample: samples packed into a block
    plan = se_plan(6, 4, 24, 2, 16)
    assert (plan.units, plan.rows, plan.blocks) == (6, 1, 1)
    # the accesses narrow with the channels and the addresses
    assert se_plan(8, 9, 6, 2, 16).vec == 2
    assert se_plan(8, 9, 24, 2, 2).vec == 1
    assert se_plan(8, 9, 24, 4, 8).vec == 2


def test_plan_refuses_what_the_kernels_cannot_run():
    for n, hw, c in ((0, 4, 8), (2, 0, 8), (2, 4, 0)):
        with pytest.raises(ValueError, match="nothing to squeeze"):
            se_plan(n, hw, c, 2, 16)
    with pytest.raises(ValueError, match="over a block's 512"):
        se_plan(2, 4, 513, 2, 16)  # odd channels: one a thread, 513 threads a row
    with pytest.raises(ValueError, match="over a block's 512"):
        se_plan(2, 4, 4104, 4, 16)  # fp32, 16 bytes a thread: 1,026 a row
    assert se_plan(2, 4, 4096, 2, 16).threads == 512


def _walk(plan, n, hw, c):
    """csrc/se.cu's tile(): per block, per thread, (sample, rows, lane)."""
    lanes = c // plan.vec
    per_unit = plan.rows * lanes
    for block in range(plan.blocks):
        threads = []
        for k in range(plan.threads):
            unit, kk = divmod(k, per_unit)
            r, lane = divmod(kk, lanes)
            sample = block * plan.units + unit
            threads.append((sample, range(r, hw if sample < n else r, plan.rows), lane))
        yield block, threads


# (N, HW, C, itemsize, align): packed samples, a last block partly packed,
# many rows a sample in bf16 and fp32, 4-byte accesses, one-element
# accesses with one row a sample, FineDiving's last stage at fewer samples
WALKS = [(5, 3, 24, 2, 16), (300, 20, 24, 2, 16), (2, 9000, 16, 2, 16), (2, 40000, 8, 2, 16),
         (3, 5000, 24, 4, 16), (2, 777, 6, 2, 4), (2, 1, 40, 2, 2), (4, 49, 368, 2, 16)]


@pytest.mark.parametrize("n,hw,c,itemsize,align", WALKS)
def test_plan_covers_every_element_once(n, hw, c, itemsize, align):
    plan = se_plan(n, hw, c, itemsize, align)
    count = np.zeros((n, hw, c // plan.vec), dtype=np.int64)
    for block, threads in _walk(plan, n, hw, c):
        samples = {s for s, rows, _ in threads if len(rows)}
        assert samples <= set(range(block * plan.units, (block + 1) * plan.units))
        for sample, rows, lane in threads:
            if sample < n:
                count[sample, list(rows), lane] += 1
            else:
                assert not len(rows)
    assert (count == 1).all()


def _emulate_sums(plan, x):
    """csrc/se.cu's tdeed_se_grad_sums in float64: each thread's rows in
    order, then each unit's row groups in two passes."""
    n, hw, c = x.shape
    v = plan.vec
    out = np.zeros((n, c))
    for block, threads in _walk(plan, n, hw, c):
        red = np.zeros(plan.threads * v)
        for k, (sample, rows, lane) in enumerate(threads):
            if sample < n and len(rows):
                red[k * v:(k + 1) * v] = x[sample, list(rows), lane * v:(lane + 1) * v].sum(0)
        # each (unit, channel) sum in `parts` parts of row groups p, p + parts, ...
        items = plan.units * c
        parts = max(1, plan.threads // items)
        part = np.zeros(parts * items)
        for k in range(parts * items):
            p, it = divmod(k, items)
            u, ch = divmod(it, c)
            for r in range(p, plan.rows, parts):
                part[k] += red[(u * plan.rows + r) * c + ch]
        sums = part.reshape(parts, items).sum(0)
        for u in range(plan.units):
            sample = block * plan.units + u
            if sample < n:
                out[sample] = sums[u * c:(u + 1) * c]
    return out


@pytest.mark.parametrize("n,hw,c,itemsize,align", WALKS)
def test_the_sums_add_up_each_samples_channel(n, hw, c, itemsize, align):
    plan = se_plan(n, hw, c, itemsize, align)
    x = np.random.default_rng(hw).standard_normal((n, hw, c))
    np.testing.assert_allclose(_emulate_sums(plan, x), x.sum(1), rtol=1e-12, atol=1e-12)


# (N, C, H, W, reduction width): a block's shapes at small sizes, a 1x1
# map, odd sizes
CASES = [(3, 24, 5, 7, 8), (2, 56, 1, 1, 6), (4, 8, 3, 2, 2), (1, 368, 7, 7, 38),
         (2, 152, 4, 4, 14)]


def _module(c, rd, seed):
    torch.manual_seed(seed)
    module = SEModule(c, rd).double()
    for p in module.parameters():  # zero biases and N(0, 2/fan_out) weights exercise too little
        torch.nn.init.normal_(p, std=0.5)
    return module


def _input(n, c, h, w, layout, seed=0, dtype=torch.float64):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, c, h, w), generator=g, dtype=torch.float64).to(dtype)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    return x.requires_grad_()


def _se(module, x):
    return se.squeeze_excite(x, module.gate, tuple(module.parameters()))


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("n,c,h,w,rd", CASES)
def test_the_function_is_the_modules_eager_autograd_in_float64(n, c, h, w, rd, layout):
    module = _module(c, rd, n + c)
    x = _input(n, c, h, w, layout)
    g = torch.randn((n, c, h, w), generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    inputs = [x, *module.parameters()]
    want_y = module(x)
    want = torch.autograd.grad(want_y, inputs, g)
    got_y = _se(module, x)
    got = torch.autograd.grad(got_y, inputs, g)
    assert got_y.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(got_y, want_y, rtol=1e-13, atol=1e-13)
    for what, a, b in zip(("x", "fc1.weight", "fc1.bias", "fc2.weight", "fc2.bias"), got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, what
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12, msg=what)


@pytest.mark.parametrize("n,c,h,w,rd", CASES)
def test_the_twins_are_the_eager_chains_steps_in_float64(n, c, h, w, rd):
    """Each twin against the tensors eager autograd passes between the
    stock ops: the gated product, the gate's gradient (the sum of g * x)
    and x's gradient (g * s plus the mean's gradient over HW)."""
    module = _module(c, rd, c)
    x = _input(n, c, h, w, "channels_last")
    g = torch.randn((n, c, h, w), generator=torch.Generator().manual_seed(2),
                    dtype=torch.float64)
    m = x.mean(dim=(2, 3), keepdim=True)
    m.retain_grad()
    s = torch.sigmoid(module.fc2(torch.relu(module.fc1(m))))
    s.retain_grad()
    y = x * s
    y.backward(g)
    dx = x.grad
    flat = lambda t: t.detach()[:, :, 0, 0]  # noqa: E731
    torch.testing.assert_close(se.se_excite_reference(x, flat(s)), y, rtol=0, atol=0)
    torch.testing.assert_close(se.se_grad_sums_reference(g, x), flat(s.grad), rtol=1e-13,
                               atol=1e-13)
    torch.testing.assert_close(se.se_grad_apply_reference(g, flat(s), flat(m.grad)), dx,
                               rtol=1e-13, atol=1e-13)


@pytest.mark.parametrize("layout", ["channels_last", "contiguous"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_the_functions_forward_is_the_stock_ops_bit_for_bit(dtype, layout):
    """The mean and the fc chain are the module's own ops and the twin's
    product rounds x * s once, as ATen's does: an exported program, which
    holds the stock ops, gives the same bits."""
    n, c, h, w, rd = CASES[0]
    module = _module(c, rd, 11).to(dtype)
    x = _input(n, c, h, w, layout, dtype=dtype)
    assert torch.equal(_se(module, x), module(x))


def test_the_function_in_fp32_holds_to_float64():
    n, c, h, w, rd = CASES[0]
    module = _module(c, rd, 7)
    x64 = _input(n, c, h, w, "channels_last")
    g = torch.randn((n, c, h, w), generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    want_y = module(x64)
    want = torch.autograd.grad(want_y, [x64, *module.parameters()], g)
    module32 = module.float()
    x = x64.detach().float().requires_grad_()
    y = _se(module32, x)
    got = torch.autograd.grad(y, [x, *module32.parameters()], g.float())
    torch.testing.assert_close(y.double(), want_y, rtol=1e-5, atol=1e-5)
    for a, b in zip(got, want):
        assert a.dtype == torch.float32
        torch.testing.assert_close(a.double(), b, rtol=1e-4, atol=1e-5)


def test_a_checkpointed_block_recomputes_the_function_once():
    """Inside a non-reentrant checkpoint, as ``checkpoint_backbone`` runs a
    block, the backward recomputes the block once and gives eager
    autograd's gradients: the gate's own backward is a second graph task,
    which must find no tensor the checkpoint packed."""
    n, c, h, w, rd = CASES[0]
    module = _module(c, rd, 5)
    x = _input(n, c, h, w, "channels_last")
    g = torch.randn((n, c, h, w), generator=torch.Generator().manual_seed(8),
                    dtype=torch.float64)
    calls = []

    def block(t):
        calls.append(1)
        return _se(module, t) * 2

    inputs = [x, *module.parameters()]
    want = torch.autograd.grad(module(x) * 2, inputs, g)
    y = torch.utils.checkpoint.checkpoint(block, x, use_reentrant=False)
    got = torch.autograd.grad(y, inputs, g)
    assert len(calls) == 2
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_frozen_parameters_get_no_gradient():
    n, c, h, w, rd = CASES[0]
    module = _module(c, rd, 6)
    module.fc1.requires_grad_(False)
    x = _input(n, c, h, w, "channels_last")
    g = torch.randn((n, c, h, w), generator=torch.Generator().manual_seed(9),
                    dtype=torch.float64)
    want = torch.autograd.grad(module(x), [x, module.fc2.weight, module.fc2.bias], g)
    _se(module, x).backward(g)
    assert module.fc1.weight.grad is None and module.fc1.bias.grad is None
    for a, b in zip((x.grad, module.fc2.weight.grad, module.fc2.bias.grad), want):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def test_a_bf16_gradient_is_rounded_once():
    """x's gradient in bf16 is the float64 g * s + dm / HW of the twin's
    own s and dm, rounded once to bf16 (within half an ulp)."""
    n, c, h, w = 2, 24, 5, 5
    g = torch.randn((n, c, h, w), generator=torch.Generator().manual_seed(4)).to(torch.bfloat16)
    s = torch.rand((n, c), generator=torch.Generator().manual_seed(5)).to(torch.bfloat16)
    dm = torch.randn((n, c), generator=torch.Generator().manual_seed(6)).to(torch.bfloat16)
    got = se.se_grad_apply_reference(g, s, dm).double()
    want = g.double() * s.double()[:, :, None, None] + dm.double()[:, :, None, None] / (h * w)
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0 ** -100))) - 7)
    assert bool(((got - want).abs() <= 0.5 * ulp * (1 + 1e-6)).all())


@pytest.fixture
def no_kernels(monkeypatch):
    """The kernels' entry replaced by one that fails the test if reached."""
    def refuse(*_):
        raise AssertionError("the SE kernels were called")
    monkeypatch.setattr(se, "squeeze_excite", refuse)


def _launches():
    return [f.launches for f in (se.se_excite, se.se_grad_sums, se.se_grad_apply)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_cpu_tensor_takes_the_stock_ops(no_kernels, dtype):
    module = _module(24, 8, 0).to(dtype)
    x = _input(3, 24, 5, 7, "channels_last", dtype=dtype)
    before = _launches()
    y = module(x)
    s = torch.sigmoid(module.fc2(torch.relu(module.fc1(x.mean(dim=(2, 3), keepdim=True)))))
    assert torch.equal(y, x * s)
    y.sum().backward()
    assert _launches() == before


def test_export_tracing_takes_the_stock_ops(no_kernels, monkeypatch):
    seen = []
    tracing = regnet.tracing

    def spy():
        seen.append(tracing())
        return seen[-1]

    monkeypatch.setattr(regnet, "tracing", spy)
    module = SEModule(24, 8).eval()
    program = torch.export.export(module, (torch.randn(2, 24, 5, 7),))
    assert seen == [True]
    targets = [str(n.target) for n in program.graph.nodes if n.op == "call_function"]
    assert any("mean" in t for t in targets) and any("sigmoid" in t for t in targets), targets
    assert not tracing()


def test_the_kernels_refuse_other_dtypes_and_layouts():
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        se._slab(torch.zeros(2, 8, 3, 3, dtype=torch.float64), "x")
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        se._slab(torch.zeros(2, 8, 3, 3, dtype=torch.float16), "x")
    with pytest.raises(ValueError, match="channels_last"):
        se._slab(torch.zeros(2, 8, 3, 3), "x")  # NCHW-contiguous
    with pytest.raises(ValueError, match="channels_last"):
        se._slab(torch.zeros(2, 8, 3, 6).contiguous(memory_format=torch.channels_last)[..., ::2],
                 "x")
    with pytest.raises(ValueError, match="channels_last"):
        se._slab(torch.zeros(2, 8, 9), "x")
    se._slab(torch.zeros(2, 8, 3, 3).contiguous(memory_format=torch.channels_last), "x")
    se._slab(torch.zeros(2, 8, 1, 1), "x")  # a 1x1 map is both layouts
    x = torch.zeros(2, 8, 3, 3)
    se._check_vector(x, "the gate", torch.zeros(2, 8))
    for bad in (torch.zeros(2, 9), torch.zeros(2, 8, dtype=torch.bfloat16), torch.zeros(8, 2).t()):
        with pytest.raises(ValueError, match="contiguous"):
            se._check_vector(x, "the gate", bad)
