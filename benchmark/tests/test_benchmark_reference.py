"""The plain reference against the port, at tiny sizes on the CPU.

The reference imports nothing of the port; these tests import both. In
float64 the reference's training steps and the port's agree to the
port's float32 logits, once the port's augmentation and its bf16
rounding of the mixup blend are out of the way (the port's chain outputs
bf16; the tests hand the step the reference's chain and mixup weights of
0 and 1, which blend exactly)."""

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.reference import model as M, train as R
from tdeed_tpu_torch.config import TDEEDConfig
from tdeed_tpu_torch.kernels.augment import photometric_reference
from tdeed_tpu_torch.models.tdeed import build_model
from tdeed_tpu_torch.train.schedule import chained_warmup_cosine, make_optimizer
from tdeed_tpu_torch.train.step import StepDraws, make_train_step

CLIP, CROP, B, H, W = 8, 32, 2, 40, 48
TWO_HEADS = (5, 4)


def _spec(two_heads=None):
    return M.Spec("rny002", CLIP, 2, 7, 4.0, 4, 2, two_heads)


def _port(spec, weights, dtype=torch.float32):
    cfg = TDEEDConfig(dataset="finediving", num_classes=4, clip_len=CLIP, crop_dim=CROP,
                      feature_arch="rny002_gsf", n_layers=2, sgp_ks=7, sgp_r=4,
                      radi_displacement=2, dtype="float32")
    m = build_model(cfg, spec.two_heads, device="cpu").to(dtype)
    m.dtype = dtype
    m.load_state_dict(weights, strict=False)
    return m


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_state_names_are_the_ports():
    for two in (None, TWO_HEADS):
        spec = _spec(two)
        weights = M.init_weights(spec, torch.Generator().manual_seed(0))
        cfg = TDEEDConfig(dataset="finediving", num_classes=4, clip_len=CLIP, crop_dim=CROP,
                          feature_arch="rny002_gsf", n_layers=2, sgp_ks=7, sgp_r=4,
                          radi_displacement=2, dtype="float32")
        sd = build_model(cfg, two, device="cpu").state_dict()
        assert set(weights) == {k for k in sd if not k.endswith("num_batches_tracked")}
        assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in weights.items())


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_port_in_float64(train):
    spec = _spec()
    P = {k: v.double() for k, v in M.init_weights(spec, torch.Generator().manual_seed(1)).items()}
    m = _port(spec, P, torch.float64)
    m.train(train)
    x = torch.randn(B, CLIP, CROP, CROP, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    keep = {k: torch.rand(B, CLIP, spec.feat_dim) > 0.5 for k in m.dropout_heads} if train else None
    with torch.no_grad():
        out = m(x, dropout_keep=keep)
        logits, displ = M.forward(P, spec, x, M.State(train=train), keep)
    # the port returns float32 logits
    assert torch.allclose(out["logits"].double(), logits, rtol=1e-6, atol=1e-5)
    assert torch.allclose(out["displ"].double(), displ, rtol=1e-6, atol=1e-5)


def test_photometric_chain_matches_the_ports_plain_chain():
    gen = torch.Generator().manual_seed(3)
    frames = torch.randint(0, 256, (4, 3, 24, 20, 3), dtype=torch.uint8, generator=gen)
    d = R.draw(gen, 4, 3, (24, 20), None, False, 8, [])
    for gates in ([], [0, 2, 4, 6, 8]):  # the sampled gates, then every one on
        aug = d.aug.clone()
        aug[:, gates] = 1.0
        port = photometric_reference(frames, aug).float()
        ref = R.photometric(frames, aug)
        # the port's chain rounds its output to bf16: half a bf16 step at |x| <= 3
        assert (port - ref).abs().max() <= 2 ** -7


def test_learning_rate_matches_the_ports_schedule():
    sched = chained_warmup_cosine(8e-4, 1875, 29375)
    for t in (0, 1, 2, 1875, 20000):
        assert R.learning_rate(8e-4, 1875, 29375, t) == pytest.approx(sched(t), rel=1e-12)


@pytest.mark.parametrize("two_heads,mixup", [(None, True), (None, False), (TWO_HEADS, True),
                                             (TWO_HEADS, False)])
def test_three_steps_match_the_port_in_float64(two_heads, mixup):
    spec = _spec(two_heads)
    P = {k: v.double() for k, v in M.init_weights(spec, torch.Generator().manual_seed(4)).items()}
    m = _port(spec, P, torch.float64)
    opt, sched = make_optimizer(m.parameters(), 8e-4, 1875, 29375)
    step = make_train_step(m, opt, sched, crop_dim=CROP, num_classes_bg=5, mixup=mixup,
                           radi_displacement=2)
    step.preprocess = lambda f, a: R.photometric(f.double(), a.double())
    gen = torch.Generator().manual_seed(5)
    batches, draws = [], []
    for _ in range(3):
        bt = {}
        for sfx in ("", "2") if mixup else ("",):
            bt["frame" + sfx] = torch.randint(0, 256, (B, CLIP, H, W, 3), dtype=torch.uint8,
                                              generator=gen)
            bt["label" + sfx] = torch.randint(0, 4, (B, CLIP), generator=gen).int()
            bt["labelD" + sfx] = torch.randint(-2, 3, (B, CLIP), generator=gen).double()
        if two_heads:
            bt["dataset"] = torch.tensor([1, 2], dtype=torch.int32)
        batches.append(bt)
        d = R.draw(gen, B, CLIP, (H, W), CROP, mixup, spec.feat_dim, m.dropout_heads)
        if mixup:
            d.lam = torch.tensor([1.0, 0.0], dtype=torch.float64)  # blends exactly in bf16
        draws.append(d)
    p0 = {n: p.detach().clone() for n, p in m.named_parameters()}
    losses, outputs = [], []
    hook = m.register_forward_hook(lambda mod, args, out: outputs.append(
        (out["logits"].detach(), out["displ"].detach())))
    for i, (bt, d) in enumerate(zip(batches, draws)):
        losses.append(float(step(bt, [StepDraws(d.crop, d.lam, d.aug, d.keep)])["loss"]))
        if i == 0:
            hook.remove()
            grad = {n: opt.state[p]["exp_avg"] / 0.1 for n, p in m.named_parameters()}
    tr = R.train(P, spec, batches, draws, crop_dim=CROP, mixup=mixup, lr=8e-4,
                 warmup_steps=1875, cosine_steps=29375)
    assert np.allclose(losses, tr.losses, rtol=1e-6)
    med = np.median([tr.grad[n].norm().item() for n in grad])
    for n, p in m.named_parameters():
        scale = max(tr.grad[n].norm().item(), med)
        assert (grad[n] - tr.grad[n]).norm().item() <= 1e-5 * scale, n
    # the check's numbers, as a cell reads them
    program = {"losses": losses, "grad": {n: g.norm().item() for n, g in grad.items()},
               "change": {n: (p.detach() - p0[n]).norm().item() for n, p in m.named_parameters()},
               "outputs": outputs[0]}
    reference = {"losses": tr.losses, "grad": {n: g.norm().item() for n, g in tr.grad.items()},
                 "change": {n: c.norm().item() for n, c in tr.change.items()},
                 "outputs": tr.outputs}
    gaps = compare.training_gaps(program, reference)
    assert gaps["logit_gap"] < 1e-6 and gaps["loss_gap"] < 1e-6, gaps
    assert gaps["grad_gap_worst"] < 1e-5 and gaps["change_gap_worst"] < 1e-5, gaps


def test_checkpointed_trunk_gives_the_same_gradients():
    spec = _spec()
    P = {k: v.double().requires_grad_(not k.endswith(("running_mean", "running_var")))
         for k, v in M.init_weights(spec, torch.Generator().manual_seed(6)).items()}
    x = torch.randn(B, CLIP, CROP, CROP, 3, dtype=torch.float64)
    grads = []
    for ckpt in (False, True):
        logits, displ = M.forward(P, spec, x, M.State(train=True), checkpoint=ckpt)
        g = torch.autograd.grad(logits.square().mean() + displ.mean(), [P["_features.stem.conv.weight"]])
        grads.append(g[0])
    assert torch.allclose(grads[0], grads[1], rtol=1e-10, atol=1e-12)
