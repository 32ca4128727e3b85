"""The benchmark's plain reference (benchmark/reference/) against the port
at RegNetY-800MF widths, on the CPU in float64: the published
SoccerNetBall_challenge2 model (rny008_gsf, stage widths 64 / 128 / 320 /
768, group width 16, GSF in stages 3 and 4; a 2-layer SGP-Mixer at kernel
9 and r 4; displacement radius 4; the FC2 double head of 12+1 and 17+1
classes) at a tiny clip and frame size.

The method and tolerances are those of
benchmark/tests/test_benchmark_reference.py's RegNetY-200MF cases: the
port's augmentation is swapped for the reference's chain and the mixup
weights are 1 and 0, which blend exactly; the port returns float32
logits, so forward outputs agree to 1e-5 and the losses to 1e-6, every
first gradient to 1e-5 of its tensor's norm or the median tensor's, every
tensor's change by its norm to 1e-5 (the check's measure, over every
tensor), and the check's gaps, as a benchmark cell reads them, to 1e-6
and 1e-5."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.reference import model as M, train as R
from tdeed_tpu_torch.config import TDEEDConfig
from tdeed_tpu_torch.models.tdeed import build_model, two_heads_for
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train.step import StepDraws, make_train_step

PUBLISHED = Path(__file__).resolve().parents[1] / "configs/SoccerNetBall/SoccerNetBall_challenge2.json"
CLIP, H, W = 8, 40, 72  # full frames, no crop, as the published config trains
LR, WARMUP, COSINE = 8e-4, 1875, 29375


def _file() -> dict:
    return {**json.loads(PUBLISHED.read_text()), "clip_len": CLIP, "dtype": "float32"}


def _cfg() -> TDEEDConfig:
    return TDEEDConfig.from_dict(_file())


def _spec() -> M.Spec:
    return M.Spec.of(_file(), two_heads_for(_cfg()))


def _port(weights, dtype=torch.float64):
    cfg = _cfg()
    m = build_model(cfg, two_heads_for(cfg), device="cpu").to(dtype)
    m.dtype = dtype
    m.load_state_dict(weights, strict=False)
    return m


def _weights(seed: int) -> dict:
    return {k: v.double() for k, v in
            M.init_weights(_spec(), torch.Generator().manual_seed(seed)).items()}


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_the_published_model_is_rny008_with_two_heads():
    cfg, spec = _cfg(), _spec()
    assert (cfg.backbone, cfg.shift_mode, cfg.crop_dim, cfg.batch_size) == ("rny008", "gsf",
                                                                            None, 2)
    assert spec.two_heads == (13, 18) and (spec.sgp_ks, spec.radi_displacement) == (9, 4)
    assert M.stages("rny008") == ([64, 128, 320, 768], [1, 3, 8, 2], [16, 16, 16, 16])
    assert spec.feat_dim == 768


def test_state_names_and_shapes_are_the_ports():
    weights = M.init_weights(_spec(), torch.Generator().manual_seed(0))
    cfg = _cfg()
    sd = build_model(cfg, two_heads_for(cfg), device="cpu").state_dict()
    assert set(weights) == {k for k in sd if not k.endswith("num_batches_tracked")}
    assert all(tuple(sd[k].shape) == tuple(v.shape) for k, v in weights.items())


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_the_port_in_float64(train):
    spec = _spec()
    P = _weights(1)
    m = _port(P)
    m.train(train)
    x = torch.randn(2, CLIP, H, W, 3, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(2))
    keep = ({k: torch.rand(2, CLIP, spec.feat_dim) > 0.5 for k in m.dropout_heads}
            if train else None)
    with torch.no_grad():
        out = m(x, dropout_keep=keep)
        logits, displ = M.forward(P, spec, x, M.State(train=train), keep)
    assert logits.shape == (2, CLIP, 13 + 18)
    assert torch.allclose(out["logits"].double(), logits, rtol=1e-6, atol=1e-5)
    assert torch.allclose(out["displ"].double(), displ, rtol=1e-6, atol=1e-5)


def _batches_and_draws(m, spec, mixup: bool, gen: torch.Generator):
    """Three batches, one clip a head each, labels under each clip's
    head's classes, and the reference's draws (mixup weights 1 and 0)."""
    batches, draws = [], []
    n_cls = torch.tensor(spec.two_heads)
    for _ in range(3):
        bt = {"dataset": torch.tensor([1, 2], dtype=torch.int32)}
        for sfx in ("", "2") if mixup else ("",):
            bt["frame" + sfx] = torch.randint(0, 256, (2, CLIP, H, W, 3), dtype=torch.uint8,
                                              generator=gen)
            cls = (torch.rand(2, CLIP, generator=gen) * n_cls[:, None]).long()
            bt["label" + sfx] = cls.int()
            bt["labelD" + sfx] = torch.randint(-4, 5, (2, CLIP), generator=gen).double()
        batches.append(bt)
        d = R.draw(gen, 2, CLIP, (H, W), None, mixup, spec.feat_dim, m.dropout_heads)
        if mixup:
            d.lam = torch.tensor([1.0, 0.0], dtype=torch.float64)  # blends exactly in bf16
        draws.append(d)
    return batches, draws


@pytest.mark.parametrize("mixup", [True, False])
def test_three_steps_match_the_port_in_float64(mixup):
    spec, cfg = _spec(), _cfg()
    P = _weights(4)
    m = _port(P)
    opt, sched = make_optimizer(m.parameters(), LR, WARMUP, COSINE)
    step = make_train_step(m, opt, sched, crop_dim=cfg.crop_dim,
                           num_classes_bg=cfg.num_classes_bg, mixup=mixup,
                           radi_displacement=cfg.radi_displacement)
    step.preprocess = lambda f, a: R.photometric(f.double(), a.double())
    batches, draws = _batches_and_draws(m, spec, mixup, torch.Generator().manual_seed(5))
    p0 = {n: p.detach().clone() for n, p in m.named_parameters()}
    losses, outputs = [], []
    hook = m.register_forward_hook(lambda mod, args, out: outputs.append(
        (out["logits"].detach(), out["displ"].detach())))
    for i, (bt, d) in enumerate(zip(batches, draws)):
        losses.append(float(step(bt, [StepDraws(d.crop, d.lam, d.aug, d.keep)])["loss"]))
        if i == 0:
            hook.remove()
            grad = {n: opt.state[p]["exp_avg"] / 0.1 for n, p in m.named_parameters()}
    tr = R.train(P, spec, batches, draws, crop_dim=cfg.crop_dim, mixup=mixup, lr=LR,
                 warmup_steps=WARMUP, cosine_steps=COSINE)
    assert np.allclose(losses, tr.losses, rtol=1e-6)
    med = np.median([tr.grad[n].norm().item() for n in grad])
    for n in grad:
        scale = max(tr.grad[n].norm().item(), med)
        assert (grad[n] - tr.grad[n]).norm().item() <= 1e-5 * scale, n
    # every tensor's change by the check's measure: its norm against the
    # reference's, or the median tensor's where that is larger. Element by
    # element AdamW divides each gradient by its own size, so an element
    # whose gradient is near 0 carries the sums' rounding into its step.
    change = {n: (p.detach() - p0[n]).norm().item() for n, p in m.named_parameters()}
    ref_change = {n: c.norm().item() for n, c in tr.change.items()}
    assert set(change) == set(ref_change)
    assert max(compare.leaf_gaps(change, ref_change, list(ref_change))) < 1e-5
    # the check's numbers, as a cell reads them
    program = {"losses": losses, "grad": {n: g.norm().item() for n, g in grad.items()},
               "change": change, "outputs": outputs[0]}
    reference = {"losses": tr.losses, "grad": {n: g.norm().item() for n, g in tr.grad.items()},
                 "change": ref_change, "outputs": tr.outputs}
    gaps = compare.training_gaps(program, reference)
    assert gaps["logit_gap"] < 1e-6 and gaps["loss_gap"] < 1e-6, gaps
    assert gaps["grad_gap_worst"] < 1e-5 and gaps["change_gap_worst"] < 1e-5, gaps
