"""Data parallelism of the PyTorch port on the CPU: 2 gloo ranks against
one process on the global batch, and against the JAX step.

The ranks are spawned once for the module (tests/torch_ddp_worker.py) and
run every case; this process computes the one-process references while
they run. Each rank takes its rows of the same global inputs
(parallel.mesh.global_rows), made here with numpy from a seed.

Tolerances, with what was measured on these inputs:
  * float64, where only the order of sums differs: BatchNorm's output,
    running statistics and gradients, and the hard weighted CE and its
    gradient, at 1e-12 relative. The whole train step in float64 (mixup,
    acc_grad_iter 2): the gradients at 1e-10 relative L2 (measured
    1.0e-13), every weight and statistic at 1e-10 absolute (3.6e-14); the
    loss at rtol 1e-6, since the model's logits, and so the loss, are
    fp32.
  * fp32 train steps (rny002_gsf, clip 8, crop 32, batch 4, n_layers 1),
    the fp32 reduction-order tolerance: the loss at rtol 1e-4 (measured
    1.1e-7 to 6.3e-6), the running statistics at atol 1e-4 (6.8e-6 to
    2.6e-5), the gradients at 5e-2 relative L2 (5.8e-5 to 1.1e-2). The
    gradient of this fixture is fp32-ill-conditioned (train-mode BN over
    1x1 maps, tests/test_torch_train_step.py), and Adam's first step moves
    each weight by about lr(0) times the sign of its gradient, so a
    gradient below the fp32 noise may step the other way: at least 99% of
    the weight elements must sit within a quarter of that step of the
    one-process step's (all but 115 to 521 of 8,021,650 do), and every
    leaf must have moved.
  * Against the JAX step, mixup off, on the JAX kernel's augmented frames,
    from the same weights (the port's seeded init, carried to the JAX
    trees by the JAX package's reference converter): the tolerances of
    tests/test_torch_train_step.py (loss rtol 1e-4, measured 2.2e-5;
    running statistics atol 1e-3; 99% of the weights within a quarter
    step).
"""

import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

import jax
from tdeed_tpu_torch.models.common import SplitBatchNorm
from tdeed_tpu_torch.models.tdeed import TDEED
from tests import torch_ddp_worker as worker
from tests.test_torch_train_step import _jax_augmented, _jax_step
from tools.import_reference_checkpoint import convert_reference_state_dict

B, HW, W = 4, 40, worker.WORLD
LR0 = worker.LR * 0.01  # warmup's first learning rate


def _batch(rng):
    return {
        "frame": rng.integers(0, 256, (B, worker.T, HW, HW, 3)).astype(np.uint8),
        "label": rng.integers(0, worker.NC_BG, (B, worker.T)).astype(np.int32),
        "labelD": rng.uniform(-2, 2, (B, worker.T)).astype(np.float32),
        "frame2": rng.integers(0, 256, (B, worker.T, HW, HW, 3)).astype(np.uint8),
        "label2": rng.integers(0, worker.NC_BG, (B, worker.T)).astype(np.int32),
        "labelD2": rng.uniform(-2, 2, (B, worker.T)).astype(np.float32),
    }


def _initial_state():
    """The port's seeded init, and the same weights as the JAX package's
    trees (the reference checkpoint converter)."""
    torch.manual_seed(0)
    state = TDEED(worker.N_CLASSES, worker.T, dtype=torch.float32, **worker.MODEL).state_dict()
    params, stats, _ = convert_reference_state_dict(state)
    return state, {"params": params, "batch_stats": stats}


def _global_draws(state, batch, acc_grad_iter=1, mixup=False):
    """What one process draws for the global batch at step 0."""
    step = worker.make_step(state, torch.float32, mixup, acc_grad_iter, False)
    return step.draw(batch)


@pytest.fixture(scope="module")
def ddp(tmp_path_factory):
    root = tmp_path_factory.mktemp("ddp")
    rng = np.random.default_rng(5)
    batch_np = _batch(rng)
    batch = {k: torch.from_numpy(v) for k, v in batch_np.items()}
    state, variables = _initial_state()
    (draws,) = _global_draws(state, batch)
    jax_draws = dict(crop=draws.crop, lam=None, aug=draws.aug.numpy(),
                     keep={k: v.numpy() for k, v in draws.dropout_keep.items()})
    augmented = _jax_augmented(batch_np, jax_draws, mixup=False)
    bn = SplitBatchNorm(6).double()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(rng.uniform(0.5, 1.5, 6)))
        bn.bias.copy_(torch.from_numpy(rng.normal(size=6)))
    # rank 0's frames are nearly all background, rank 1's nearly all foreground
    ce_labels = np.zeros((B * 6,), np.int64)
    ce_labels[1] = 2
    ce_labels[B * 3:] = rng.integers(1, worker.NC_BG, B * 3)
    inputs = {
        "batch": batch,
        "state": state,
        "augmented": augmented,
        "bn_x": torch.from_numpy(rng.normal(1.0, 2.0, (B, 6, 3, 5))),
        "bn_c": torch.from_numpy(rng.normal(size=(B, 6, 3, 5))),
        "bn_state": bn.state_dict(),
        "ce_logits": torch.from_numpy(rng.normal(size=(B * 6, worker.NC_BG))),
        "ce_labels": torch.from_numpy(ce_labels),
        "ce_weights": torch.tensor([1.0, 5.0, 5.0, 5.0, 5.0], dtype=torch.float64),
    }
    torch.save(inputs, root / "inputs.pt")
    procs = worker.start(worker.step_cases, root)
    try:
        ref = {"inputs": inputs}
        for name, mixup, acc, dtype, replaced in worker.STEP_CASES:
            step = worker.make_step(inputs["state"], dtype, mixup, acc, distributed=False)
            loss, state, grads, step_draws = worker.run_step(
                step, batch, [augmented] if replaced else None)
            ref[name] = {"loss": loss, "state": state, "grads": grads, "draws": step_draws}
        with pytest.MonkeyPatch.context() as mp:
            _, ref["jax_loss"], ref["jax_state"] = _jax_step(
                mp, batch_np, jax_draws, mixup=False, variables=variables)
    finally:
        worker.join(procs)
    ranks = [torch.load(root / f"rank{r}.pt") for r in range(W)]
    return ref, ranks


def _rows(x, rank, acc_grad_iter=1):
    return worker.rows(x, rank, W, acc_grad_iter)


def _close(got, want, rtol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(np.abs(want).max(), 1e-30)
    assert np.abs(got - want).max() <= rtol * scale, (what, np.abs(got - want).max(), scale)


def test_batchnorm_over_two_ranks_is_the_global_batch_norm(ddp):
    """Forward and backward in float64 at 1e-12: each rank's output is its
    rows of the one-process output, the running statistics are the global
    batch's on both ranks, each rank's input gradient is W times its rows
    of the global one (the gradient of the sum of the ranks' losses), and
    the ranks' mean parameter gradient is the global one."""
    ref, ranks = ddp
    inp = ref["inputs"]
    bn = SplitBatchNorm(6).double()
    bn.load_state_dict(inp["bn_state"])
    x = inp["bn_x"].clone().requires_grad_(True)
    y = bn(x)
    (y * inp["bn_c"]).mean().backward()
    for r, out in enumerate(ranks):
        got = out["bn"]
        _close(got["y"], _rows(y.detach(), r), 1e-12, "y")
        _close(got["x_grad"], W * _rows(x.grad, r), 1e-12, "x grad")
        _close(got["running_mean"], bn.running_mean, 1e-12, "running mean")
        _close(got["running_var"], bn.running_var, 1e-12, "running var")
    for name, want in (("weight_grad", bn.weight.grad), ("bias_grad", bn.bias.grad)):
        _close(sum(o["bn"][name] for o in ranks) / W, want, 1e-12, name)


def test_weighted_ce_hard_over_two_ranks_is_the_global_loss(ddp):
    """Rank 0's frames are nearly all background and rank 1's nearly all
    foreground, so each rank's own weight sum would weight them apart: the
    mean of the ranks' losses is the global weighted mean, and each rank's
    logit gradient is W times its rows of the global one."""
    from tdeed_tpu_torch.train.losses import weighted_ce_hard

    ref, ranks = ddp
    inp = ref["inputs"]
    logits = inp["ce_logits"].clone().requires_grad_(True)
    loss = weighted_ce_hard(logits, inp["ce_labels"], inp["ce_weights"])
    loss.backward()
    _close(sum(o["ce"]["loss"] for o in ranks) / W, loss.detach(), 1e-12, "loss")
    for r, out in enumerate(ranks):
        _close(out["ce"]["grad"], W * _rows(logits.grad, r), 1e-12, "grad")
    local = [weighted_ce_hard(_rows(inp["ce_logits"], r), _rows(inp["ce_labels"], r),
                              inp["ce_weights"]) for r in range(W)]
    assert abs(float(sum(local) / W - loss.detach())) > 1e-3  # local sums would not do


def _grad_distance(got, want):
    """Relative L2 distance of two gradients, over every leaf at once."""
    assert set(got) == set(want)
    num = sum(float((got[k].double() - want[k].double()).square().sum()) for k in want)
    den = sum(float(want[k].double().square().sum()) for k in want)
    return (num / den) ** 0.5


def _assert_step_close(got, want, loss_rtol, stats_atol):
    assert np.isfinite(got["loss"])
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=loss_rtol)
    assert _grad_distance(got["grads"], want["grads"]) < 5e-2
    close = total = 0
    for k, w in want["state"].items():
        g = got["state"][k]
        if "running" in k:
            np.testing.assert_allclose(g.double(), w.double(), rtol=0, atol=stats_atol,
                                       err_msg=k)
        elif w.is_floating_point():
            close += int(((g.double() - w.double()).abs() <= 0.25 * LR0).sum())
            total += w.numel()
        else:
            assert torch.equal(g, w), k
    assert close >= 0.99 * total, f"{total - close} of {total} weight elements differ"


@pytest.mark.parametrize("name", ["mixup-acc1", "mixup-acc2", "plain-acc1", "plain-acc2"])
def test_train_step_over_two_ranks_matches_one_process(ddp, name):
    """fp32, mixup on and off, acc_grad_iter 1 and 2: the global loss,
    running statistics and weights after one step equal the one-process
    step's on the global batch (module docstring), both ranks hold the
    same weights bit for bit, and every weight moved."""
    ref, ranks = ddp
    for out in ranks:
        _assert_step_close(out[name], ref[name], 1e-4, 1e-4)
    for k, v in ranks[0][name]["state"].items():
        assert torch.equal(v, ranks[1][name]["state"][k]), k
    init = ref["inputs"]["state"]
    for k, v in ranks[0][name]["state"].items():
        if v.is_floating_point() and "running" not in k:
            assert (v.double() - init[k].double()).abs().max() > 0.5 * LR0, k


def test_train_step_over_two_ranks_is_exact_in_float64(ddp):
    """In float64 only the order of sums differs (mixup, acc_grad_iter 2):
    the averaged gradients at 1e-10 relative L2, every weight and
    statistic at 1e-10, the fp32 loss at rtol 1e-6."""
    ref, ranks = ddp
    want = ref["mixup-acc2-float64"]
    for out in ranks:
        got = out["mixup-acc2-float64"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
        assert _grad_distance(got["grads"], want["grads"]) < 1e-10
        for k, w in want["state"].items():
            np.testing.assert_allclose(got["state"][k].double(), w.double(), rtol=0,
                                       atol=1e-10, err_msg=k)


def test_train_step_over_two_ranks_matches_jax(ddp):
    """Mixup off (the hard CE over the global weight sum), acc_grad_iter 1,
    on the JAX kernel's augmented frames: the 2-rank step against
    tdeed_tpu.train.step.make_train_step on the global batch, one CPU
    device, at tests/test_torch_train_step.py's tolerances."""
    ref, ranks = ddp
    params, stats, _ = convert_reference_state_dict(
        ranks[0]["plain-acc1-jax-augmented"]["state"])
    jax_state = ref["jax_state"]
    np.testing.assert_allclose(ranks[0]["plain-acc1-jax-augmented"]["loss"], ref["jax_loss"],
                               rtol=1e-4)
    got = flatten_dict(params)
    want = flatten_dict(jax.tree.map(np.asarray, jax_state.params))
    assert set(got) == set(want)
    close = sum(int((np.abs(got[k] - want[k]) <= 0.25 * LR0).sum()) for k in want)
    total = sum(want[k].size for k in want)
    assert close >= 0.99 * total, f"{total - close} of {total} elements differ"
    fs, fw = flatten_dict(stats), flatten_dict(jax.tree.map(np.asarray, jax_state.batch_stats))
    assert set(fs) == set(fw)
    for k in fw:
        np.testing.assert_allclose(fs[k], fw[k], rtol=1e-3, atol=1e-3, err_msg="/".join(k))


@pytest.mark.parametrize("name", ["mixup-acc1", "mixup-acc2"])
def test_each_rank_draws_its_rows_of_the_global_draws(ddp, name):
    """The crop offset is the global one; mixup weights, augment params and
    dropout masks are the rank's rows of each global micro-batch's, bit for
    bit."""
    ref, ranks = ddp
    for r, out in enumerate(ranks):
        got, want = out[name]["draws"], ref[name]["draws"]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            per = g["aug"].shape[0]
            rows = slice(r * per, (r + 1) * per)
            assert g["crop"] == w["crop"]
            assert torch.equal(g["lam"], w["lam"][rows])
            assert torch.equal(g["aug"], w["aug"][rows])
            assert set(g["dropout_keep"]) == set(w["dropout_keep"])
            for k in w["dropout_keep"]:
                assert torch.equal(g["dropout_keep"][k], w["dropout_keep"][k][rows])


def test_ranks_import_no_jax(ddp):
    """The spawned ranks ran the port without loading JAX or the JAX package."""
    _, ranks = ddp
    assert [out["jax_modules"] for out in ranks] == [[]] * W
