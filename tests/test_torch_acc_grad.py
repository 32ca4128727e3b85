"""The port's training step at ``acc_grad_iter=2`` against the JAX
package's micro-batch scan (tdeed_tpu/train/step.py:170-190).

B = 4 taken as 2 micro-batches of 2, with mixup on. Every micro-batch
gets the same injected draws on both sides (crop offset, mixup weights,
(2, 16) augment params, dropout masks), as in tests/test_torch_train_step.py,
whose helpers and fixture sizes this file uses (full rny002 widths with
GSF, clip_len 8, 40x40 frames cropped to 32, n_layers 1, fp32 model). The
port is given the JAX kernel's output on each micro-batch as its augmented
input, so the two steps see the same numbers.

Held at that file's step-0 tolerances, with what was measured here:
  * the mean loss over the micro-batches at rtol 1e-4 (measured 2.2e-5);
  * the BN running statistics after both micro-batches (each micro-batch
    updates them once, the second normalised with its own batch
    statistics) at rtol and atol 1e-3 (measured 1.5e-4 at most);
  * the mean gradient, from the optimizers' first moments, by relative L2
    distance under 5e-2 (measured 3.8e-2). The gap is JAX's fp32 rounding
    on this ill-conditioned fixture (see that file): on the same input the
    port's fp32 gradient sits 5.8e-5 from its own float64 run, and JAX's
    3.8e-2 from that run.
"""

import jax
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict

from tests.test_torch_train_step import B, HW, T, _jax_augmented, _jax_step, _port_step
from tests.torch_port_util import FEAT, NC_BG, photometric_params
from tools.import_reference_checkpoint import convert_reference_state_dict

ACC = 2


def _inputs():
    rng = np.random.default_rng(8)
    n = B * ACC
    batch = {
        "frame": rng.integers(0, 256, (n, T, HW, HW, 3)).astype(np.uint8),
        "label": rng.integers(0, NC_BG, (n, T)).astype(np.int32),
        "labelD": rng.uniform(-2, 2, (n, T)).astype(np.float32),
        "frame2": rng.integers(0, 256, (n, T, HW, HW, 3)).astype(np.uint8),
        "label2": rng.integers(0, NC_BG, (n, T)).astype(np.int32),
        "labelD2": rng.uniform(-2, 2, (n, T)).astype(np.float32),
    }
    draws = dict(
        crop=(6, 2),
        lam=np.array([0.75, 0.375], np.float32),  # dyadic: an exact fp32 blend
        aug=photometric_params(("hue", "con", "blur"), flip=(0.0, 1.0)),
        keep={h: rng.random((B, T, FEAT)) >= 0.5 for h in ("pred_fine", "pred_displ")},
    )
    return batch, draws


@pytest.fixture(scope="module")
def acc_step():
    batch, draws = _inputs()
    with pytest.MonkeyPatch.context() as mp:
        variables, jax_loss, jax_state = _jax_step(mp, batch, draws, acc_grad_iter=ACC)
    augmented = [
        _jax_augmented({k: v[i * B:(i + 1) * B] for k, v in batch.items()}, draws)
        for i in range(ACC)
    ]
    port = _port_step(variables, batch, draws, torch.float32, augmented, acc_grad_iter=ACC)
    return jax_loss, jax_state, port


def test_acc_grad_loss_matches_jax_scan(acc_step):
    jax_loss, _, (_, loss, _) = acc_step
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, jax_loss, rtol=1e-4)


def test_acc_grad_bn_stats_match_jax_scan(acc_step):
    _, jax_state, (model, _, _) = acc_step
    _, stats, _ = convert_reference_state_dict(model.state_dict())
    got = flatten_dict(stats)
    want = flatten_dict(jax.tree.map(np.asarray, jax_state.batch_stats))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3, err_msg="/".join(k))
    # two micro-batches: every running statistic was updated twice
    counts = {int(v) for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")}
    assert counts == {ACC}


def test_acc_grad_mean_gradient_matches_jax_scan(acc_step):
    _, jax_state, (_, _, grads) = acc_step
    tree = convert_reference_state_dict({k: v.double() for k, v in grads.items()})[0]
    f = flatten_dict(tree)
    port = np.concatenate([np.asarray(f[k], np.float64).ravel() for k in sorted(f)])
    mu = flatten_dict(jax.tree.map(lambda m: np.asarray(m) / 0.1, jax_state.opt_state[0].mu))
    jax_g = np.concatenate([np.asarray(mu[k], np.float64).ravel() for k in sorted(mu)])
    assert np.linalg.norm(jax_g - port) / np.linalg.norm(port) < 5e-2
