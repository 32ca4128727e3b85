"""The port's GSM and plain RegNet-Y trunks, and ``checkpoint_backbone``,
against the JAX package's, same weights (through params_from_jax) and
inputs, in fp32.

GSM's gate conv is zero-initialised, so at init it only regroups
channels; every GSM here gets seeded nonzero gate weights and bias, so
the gating, the shift and the residual are all exercised.

Fixtures: the full rny002 widths, clip_len 8, n_layers 1, sgp_ks 3, as in
tests/test_torch_train_step.py, whose step-0 helpers run both sides with
the same injected draws (the JAX kernel's output is the port's augmented
input). Tolerances, with what was measured on these fixtures: the GSM
module at atol 1e-5 (as tests/test_torch_modules.py holds GSF); the eval
forward's logits and displacement at atol 1e-4 (as
tests/test_torch_rny008.py); the step-0 loss at rtol 1e-4 (as the GSF
step-0 test; measured 2e-5). The step-0 fixture draws its gates from
N(0, 0.05), the others from N(0, 0.2): there the tanh gates saturate and
train-mode BN over 1x1 maps amplifies fp32 rounding, which puts JAX's
fp32 loss 3.9e-4 from the port's (3.4e-4 from the port's float64 run,
the port's fp32 run 5e-5 from it, which
test_gsm_step0_fp32_loss_at_saturating_gates_holds_to_float64 holds);
with JAX's reductions widened to float64 as well, the two train-mode
trunks agree to 7e-12. ``checkpoint_backbone`` recomputes the same fp32 ops, so on
and off give the same loss and running statistics, and gradients within
1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.traverse_util import flatten_dict, unflatten_dict

import tdeed_tpu.models.shift as jshift
from tdeed_tpu.models.tdeed import TDEED as JaxTDEED
from tdeed_tpu_torch.models import regnet, shift
from tdeed_tpu_torch.models.common import SplitBatchNorm
from tdeed_tpu_torch.models.tdeed import TDEED
from tdeed_tpu_torch.utils.jax_convert import params_from_jax
from tests.test_torch_train_step import CROP, MODEL, T, _inputs, _jax_augmented, _jax_step, _port_step
from tests.torch_port_util import N_CLASSES, assert_trees_close, port_state, to_np
from tools.import_reference_checkpoint import convert_reference_state_dict

B = 2


def _with_gates(params, rng):
    """JAX ``params`` with seeded nonzero weights and bias in every GSM
    gate (gate_conv/{kernel, bias}, zero at init)."""
    flat = flatten_dict(jax.tree.map(np.asarray, params))
    for k, v in flat.items():
        if len(k) >= 2 and k[-2] == "gate_conv":
            flat[k] = rng.normal(0, 0.2, v.shape).astype(np.float32)
    return unflatten_dict(flat)


def _running_stats(batch_stats, rng):
    flat = flatten_dict(jax.tree.map(np.asarray, batch_stats))
    return unflatten_dict({
        k: (rng.normal(0, 0.2, v.shape) if k[-1] == "mean"
            else rng.uniform(0.5, 2.0, v.shape)).astype(np.float32)
        for k, v in flat.items()
    })


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_gsm_gated_shift_matches_jax(rng, train):
    """The bare GatedShift in GSM mode (net=Identity) with nonzero gate
    weights: the first fold channels gated, shifted and regrouped, the
    rest passed through; train mode also updates the GSM BN statistics."""
    c = 40  # fold_dim_for(40) = 12: a ragged fold
    x = rng.standard_normal((B * 4, 5, 6, c)).astype(np.float32)
    jm = jshift.GatedShift(clip_len=4, mode="gsm", dtype=jnp.float32)
    v = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), False)
    v = {"params": _with_gates(v["params"], rng), "batch_stats": v["batch_stats"]}
    assert np.abs(v["params"]["gs"]["gate_conv"]["kernel"]).min() > 0
    pm = shift.GatedShift(c, 4, net=torch.nn.Identity(), mode="gsm")
    assert isinstance(pm.gs, shift.GSM)
    pm.load_state_dict(port_state({"features": {"s3_b1": {"gs": v["params"]}}},
                                  {"features": {"s3_b1": {"gs": v["batch_stats"]}}},
                                  "_features.s3.b1.conv1."), strict=True)
    pm.train(train)
    with torch.no_grad():
        got = to_np(pm(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1))
    np.testing.assert_array_equal(got[..., 12:], x[..., 12:])
    if train:
        want, upd = jax.jit(lambda v_, x_: jm.apply(v_, x_, True, mutable=["batch_stats"]))(
            v, jnp.asarray(x))
        bn = upd["batch_stats"]["gs"]["bn"]
        np.testing.assert_allclose(to_np(pm.gs.bn.running_mean), bn["mean"], rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(to_np(pm.gs.bn.running_var), bn["var"], rtol=1e-4, atol=1e-5)
    else:
        want = jm.apply(v, jnp.asarray(x), False)
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


def test_gsm_gate_starts_at_zero():
    """Zero-init gate (ref: gsm.py:76-77): at init GSM only regroups the
    channels, as the JAX module does."""
    g = shift.GSM(8)
    assert not g.conv3D.weight.any() and not g.conv3D.bias.any()
    x = torch.randn(1, 3, 2, 2, 8)
    with torch.no_grad():
        out = g.eval()(x)
    np.testing.assert_array_equal(
        to_np(out), np.asarray(jshift._interleave_halves(jnp.asarray(x[..., :4].numpy()),
                                                         jnp.asarray(x[..., 4:].numpy()))))


def _port_model(shift_mode, seed, gate_std=0.2):
    """A port TDEED (fp32) with seeded weights, GSM gates drawn from
    N(0, gate_std) and seeded running statistics, and its JAX trees
    (convert_reference_state_dict, the bridge tests/test_reference_import.py
    holds)."""
    torch.manual_seed(seed)
    pm = TDEED(N_CLASSES, T, dtype=torch.float32, shift_mode=shift_mode, **MODEL)
    with torch.no_grad():
        for m in pm.modules():
            if isinstance(m, shift.GSM):
                torch.nn.init.normal_(m.conv3D.weight, 0, gate_std)
                torch.nn.init.normal_(m.conv3D.bias, 0, gate_std)
            elif isinstance(m, SplitBatchNorm):
                torch.nn.init.normal_(m.running_mean, 0, 0.2)
                torch.nn.init.uniform_(m.running_var, 0.5, 2.0)
    params, stats, _ = convert_reference_state_dict(pm.state_dict())
    return pm, params, stats


@pytest.fixture(scope="module", params=["rny002_gsm", "rny002"])
def jax_model(request):
    """The arch's JAX TDEED, JAX trees from a seeded port model, and a
    batch of standardized-scale frames."""
    arch = request.param
    jm = JaxTDEED(num_classes=N_CLASSES, clip_len=T, feature_arch=arch, dtype=jnp.float32,
                  **MODEL)
    _, params, stats = _port_model("gsm" if arch.endswith("_gsm") else None, seed=31)
    frames = np.random.default_rng(31).standard_normal((B, T, CROP, CROP, 3)).astype(np.float32)
    return arch, jm, params, stats, frames


def test_state_dict_bridge_round_trips(jax_model):
    """JAX trees -> port (strict load) -> convert_reference_state_dict ->
    the same trees, bit for bit: GSM's gate at gate_conv/{kernel, bias};
    a plain block's conv1 at conv1.* (no gs, no net)."""
    arch, _, params, stats, _ = jax_model
    shift_mode = "gsm" if arch.endswith("_gsm") else None
    pm = TDEED(N_CLASSES, T, dtype=torch.float32, shift_mode=shift_mode, **MODEL)
    pm.load_state_dict(params_from_jax(params, stats), strict=True)
    keys = pm.state_dict().keys()
    assert ("_features.s3.b1.conv1.gs.conv3D.weight" in keys) == (shift_mode == "gsm")
    assert ("_features.s3.b1.conv1.conv.weight" in keys) == (shift_mode is None)
    assert not any("channel_conv" in k for k in keys)
    p2, s2, _ = convert_reference_state_dict(pm.state_dict())
    assert_trees_close(p2, params, rtol=0, atol=0)
    assert_trees_close(s2, jax.tree.map(np.asarray, stats), rtol=0, atol=0)


def test_eval_forward_matches_jax(jax_model):
    """The full eval forward (running statistics, no dropout): logits and
    displacement at atol 1e-4."""
    arch, jm, params, stats, frames = jax_model
    want = jax.jit(lambda p, s, x: jm.apply({"params": p, "batch_stats": s}, x, False))(
        params, stats, jnp.asarray(frames))
    shift_mode = "gsm" if arch.endswith("_gsm") else None
    pm = TDEED(N_CLASSES, T, dtype=torch.float32, shift_mode=shift_mode, **MODEL)
    pm.load_state_dict(params_from_jax(params, stats), strict=True)
    with torch.no_grad():
        got = pm.eval()(torch.from_numpy(frames))
    for k in ("logits", "displ"):
        np.testing.assert_allclose(to_np(got[k]), np.asarray(want[k]), rtol=0, atol=1e-4,
                                   err_msg=k)


@pytest.fixture(scope="module")
def step0_inputs():
    """The step-0 batch and draws, and the JAX kernel's output on them."""
    batch, draws = _inputs()
    return batch, draws, [_jax_augmented(batch, draws)]


@pytest.fixture(scope="module")
def gsm_step0(step0_inputs):
    """Step 0 of rny002_gsm, from JAX weights with nonzero gates: JAX's
    step with checkpoint_backbone on (flax's nn.remat over the trunk), and
    the port's with the knob off and on, each given the JAX kernel's
    output as its augmented input."""
    batch, draws, augmented = step0_inputs
    _, params, stats = _port_model("gsm", seed=8, gate_std=0.05)
    v = {"params": params, "batch_stats": stats}
    with pytest.MonkeyPatch.context() as mp:
        _, jax_loss, jax_state = _jax_step(mp, batch, draws, variables=v,
                                           feature_arch="rny002_gsm", checkpoint_backbone=True)
    port = {ck: _port_step(v, batch, draws, torch.float32, augmented, shift_mode="gsm",
                           checkpoint_backbone=ck)
            for ck in (False, True)}
    return jax_loss, jax_state, port


def test_gsm_step0_loss_matches_jax(gsm_step0):
    """The port's rny002_gsm step-0 loss, knob off and on, against JAX's
    at rtol 1e-4."""
    jax_loss, _, port = gsm_step0
    for ck, (_, loss, _) in port.items():
        assert np.isfinite(loss)
        np.testing.assert_allclose(loss, jax_loss, rtol=1e-4, err_msg=f"checkpoint {ck}")


def test_gsm_step0_fp32_loss_at_saturating_gates_holds_to_float64(step0_inputs):
    """The witness behind the step-0 fixture's narrower gates: with gates
    of N(0, 0.2), the port's fp32 step-0 loss against its own float64 loss
    at rtol 1e-4 (measured 5e-5). JAX's fp32 loss on these weights lands
    3.4e-4 from the port's float64 one; if this test fails, the gap is
    the port's own fp32 rounding, not JAX's, and the comparison to re-run
    is JAX's step with its reductions in float64 against the port's
    float64 step (they agreed to 7e-12)."""
    batch, draws, augmented = step0_inputs
    _, params, stats = _port_model("gsm", seed=8, gate_std=0.2)
    v = {"params": params, "batch_stats": stats}
    losses = [_port_step(v, batch, draws, dt, augmented, shift_mode="gsm")[1]
              for dt in (torch.float32, torch.float64)]
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


def test_checkpoint_backbone_changes_no_number(gsm_step0):
    """On and off: the same loss and running statistics, gradients within
    1e-6; each BN counter rises by exactly 1 (the recompute writes none),
    and the running statistics match JAX's remat step at atol 1e-3, as
    the GSF step-0 test holds them."""
    _, jax_state, port = gsm_step0
    (m_off, loss_off, g_off), (m_on, loss_on, g_on) = port[False], port[True]
    assert loss_on == loss_off
    for name in g_off:
        np.testing.assert_allclose(to_np(g_on[name]), to_np(g_off[name]), rtol=0, atol=1e-6,
                                   err_msg=name)
    sd_off, sd_on = m_off.state_dict(), m_on.state_dict()
    counters = 0
    for k, t in sd_on.items():
        if k.endswith("num_batches_tracked"):
            assert int(t) == 1, k
            counters += 1
        elif "running_" in k:
            assert torch.equal(t, sd_off[k]), k
    assert counters == sum(1 for m in m_on.modules() if m.__class__.__name__ == "SplitBatchNorm")
    _, stats, _ = convert_reference_state_dict(sd_on)
    assert_trees_close(stats, jax.tree.map(np.asarray, jax_state.batch_stats),
                       rtol=1e-3, atol=1e-3)


def test_checkpoint_backbone_recomputes_each_block(monkeypatch):
    """With the knob on, a train-mode backward runs every BN of the trunk a
    second time (the recompute of each checkpointed unit), with its
    running statistics frozen there; in eval or without grad nothing is
    recomputed."""
    from tdeed_tpu_torch.models import common

    torch.manual_seed(0)
    trunk = regnet.RegNetY("rny002", clip_len=4, shift_mode="gsm", checkpoint_blocks=True)
    n_bn = sum(isinstance(m, common.SplitBatchNorm) for m in trunk.modules())
    calls = []
    forward = common.SplitBatchNorm.forward
    monkeypatch.setattr(common.SplitBatchNorm, "forward",
                        lambda self, x: calls.append(self.update_stats) or forward(self, x))
    x = torch.randn(8, 3, 32, 32).contiguous(memory_format=torch.channels_last)
    out = trunk.train()(x)
    assert calls == [True] * n_bn
    out.sum().backward()
    assert calls == [True] * n_bn + [False] * n_bn
    assert int(trunk.stem.bn.num_batches_tracked) == 1
    calls.clear()
    with torch.no_grad():
        trunk(x)
    trunk.eval()(x).sum().backward()
    assert calls == [True] * (2 * n_bn)
