"""The port's convergence tool (tdeed_tpu_torch/tools/convergence_check.py)
on the CPU: ``--steps 3 --device cpu`` writes the JAX tool's one-side keys
(suffix ``_port``), and its step-0 loss is held against
tools/convergence_check.py:jax_run from the port's initial weights,
converted by tools/import_reference_checkpoint.py, on the same batches."""

import json

import numpy as np
import pytest

from tdeed_tpu_torch.tools import convergence_check as pcc
from tests import fixtures as jfixtures


def test_convergence_check_step0_loss_matches_the_jax_tool(tmp_path, monkeypatch):
    """The port's --steps 3 against tools/convergence_check.py:jax_run from the
    port's initial weights (converted by tools/import_reference_checkpoint.py)
    on the same 8 batches, with the JAX tool's stochastic stages off: step-0
    loss within rtol 1e-4 (fp32 on both sides, the same convolutions summed
    in other orders)."""
    import jax
    import jax.numpy as jnp
    from flax import linen as fnn

    from tdeed_tpu.checkpoint import overlay_tree
    from tdeed_tpu.models.tdeed import TDEED
    from tdeed_tpu.train import augment as jaugment
    from tools import convergence_check as jcc
    from tools.import_reference_checkpoint import convert_reference_state_dict

    out = tmp_path / "port.json"
    res = pcc.main(["--steps", "3", "--device", "cpu", "--out", str(out)])
    assert json.loads(out.read_text()) == res
    assert {"loss0_port", "tail20_port", "best_epoch_port", "val_losses_port", "map_port",
            "maps_per_tol_port", "sec_port", "steps", "mixup", "tolerances"} <= set(res)
    assert np.isfinite(res["loss0_port"]) and 0.0 <= res["map_port"] <= 1.0

    fx = jfixtures.make_finediving_fixture(str(tmp_path), num_videos=2, num_frames=48,
                                           size=pcc.SIZE)
    batches = jcc.build_batches(fx, 8)
    for got, want in zip(pcc.build_batches(fx, 8), batches):
        for k in ("frame", "label", "labelD"):
            np.testing.assert_array_equal(got[k], want[k])

    # the JAX tool's neutralize_stochastic_stages, undone after the test
    monkeypatch.setattr(jaugment, "train_preprocess", lambda frames, key, crop:
                        jaugment.standardize(frames.astype(jnp.float32) / 255.0))
    monkeypatch.setattr(fnn, "Dropout", lambda rate, deterministic=None: (lambda x: x))
    model = TDEED(num_classes=pcc.NUM_CLASSES, clip_len=pcc.CLIP_LEN,
                  feature_arch="rny002_gsf", n_layers=pcc.N_LAYERS, sgp_ks=pcc.KS,
                  sgp_r=pcc.K, radi_displacement=1, dtype=jnp.float32)
    variables = jax.tree.map(np.asarray, jax.jit(model.init, static_argnums=2)(
        jax.random.PRNGKey(0), jnp.zeros((1, pcc.CLIP_LEN, pcc.SIZE, pcc.SIZE, 3)), False))
    params, stats, _ = convert_reference_state_dict(pcc.initial_model("cpu").state_dict())
    overlay_tree(variables["params"], params)
    overlay_tree(variables["batch_stats"], stats)
    losses, _, _ = jcc.jax_run(batches, batches[:2], 1, model, variables["params"],
                               variables["batch_stats"], 0, 3)
    assert res["loss0_port"] == pytest.approx(losses[0], rel=1e-4)
