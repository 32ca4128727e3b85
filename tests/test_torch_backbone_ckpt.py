"""``checkpoint.load_backbone``: a timm RegNet-Y state dict file overlaid
onto the port's trunk gives, bit for bit, the weights the JAX package's
import gives (tools/import_timm_weights.py: ``convert_state_dict`` then
``merge_into_model``), carried to the port by params_from_jax; the
training CLI starts from such a file (``backbone_ckpt``).

The timm-layout file is made from a seed, as tests/test_timm_import.py
makes its state dict: every trunk key of timm's layout (the shifted
blocks' ``conv1.net.*`` under timm's ``conv1.*``, no ``gs``), BN counters,
and a classifier head that both sides skip.
"""

import os

import numpy as np
import pytest
import torch

from tdeed_tpu_torch.checkpoint import load_backbone
from tdeed_tpu_torch.models.tdeed import TDEED
from tdeed_tpu_torch.utils.jax_convert import params_from_jax
from tests.test_torch_cli import Drive
from tests.torch_port_util import N_CLASSES
from tools.import_reference_checkpoint import convert_reference_state_dict
from tools.import_timm_weights import convert_state_dict, merge_into_model

T = 8
MODEL = dict(n_layers=1, sgp_ks=3, sgp_r=2, radi_displacement=2)


def timm_state_dict(trunk_sd, seed=0):
    """A timm-layout RegNet-Y state dict for a trunk's state dict, values
    from ``seed``."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in trunk_sd.items():
        if ".gs." in k:
            continue
        k = k.replace(".conv1.net.", ".conv1.")
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.tensor(int(rng.integers(1, 100)))
        elif k.endswith("running_var"):
            sd[k] = torch.from_numpy(rng.uniform(0.5, 2.0, v.shape).astype(np.float32))
        else:
            sd[k] = torch.from_numpy(rng.normal(0, 0.3, v.shape).astype(np.float32))
    sd["head.fc.weight"] = torch.zeros(1000, 368)
    sd["head.fc.bias"] = torch.zeros(1000)
    return sd


def _model(shift_mode, seed=0):
    torch.manual_seed(seed)
    return TDEED(N_CLASSES, T, dtype=torch.float32, shift_mode=shift_mode, **MODEL)


@pytest.mark.parametrize("shift_mode", ["gsf", "gsm", None], ids=["gsf", "gsm", "plain"])
def test_load_backbone_gives_the_jax_import(tmp_path, shift_mode):
    """The port's overlay against the JAX import of the same file onto the
    same weights: every entry of the model's state_dict bit for bit; the
    shift modules keep their init, head.* is skipped."""
    model = _model(shift_mode)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    params, stats, _ = convert_reference_state_dict(model.state_dict())
    sd = timm_state_dict(model._features.state_dict())
    path = str(tmp_path / "regnety_002.pth")
    torch.save(sd, path)

    written = load_backbone(model, path)
    bp, bs = convert_state_dict(sd)
    merged = merge_into_model({"params": params, "batch_stats": stats}, bp, bs)
    want = params_from_jax(merged["params"], merged["batch_stats"])
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():  # BN counters: neither side takes timm's
        assert torch.equal(got[k], v), k
    assert all(not k.startswith("head.") for k in written.values())
    assert sorted(written.values()) == sorted(
        k for k in sd if not k.startswith("head.") and not k.endswith("num_batches_tracked"))
    kept = [k for k in got if ".gs." in k or not k.startswith("_features.")]
    assert kept and all(torch.equal(got[k], before[k]) for k in kept)
    assert (shift_mode is None) == (written.get("s3.b1.conv1.conv.weight")
                                    == "s3.b1.conv1.conv.weight")


@pytest.mark.parametrize("fault", ["missing", "shape", "directory"])
def test_load_backbone_refuses_what_does_not_fit(tmp_path, fault):
    """A kept key the trunk lacks, or of another shape, raises naming it
    (the JAX overlay_tree asserts the same); a directory (the JAX
    package's orbax backbone) is refused with the explanation."""
    model = _model("gsf")
    sd = timm_state_dict(model._features.state_dict())
    path = str(tmp_path / "backbone.pth")
    if fault == "missing":
        sd["s4.b9.conv1.conv.weight"] = torch.zeros(1)
        error, match = KeyError, "s4.b9.conv1.conv.weight"
    elif fault == "shape":
        sd["stem.conv.weight"] = torch.zeros(32, 3, 5, 5)
        error, match = ValueError, "stem.conv.weight"
    else:
        path = str(tmp_path)
        error, match = ValueError, "orbax"
    torch.save(sd, str(tmp_path / "backbone.pth"))
    with pytest.raises(error, match=match):
        load_backbone(model, path)


def test_train_cli_starts_from_backbone_ckpt(tmp_path, monkeypatch):
    """An rny002_gsm config with ``backbone_ckpt``: the CLI overlays the
    file after building the model and before the optimizer, prints the
    JAX CLI's line and trains from there."""
    from tdeed_tpu_torch import checkpoint as port_checkpoint
    from tdeed_tpu_torch.train import schedule

    drive = Drive(str(tmp_path))
    path = str(tmp_path / "regnety_002.pth")
    torch.save(timm_state_dict(_model("gsm")._features.state_dict(), seed=3), path)
    seen = []
    load = port_checkpoint.load_backbone

    def loading(model, p):
        written = load(model, p)
        trunk = model._features.state_dict()
        sd = torch.load(p)
        seen.append(all(torch.equal(trunk[k], sd[src]) for k, src in written.items()))
        return written

    make_optimizer = schedule.make_optimizer

    def making(*a, **kw):
        seen.append("optimizer")
        return make_optimizer(*a, **kw)

    monkeypatch.setattr(port_checkpoint, "load_backbone", loading)
    monkeypatch.setattr(schedule, "make_optimizer", making)
    stats, out = drive.store_and_train("FineDiving_gsm", feature_arch="rny002_gsm", n_layers=1,
                                       num_epochs=1, backbone_ckpt=path)
    assert seen == [True, "optimizer"]
    assert f"Loaded pretrained backbone <- {path}" in out
    assert stats["end_step"] > 0
    assert os.path.exists(os.path.join(drive.run_dir("FineDiving_gsm"), "checkpoint_last"))
