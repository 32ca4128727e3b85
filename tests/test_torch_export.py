"""The port's serving artifact (infer/export.py, cli/export_model.py) on
the CPU: the export CLI writes a run's best checkpoint as two
``torch.export`` programs and a manifest; ``ExportedPredictor`` loads them
alone and reproduces the port's predict step bit for bit, and the JAX
package's ``ExportedPredictor`` (``platforms=("cpu",)``) on the same
weights at rtol 1e-4 / atol 1e-6.

Fixture: a fabricated finished run of tests.fixtures.write_tiny_config
(rny002_gsf at full widths, clip 8, crop 16, n_layers 1, fp32), its
checkpoint_best from a seeded port model, exported at batch 2 over
stored frames of 20x24 (center-cropped to 16 inside the programs).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from tdeed_tpu.config import load_config as jax_load_config
from tdeed_tpu.infer.export import ExportedPredictor as JaxExportedPredictor
from tdeed_tpu.infer.export import export_predictor as jax_export_predictor
from tdeed_tpu_torch import load_config
from tdeed_tpu_torch.checkpoint import BEST, save_params
from tdeed_tpu_torch.cli import export_model
from tdeed_tpu_torch.data.registry import load_classes
from tdeed_tpu_torch.infer.export import ExportedPredictor, export_predictor
from tdeed_tpu_torch.models.tdeed import build_model
from tdeed_tpu_torch.train.step import make_predict_step
from tests.fixtures import make_finediving_fixture, write_tiny_config
from tools.import_reference_checkpoint import convert_reference_state_dict

BATCH, HW = 2, (20, 24)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("export"))
    fx = make_finediving_fixture(root, num_videos=1, num_frames=24, size=16)
    config_root = write_tiny_config(root, fx, store_mode="load", dtype="float32", n_layers=1)
    cfg = load_config("FineDiving_tiny", config_root)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    os.makedirs(cfg.save_dir)
    save_params(os.path.join(cfg.save_dir, BEST), model)
    out_dir = os.path.join(root, "artifact")
    got = export_model.main(["FineDiving_tiny", out_dir, "--config_root", config_root,
                             "--data_root", fx["data_root"], "--batch_size", str(BATCH),
                             "--frame_hw", ",".join(map(str, HW)), "--device", "cpu"])
    frames = np.random.default_rng(0).integers(0, 256, (BATCH, cfg.clip_len, *HW, 3),
                                               dtype=np.uint8)
    # loading deserializes both programs (~20 s on one CPU core): once a module
    return dict(root=root, fx=fx, config_root=config_root, cfg=cfg, model=model,
                out_dir=got, frames=frames, ep=ExportedPredictor(got))


def test_export_cli_writes_the_artifact(run):
    """Both programs and the manifest, for the run's model."""
    assert sorted(os.listdir(run["out_dir"])) == ["manifest.json", "predict.pt2",
                                                  "predict_hflip.pt2"]
    m = run["ep"].manifest
    assert (m["model"], m["batch_size"], m["frame_hw"]) == ("FineDiving_tiny", BATCH, list(HW))
    assert m["platforms"] == ["cpu"] and m["torch_version"] == torch.__version__
    assert m["classes"] == load_classes(
        os.path.join(run["fx"]["data_root"], "finediving", "class.txt"))


@pytest.mark.parametrize("hflip", [False, True], ids=["plain", "hflip"])
def test_exported_predictor_equals_the_predict_step(run, hflip):
    """The programs from the files alone against make_predict_step over
    the checkpoint's model: the same bits; the TTA pass differs."""
    ep = run["ep"]
    cls, probs = ep(run["frames"], hflip=hflip)
    predict = make_predict_step(run["model"], crop_dim=run["cfg"].crop_dim,
                                radi_displacement=run["cfg"].radi_displacement)
    want_cls, want = predict(run["frames"], hflip)
    assert probs.shape == (BATCH, run["cfg"].clip_len, run["cfg"].num_classes + 1)
    assert torch.equal(probs, want) and torch.equal(cls, want_cls)
    assert not torch.equal(probs, ep(run["frames"], hflip=not hflip)[1])


def test_exported_programs_hold_no_profiler_ops(run):
    """The predict step's ``annotate`` regions (train/step.py,
    models/tdeed.py) stay out of the serving programs: no profiler op in
    either graph."""
    for hflip, module in run["ep"]._calls.items():
        targets = [str(n.target) for n in module.graph.nodes if n.op == "call_function"]
        assert targets and not [t for t in targets if "profiler" in t], hflip


@pytest.fixture(scope="module")
def jax_artifact(run):
    """The JAX package's export of the same weights (through
    convert_reference_state_dict), for the CPU."""
    params, stats, _ = convert_reference_state_dict(run["model"].state_dict())
    out_dir = os.path.join(run["root"], "jax_artifact")
    jax_export_predictor(jax_load_config("FineDiving_tiny", run["config_root"]), params, stats,
                         run["ep"].manifest["classes"], out_dir,
                         batch_size=BATCH, frame_hw=HW, platforms=("cpu",))
    return out_dir


def test_exported_predictor_matches_jax(run, jax_artifact):
    """The TTA pass, whose program holds the flip as well (each JAX pass
    costs a whole-model XLA compile on the CPU; both of the port's passes
    equal its predict step, which tests/test_torch_slice.py holds against
    JAX's for both)."""
    cls, probs = run["ep"](run["frames"], hflip=True)
    want_cls, want = JaxExportedPredictor(jax_artifact)(run["frames"], hflip=True)
    np.testing.assert_allclose(probs.numpy(), np.asarray(want), rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(cls.numpy(), np.asarray(want_cls))


def test_manifest_matches_jax(run, jax_artifact):
    """The same keys and values but two: ``platforms`` names the device
    type, ``torch_version`` replaces ``jax_version``."""
    with open(os.path.join(run["out_dir"], "manifest.json")) as fp:
        got = json.load(fp)
    with open(os.path.join(jax_artifact, "manifest.json")) as fp:
        want = json.load(fp)
    assert want.pop("platforms") == ["cpu"] and got.pop("platforms") == ["cpu"]
    assert "jax_version" in want and "jax_version" not in got
    want.pop("jax_version")
    got.pop("torch_version")
    assert got == want


def test_shape_contract_enforced(run):
    with pytest.raises(ValueError, match="pad ragged batches"):
        run["ep"](run["frames"][:1])  # batch 1 != exported 2


def test_cuda_export_and_load_need_a_card(run, monkeypatch, tmp_path):
    """No card: a cuda export raises (build_model's error) and so does
    loading an artifact made for cuda; neither falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_predictor(run["cfg"], run["model"].state_dict(), {"a": 1}, str(tmp_path / "x"))
    shutil.copytree(run["out_dir"], tmp_path / "cuda")
    with open(tmp_path / "cuda" / "manifest.json") as fp:
        manifest = json.load(fp)
    with open(tmp_path / "cuda" / "manifest.json", "w") as fp:
        json.dump(dict(manifest, platforms=["cuda"]), fp)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExportedPredictor(str(tmp_path / "cuda"))
