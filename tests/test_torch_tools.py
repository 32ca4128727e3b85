"""The port's tools on the CPU (``--device cpu``), held against the JAX
package's where both compute the same thing:

- validate_reference_checkpoint on a reference-layout ``.pt`` written from
  a port model: the same mAP table as tools/validate_reference_checkpoint.py
  on the same file (which converts it with tools/import_reference_checkpoint.py),
  the verdict both ways, and a port run directory in place of the file;
- overfit_check at a tiny size passes its rule;
- convergence_check: tests/test_torch_convergence_tool.py (a JAX step's
  compile, in a file of its own so that test workers take it apart);
- drive_e2e's first drive (store, train, evaluate, predict);
- tools/fixtures.py, the tools' copy of tests/fixtures.py: the same trees,
  and without PIL the committed fixture JPEGs linked in.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

from tdeed_tpu_torch.checkpoint import BEST, save_params
from tdeed_tpu_torch.config import load_config
from tdeed_tpu_torch.models.tdeed import build_model
from tdeed_tpu_torch.native import jpeg as native_jpeg
from tdeed_tpu_torch.tools import drive_e2e, overfit_check
from tdeed_tpu_torch.tools import fixtures as pfixtures
from tdeed_tpu_torch.tools import validate_reference_checkpoint as pvalidate
from tests import fixtures as jfixtures

T, HW = 4, 32  # the JAX gate test's clip and frame size


@pytest.fixture(scope="module")
def gate(tmp_path_factory):
    """A tiny fp32 config over a 1-train-video fixture, and a ``.pt`` of a
    port model's state_dict under the reference names."""
    root = tmp_path_factory.mktemp("gate")
    fx = jfixtures.make_finediving_fixture(str(root), num_videos=1, num_frames=24, size=HW)
    cfg_root = jfixtures.write_tiny_config(
        str(root), fx, model="FineDiving_gate", store_mode="load", clip_len=T, crop_dim=-1,
        n_layers=1, sgp_ks=3, sgp_r=2, dtype="float32")
    cfg_path = os.path.join(cfg_root, "FineDiving", "FineDiving_gate.json")
    torch.manual_seed(0)
    model = build_model(load_config(cfg_path), device="cpu")
    pt = root / "checkpoint_best.pt"
    torch.save(model.state_dict(), pt)
    run_dir = root / "run"
    run_dir.mkdir()
    save_params(str(run_dir / BEST), model)
    return {"fx": fx, "cfg": cfg_path, "pt": str(pt), "run_dir": str(run_dir)}


def _gate_argv(gate, checkpoint, expect):
    return ["--checkpoint", checkpoint, "--config", gate["cfg"],
            "--data_root", gate["fx"]["data_root"], "--expect", str(expect)]


def test_validate_reference_checkpoint_matches_the_jax_tool(gate, tmp_path, capsys):
    """The same mAP table as the JAX tool on the same .pt: the two forwards
    agree to ~1e-6 in fp32, so each mAP (x100, rounded to 4 decimals) within
    1e-3 points; --expect 1000 fails the gate on both sides; the port's own
    mAP passes it, through the .pt and through a port run directory, with
    the verdict line saying "within"."""
    from tools.validate_reference_checkpoint import main as jax_validate

    out = tmp_path / "gate.json"
    got = pvalidate.main(_gate_argv(gate, gate["pt"], 1000) + ["--device", "cpu",
                                                                "--out", str(out)])
    want = jax_validate(_gate_argv(gate, gate["pt"], 1000))
    table = sorted(k for k in want if k.startswith("map_"))
    assert table and sorted(k for k in got if k.startswith("map_")) == table
    for k in table:
        assert got[k] == pytest.approx(want[k], abs=1e-3), k
    assert 0.0 <= got["map_avg"] <= 100.0
    assert got["gate_pass"] is want["gate_pass"] is False
    assert got["tolerances"] == want["tolerances"] and got["device"] == "cpu"
    assert json.loads(out.read_text())["map_avg"] == got["map_avg"]
    capsys.readouterr()
    for checkpoint in (gate["pt"], gate["run_dir"]):
        res = pvalidate.main(_gate_argv(gate, checkpoint, got["map_avg"]) + ["--device", "cpu"])
        assert res["gate_pass"] is True and res["map_avg"] == got["map_avg"]
        verdict = [line for line in capsys.readouterr().out.splitlines()
                   if line.startswith("VERDICT")]
        assert len(verdict) == 1 and "PASS (within tolerance)" in verdict[0]


def test_validate_reference_checkpoint_refuses_foreign_keys(gate, tmp_path):
    """load_state_dict(strict=True): a key the model lacks is an error."""
    sd = torch.load(gate["pt"], weights_only=True)
    sd["extra.weight"] = torch.zeros(1)
    bad = tmp_path / "bad.pt"
    torch.save(sd, bad)
    with pytest.raises(RuntimeError, match="extra.weight"):
        pvalidate.main(_gate_argv(gate, str(bad), 0) + ["--device", "cpu"])


@pytest.mark.parametrize("tool", ["validate_reference_checkpoint", "overfit_check",
                                  "convergence_check"])
def test_tools_run_on_the_card_unless_asked_for_the_cpu(gate, monkeypatch, tool):
    """Without --device each tool asks for the CUDA device, and without one
    it raises before it trains or evaluates anything."""
    from tdeed_tpu_torch.tools import convergence_check

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    run = {"validate_reference_checkpoint": lambda: pvalidate.main(
               _gate_argv(gate, gate["pt"], 0)),
           "overfit_check": lambda: overfit_check.main([]),
           "convergence_check": lambda: convergence_check.main([])}[tool]
    with pytest.raises(RuntimeError, match="CUDA"):
        run()


def test_overfit_check_passes_its_rule_at_a_tiny_size(capsys):
    """clip 8, crop 16, fp32, 80 steps: the loss falls below a quarter of
    the first and below the target, 2.5 at this size (the default 1.0 is
    for the default 150 steps at clip 16, crop 64). The augmentation stays
    on, so the loss moves by ~1 between steps; at 80 steps it has ended at
    1.2-1.9 from a first 9.5 on 1, 2 and 8 threads."""
    res = overfit_check.main(["--device", "cpu", "--steps", "80", "--clip_len", "8",
                              "--crop", "16", "--dtype", "float32", "--target", "2.5"])
    assert res["last"] < 2.5 and res["last"] < res["first"] * 0.25
    assert "OVERFIT CHECK PASSED" in capsys.readouterr().out
    assert len(res["losses"]) == 80 and all(map(np.isfinite, res["losses"]))


def test_drive_e2e_first_drive_runs_on_the_cpu(tmp_path):
    out = drive_e2e.drive_finediving(str(tmp_path), device="cpu")
    assert out["train"]["end_step"] > 0
    assert os.path.exists(os.path.join(out["run_dir"], "checkpoint_best"))
    assert all(e["label"].startswith("class") for p in out["predict"] for e in p["events"])


def test_tool_fixtures_equal_the_tests_fixtures(tmp_path):
    trees = []
    for mod in (pfixtures, jfixtures):
        root = tmp_path / mod.__name__.replace(".", "_")
        fx = mod.make_finediving_fixture(str(root), num_videos=1, num_frames=5, size=24)
        mod.write_tiny_config(str(root), fx, store_mode="load", dtype="float32")
        trees.append({
            os.path.relpath(os.path.join(d, f), root): open(os.path.join(d, f), "rb").read()
            for d, _, files in os.walk(root) for f in files})
    assert sum(k.endswith(".jpg") for k in trees[0]) == 15  # 3 videos of 5 frames
    cfg = "configs/FineDiving/FineDiving_tiny.json"
    for t in trees:
        t[cfg] = {k: v for k, v in json.loads(t[cfg]).items() if not k.endswith("_dir")}
    assert trees[0] == trees[1]


def test_without_pil_the_fixture_jpegs_are_linked(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "PIL", None)  # `from PIL import Image` raises
    path = tmp_path / "frame0.jpg"
    pfixtures.write_jpeg(str(path), np.zeros((24, 32, 3), np.uint8))
    assert path.is_symlink()
    assert os.path.realpath(path) == pfixtures.fixture_jpegs(24, 32)[0]
    assert native_jpeg.decode(str(path)).shape == (24, 32, 3)
    assert len(pfixtures.fixture_jpegs(256, 256)) == 3
    with pytest.raises(FileNotFoundError, match="17x19"):
        pfixtures.write_jpeg(str(tmp_path / "x.jpg"), np.zeros((17, 19, 3), np.uint8))
