"""The port's CLIs on the CPU (``--device cpu``): ``cli.train`` in store
mode, then in load mode (train, val, best selection, test evaluation),
with criterion ``loss`` and ``map``, on tests.fixtures.make_finediving_fixture
and write_tiny_config (fp32, full rny002 widths, clip 8, crop 16, 4
optimizer steps an epoch, 2 epochs). The artifacts follow the JAX CLI's
schema: its history records' keys (read from tdeed_tpu/cli/train.py), its
CheckpointManager's train_meta.json keys and its MetricsLogger's
results_test.json keys. ``--resume`` continues the history and the step
count, an interrupt save resumes to the uninterrupted run's bits,
``only_test`` without a best checkpoint exits with its message,
``--profile_dir`` writes a trace, and ``cli.predict`` writes what
``SpottingPredictor.from_run`` spots.

The val split's events are rewritten densely (every other frame) so that
val mAP is above 0 and ``checkpoint_best`` is written under ``map`` too.
The configs are fp32: on the CPU, PyTorch's oneDNN bf16 convolution
backward leaves uninitialised the weight gradients of 3x3 taps that see
only padding (stride 2 over a 1x1 map, as at crop 16), which can be NaN.
"""

import ast
import contextlib
import io
import json
import math
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from tdeed_tpu.checkpoint import CheckpointManager as JaxCheckpointManager
from tdeed_tpu.utils.logging import MetricsLogger as JaxMetricsLogger
from tdeed_tpu_torch.checkpoint import LAST
from tdeed_tpu_torch.cli import predict as predict_cli
from tdeed_tpu_torch.cli import train as train_cli
from tdeed_tpu_torch.data.registry import get_spec
from tdeed_tpu_torch.infer.predictor import SpottingPredictor
from tdeed_tpu_torch.train import step as port_step
from tests.fixtures import make_finediving_fixture, write_tiny_config

REPO = Path(__file__).resolve().parents[1]
ARTIFACTS = ("checkpoint_best", "checkpoint_last", "train_meta.json", "loss.json",
             "pred-test.json", "results_test.json")


def _jax_record_keys():
    """The keys of the per-epoch record the JAX CLI builds."""
    tree = ast.parse((REPO / "tdeed_tpu" / "cli" / "train.py").read_text())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [getattr(t, "id", None) for t in node.targets] == ["record"]):
            return {k.value for k in node.value.keys}
    raise AssertionError("no record dict in tdeed_tpu/cli/train.py")


class Drive:
    """Runs the CLIs against one fixture tree, a config per model name."""

    def __init__(self, root):
        self.root = root
        self.fx = make_finediving_fixture(root, num_videos=2, num_frames=24)
        val = os.path.join(self.fx["data_root"], "finediving", "val.json")
        with open(val) as fp:
            metas = json.load(fp)
        for m in metas:
            m["events"] = [{"frame": f, "label": f"class{1 + f % 4}"}
                           for f in range(0, m["num_frames"], 2)]
            m["num_events"] = len(m["events"])
        with open(val, "w") as fp:
            json.dump(metas, fp)

    def config(self, model, **kw):
        kw = dict(dict(dtype="float32", num_epochs=2, store_mode="load"), **kw)
        return write_tiny_config(self.root, self.fx, model=model, **kw)

    def argv(self, model, *extra):
        return ["--model", model, "--config_root", os.path.join(self.root, "configs"),
                "--data_root", self.fx["data_root"], "--no_wandb", "--device", "cpu", *extra]

    def train(self, model, *extra):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            stats = train_cli.main(self.argv(model, *extra))
        return stats, out.getvalue()

    def store_and_train(self, model, *extra, **kw):
        self.config(model, store_mode="store", **kw)
        with pytest.raises(SystemExit) as exit_:
            train_cli.main(self.argv(model))
        assert exit_.value.code in (0, None)
        self.config(model, store_mode="load", **kw)
        return self.train(model, *extra)

    def run_dir(self, model):
        return os.path.join(self.fx["save_dir"], model)

    def meta(self, model):
        with open(os.path.join(self.run_dir(model), "train_meta.json")) as fp:
            return json.load(fp)

    def last(self, model):
        return torch.load(os.path.join(self.run_dir(model), LAST))


@pytest.fixture(scope="module")
def drive(tmp_path_factory):
    torch.set_num_threads(1)
    d = Drive(str(tmp_path_factory.mktemp("cli")))
    d.runs = {}
    d.profile_dir = os.path.join(d.root, "profile")
    for criterion, extra in (("loss", ()), ("map", ("--profile_dir", d.profile_dir))):
        model = f"FineDiving_{criterion}"
        stats, out = d.store_and_train(model, *extra, criterion=criterion)
        d.runs[criterion] = dict(stats=stats, out=out, meta=d.meta(model), last=d.last(model),
                                 files=set(os.listdir(d.run_dir(model))))
    # --resume with one more epoch
    d.config("FineDiving_loss", num_epochs=3)
    d.runs["resume"] = dict(zip(("stats", "out"), d.train("FineDiving_loss", "--resume")))
    d.runs["resume"]["meta"] = d.meta("FineDiving_loss")
    return d


@pytest.mark.parametrize("criterion", ["loss", "map"])
def test_train_cli_writes_the_jax_cli_artifacts(drive, criterion, tmp_path):
    run = drive.runs[criterion]
    assert "CORRECTLY FINISHED TRAINING AND INFERENCE" in run["out"]
    assert set(ARTIFACTS) <= run["files"], run["files"]
    assert not any(f.endswith(".tmp") for f in run["files"])
    meta = run["meta"]
    assert set(meta) == set(JaxCheckpointManager(str(tmp_path / "jax")).load_meta())
    assert [r["epoch"] for r in meta["history"]] == [0, 1]
    for r in meta["history"]:
        assert set(r) == _jax_record_keys()
        assert math.isfinite(r["train"]) and math.isfinite(r["val"])
        if criterion == "map":
            assert 0.0 < r["val_mAP"] <= 1.0
        else:
            assert r["val_mAP"] is None
    tols = list(get_spec("finediving").tolerances)
    JaxMetricsLogger(str(tmp_path / "jax"), None, False).log_test("test", [0.5] * len(tols), tols)
    with open(tmp_path / "jax" / "results_test.json") as fp:
        want_keys = set(json.load(fp))
    with open(os.path.join(drive.run_dir(f"FineDiving_{criterion}"), "results_test.json")) as fp:
        results = json.load(fp)
    assert set(results) == want_keys
    assert all(0.0 <= v <= 1.0 for v in results.values())
    stats = run["stats"]
    assert (stats["start_step"], stats["end_step"]) == (0, 8)
    assert [e["steps"] for e in stats["epochs"]] == [4, 4]
    assert run["last"]["step"] == 8


def test_resume_continues_the_history_and_the_step_count(drive):
    run = drive.runs["resume"]
    assert "Resumed at epoch 2, batch 0 (step 8)" in run["out"]
    stats = run["stats"]
    assert (stats["start_epoch"], stats["start_batch"], stats["start_step"]) == (2, 0, 8)
    assert stats["end_step"] == 12
    history = run["meta"]["history"]
    assert [r["epoch"] for r in history] == [0, 1, 2]
    assert history[:2] == drive.runs["loss"]["meta"]["history"]


def test_interrupt_save_resumes_to_the_uninterrupted_bits(drive, monkeypatch):
    """A KeyboardInterrupt before step 5 (epoch 1, batch 1) saves
    checkpoint_last; --resume continues there and ends with the bits of
    the straight run (criterion loss, 2 epochs)."""
    model = "FineDiving_interrupt"
    drive.config(model, criterion="loss")
    call = port_step.TrainStep.__call__

    def interrupted(self, batch, draws=None):
        if self.step == 5:
            raise KeyboardInterrupt
        return call(self, batch, draws)

    monkeypatch.setattr(port_step.TrainStep, "__call__", interrupted)
    with pytest.raises(KeyboardInterrupt):
        drive.train(model)
    monkeypatch.undo()
    assert drive.last(model)["step"] == 5
    stats, out = drive.train(model, "--resume")
    assert "Resumed at epoch 1, batch 1 (step 5)" in out
    assert stats["end_step"] == 8 and [e["steps"] for e in stats["epochs"]] == [3]
    got, want = drive.last(model), drive.runs["loss"]["last"]
    assert got["step"] == want["step"] == 8
    assert got["scheduler"] == want["scheduler"]
    for k, v in want["model"].items():
        assert torch.equal(got["model"][k], v), k
    for i, s in want["optimizer"]["state"].items():
        for k, v in s.items():
            assert torch.equal(got["optimizer"]["state"][i][k], v), (i, k)


def test_profile_dir_traces_training_steps(drive):
    """--profile_dir wraps steps 1-4 in a torch.profiler capture."""
    assert f"profiler trace -> {drive.profile_dir}" in drive.runs["map"]["out"]
    with open(os.path.join(drive.profile_dir, "trace.json")) as fp:
        events = json.load(fp)["traceEvents"]
    assert any(e.get("name") == "mixup" for e in events)


def test_only_test_without_a_best_checkpoint_exits(drive):
    drive.config("FineDiving_only", only_test=True)
    with pytest.raises(SystemExit, match="only_test=True but no checkpoint_best"):
        drive.train("FineDiving_only")


def test_predict_cli_writes_what_from_run_spots(drive, tmp_path):
    split = os.path.join(drive.fx["data_root"], "finediving", "test.json")
    out = tmp_path / "events.json"
    argv = ["--model", "FineDiving_map", "--config_root", os.path.join(drive.root, "configs"),
            "--data_root", drive.fx["data_root"], "--split", split, "--out", str(out),
            "--device", "cpu"]
    predict_cli.main(argv)
    payload = json.loads(out.read_text())
    pred = SpottingPredictor.from_run("FineDiving_map", os.path.join(drive.root, "configs"),
                                      drive.fx["data_root"], device="cpu")
    with open(split) as fp:
        metas = json.load(fp)
    want = pred.spot_many(pred.cfg.frame_dir, metas)
    assert payload == [{"video": v, "events": ev, "num_events": len(ev)}
                       for v, ev in json.loads(json.dumps(want)).items()]
    assert payload and all(e["label"].startswith("class") and 0 <= e["score"] <= 1
                           for p in payload for e in p["events"])
    assert np.isfinite([e["score"] for p in payload for e in p["events"]]).all()
