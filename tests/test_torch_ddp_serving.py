"""Serving over several devices in one process, the ranks' rows of the
training loader, and ``pallas_augment``, on the CPU.

``SpottingPredictor(n_devices=2, device="cpu")`` keeps two replicas on the
CPU and splits every window batch between them, as it splits it over
cuda:0 and cuda:1 on a machine with two cards: its scores and events are
the one-device predictor's, bit for bit, with and without the TTA. The
two serving CLIs take ``--n_devices 2`` and write what they write with
one. Each rank's loader loads its rows of the same global batches
(parallel.mesh.global_rows), and the ranks' batches together are the
one-process batch. The train step runs the plain photometric chain with
``pallas_augment`` False and the kernel's wrapper otherwise.
"""

import json
import os

import numpy as np
import pytest
import torch

from tdeed_tpu_torch import load_config
from tdeed_tpu_torch.checkpoint import BEST, save_params
from tdeed_tpu_torch.cli import evaluate_challenge as challenge_cli
from tdeed_tpu_torch.cli import predict as predict_cli
from tdeed_tpu_torch.data.loader import BatchLoader
from tdeed_tpu_torch.infer.predictor import SpottingPredictor
from tdeed_tpu_torch.models.tdeed import build_model, two_heads_for
from tdeed_tpu_torch.parallel import mesh
from tdeed_tpu_torch.train import step as port_step
from tdeed_tpu_torch.train.schedule import make_optimizer
from tests.fixtures import make_finediving_fixture, write_tiny_config
from tests.test_torch_challenge import _config as challenge_config
from tests.test_torch_challenge import _dataset as challenge_dataset
from tests.torch_port_util import N_CLASSES  # noqa: F401  (one torch thread a worker)

CLASSES = {f"class{i}": i for i in range(1, 5)}


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("serve"))
    fx = make_finediving_fixture(root, num_videos=1, num_frames=40, size=40)
    cfg = load_config("FineDiving_small", config_root=os.path.join(
        os.path.dirname(__file__), "..", "configs"), clip_len=8, n_layers=1,
        dtype="float32", crop_dim=32, frame_dir=fx["frame_dir"])
    torch.manual_seed(0)
    return cfg, build_model(cfg, device="cpu").state_dict(), fx


@pytest.mark.parametrize("tta", [False, True], ids=["plain", "tta"])
def test_spot_over_two_replicas_is_one_device_bit_for_bit(video, tta):
    """Every (frame, class) score of the video, as events at threshold 0
    without NMS."""
    cfg, sd, fx = video
    preds = [SpottingPredictor(cfg, sd, CLASSES, device="cpu", n_devices=n) for n in (1, 2)]
    assert [len(p.devices) for p in preds] == [1, 2]
    assert [p.batch_size for p in preds] == [4, 4]
    got = [p.spot(fx["frame_dir"], "01__01", hflip_tta=tta, threshold=0.0, nms="none")
           for p in preds]
    assert len(got[0]) == 4 * 40 and got[0] == got[1]


def test_predictor_rounds_its_batch_to_a_multiple_of_its_replicas(video):
    cfg, sd, _ = video
    pred = SpottingPredictor(cfg, sd, CLASSES, device="cpu", n_devices=3)
    assert pred.batch_size == 6 and len(pred.devices) == 3
    probs = pred.predict_fn(np.zeros((6, 8, 36, 36, 3), np.uint8), False)
    assert probs.shape == (6, 8, 5)
    with pytest.raises(ValueError, match="does not split"):
        pred.predict_fn(np.zeros((4, 8, 36, 36, 3), np.uint8), False)


def test_predict_cli_takes_n_devices(tmp_path):
    """The same events JSON with --n_devices 2 as with one device."""
    fx = make_finediving_fixture(str(tmp_path), num_videos=1, num_frames=24)
    config_root = write_tiny_config(str(tmp_path), fx, store_mode="load", dtype="float32")
    cfg = load_config("FineDiving_tiny", config_root)
    os.makedirs(cfg.save_dir)
    torch.manual_seed(1)
    save_params(os.path.join(cfg.save_dir, BEST), build_model(cfg, device="cpu"))
    outs = []
    for n in ("1", "2"):
        out = str(tmp_path / f"events{n}.json")
        predict_cli.main(["--model", "FineDiving_tiny", "--config_root", config_root,
                          "--data_root", fx["data_root"], "--videos", "01__01", "--out", out,
                          "--device", "cpu", "--n_devices", n])
        with open(out) as fp:
            outs.append(json.load(fp))
    assert outs[0][0]["events"] and outs[0] == outs[1]


def test_challenge_cli_takes_n_devices(tmp_path):
    """The challenge game's results_spotting.json with --n_devices 2 is the
    one-device run's (tests/test_torch_challenge.py's synthetic games)."""
    root = str(tmp_path)
    frame_dir, data_root = challenge_dataset(root)
    argv = ["--config_root", os.path.join(root, "configs"), "--data_root", data_root,
            "--device", "cpu"]
    results = []
    for n in ("1", "2"):
        challenge_config(root, f"SoccerNetBall_n{n}", frame_dir, os.path.join(root, n))
        cfg = load_config(f"SoccerNetBall_n{n}", os.path.join(root, "configs"))
        torch.manual_seed(2)
        os.makedirs(cfg.save_dir)
        save_params(os.path.join(cfg.save_dir, BEST),
                    build_model(cfg, two_heads_for(cfg), device="cpu"))
        out = challenge_cli.main(["--model", f"SoccerNetBall_n{n}", "--n_devices", n, *argv])
        with open(os.path.join(out["preds_root"], "league/2020/c1",
                               "results_spotting.json")) as fp:
            results.append(json.load(fp)["predictions"])
    assert results[0] and results[0] == results[1]


class _RowSampler:
    """Each sample is its RNG's first draws: the row key decides it."""

    def sample(self, rng):
        return {"x": np.array([rng.random(), rng.random()])}


@pytest.mark.parametrize("acc_grad_iter", [1, 2])
def test_rank_loaders_together_load_the_one_process_batch(acc_grad_iter):
    """Batch b of an epoch over 2 ranks: rank r's rows are
    global_rows(8, acc, r, 2) of the one-process batch, bit for bit."""
    whole = list(BatchLoader(_RowSampler(), 8, 24, num_workers=2, seed=3).epoch(0))
    assert len(whole) == 3
    for r in range(2):
        rows = mesh.global_rows(8, acc_grad_iter, r, 2)
        part = list(BatchLoader(_RowSampler(), len(rows), 24, num_workers=2, seed=3,
                                global_batch_size=8, rows=rows).epoch(0))
        assert len(part) == 3
        for got, want in zip(part, whole):
            assert np.array_equal(got["x"], want["x"][rows])
    assert mesh.global_rows(8, 2, 1, 2) == [2, 3, 6, 7]


def test_global_rows_refuses_a_batch_that_does_not_split():
    with pytest.raises(ValueError, match="multiple of acc_grad_iter x ranks = 4"):
        mesh.global_rows(6, 2, 0, 2)
    with pytest.raises(ValueError, match="rows"):
        BatchLoader(_RowSampler(), 2, 24, global_batch_size=4, rows=[3, 4])


@pytest.mark.parametrize("pallas_augment,chain", [(None, "kernel"), (True, "kernel"),
                                                  (False, "plain")])
def test_train_step_picks_the_augment_chain(monkeypatch, pallas_augment, chain):
    """pallas_augment False calls train_preprocess_plain, None and True the
    kernel's wrapper (which on the CPU runs the same plain chain: the same
    loss)."""
    called = []
    for name, tag in (("train_preprocess", "kernel"), ("train_preprocess_plain", "plain")):
        fn = getattr(port_step, name)
        monkeypatch.setattr(port_step, name,
                            lambda f, p, fn=fn, tag=tag: called.append(tag) or fn(f, p))
    cfg = load_config("FineDiving_small", config_root=os.path.join(
        os.path.dirname(__file__), "..", "configs"), clip_len=8, n_layers=1, dtype="float32")
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    opt, sched = make_optimizer(model.parameters(), 1e-3, 1, 10)
    step = port_step.make_train_step(model, opt, sched, crop_dim=16, num_classes_bg=5,
                                     mixup=True, radi_displacement=2,
                                     pallas_augment=pallas_augment)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 256, (2, 8, 20, 20, 3)).astype(np.uint8)
             for k in ("frame", "frame2")}
    batch.update({k: rng.integers(0, 5, (2, 8)) for k in ("label", "label2")})
    loss = float(step(batch)["loss"])
    assert called == [chain] and np.isfinite(loss)
    assert step.pallas_augment is pallas_augment
