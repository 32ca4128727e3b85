"""A run trained by the port's CLI, served by both packages: the port's
``checkpoint_best``, carried to JAX trees by
``tools.import_reference_checkpoint.convert_reference_state_dict``, makes
the JAX ``SpottingPredictor`` spot the same events as the port's
``SpottingPredictor.from_run(..., device="cpu")``, within the serving
tolerances (rtol 1e-4, atol 1e-6).

Fixture: ``make_finediving_fixture`` at 16x16, ``write_tiny_config``
(clip 8, crop 16, PIL decoder, fp32, criterion loss, 1 epoch of 4
optimizer steps), trained by ``tdeed_tpu_torch.cli.train --device cpu``;
one test video, no TTA, so the JAX side compiles once.
"""

import json
import os

import numpy as np
import pytest
import torch

from tdeed_tpu import config as jax_config
from tdeed_tpu.infer.predictor import SpottingPredictor as JaxPredictor
from tdeed_tpu_torch.checkpoint import BEST
from tdeed_tpu_torch.cli import train as train_cli
from tdeed_tpu_torch.data.registry import load_classes
from tdeed_tpu_torch.infer.predictor import SpottingPredictor
from tests import torch_port_util  # noqa: F401  (one torch thread per worker)
from tests.fixtures import make_finediving_fixture, write_tiny_config
from tools.import_reference_checkpoint import convert_reference_state_dict

MODEL = "FineDiving_tiny"


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("from_run"))
    fx = make_finediving_fixture(root, num_videos=2, num_frames=24, size=16)
    kw = dict(decoder="pil", dtype="float32", criterion="loss")
    cfg_root = write_tiny_config(root, fx, store_mode="store", **kw)
    argv = ["--model", MODEL, "--config_root", cfg_root, "--data_root", fx["data_root"],
            "--no_wandb", "--device", "cpu"]
    with pytest.raises(SystemExit):
        train_cli.main(argv)
    write_tiny_config(root, fx, store_mode="load", **kw)
    train_cli.main(argv)

    port = SpottingPredictor.from_run(MODEL, cfg_root, fx["data_root"], device="cpu")
    state = torch.load(os.path.join(fx["save_dir"], MODEL, BEST))
    params, batch_stats, _ = convert_reference_state_dict(state)
    classes = load_classes(os.path.join(fx["data_root"], "finediving", "class.txt"))
    jax_pred = JaxPredictor(jax_config.load_config(MODEL, cfg_root), params, batch_stats,
                            classes)
    with open(os.path.join(fx["data_root"], "finediving", "test.json")) as fp:
        meta = json.load(fp)[0]
    return fx, port, jax_pred, meta


@pytest.mark.parametrize("nms", ["none", "snms"])
def test_checkpoint_best_spots_the_same_events_in_both_packages(served, nms):
    fx, port, jax_pred, meta = served
    assert next(port.model.parameters()).device.type == "cpu"
    kw = dict(hflip_tta=False, nms=nms)
    want = jax_pred.spot(fx["frame_dir"], meta["video"], meta["num_frames"], **kw)
    got = port.spot(fx["frame_dir"], meta["video"], meta["num_frames"], **kw)
    assert want, "the run must spot some events"
    assert [(e["label"], e["frame"]) for e in got] == [(e["label"], e["frame"]) for e in want]
    np.testing.assert_allclose([e["score"] for e in got], [e["score"] for e in want],
                               rtol=1e-4, atol=1e-6)
