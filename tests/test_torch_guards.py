"""Guards of the PyTorch port: it never imports JAX, it builds the flagship
config and the SoccerNet Ball challenge config at full width and takes
every shipped config, its entry points run on CUDA unless asked for the
CPU, and it refuses the config values it does not carry yet with the
ROADMAP.md item that brings them."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tdeed_tpu_torch import load_config
from tdeed_tpu_torch.checkpoint import BEST, save_params
from tdeed_tpu_torch.cli import evaluate_challenge as challenge_cli
from tdeed_tpu_torch.cli import predict as predict_cli
from tdeed_tpu_torch.cli import train as train_cli
from tdeed_tpu_torch.infer.predictor import SpottingPredictor
from tdeed_tpu_torch.kernels.augment import _check
from tdeed_tpu_torch.models.tdeed import build_model, check_supported, two_heads_for
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train.step import make_predict_step, make_train_step, make_val_step
from tests.fixtures import make_finediving_fixture, write_tiny_config

REPO = Path(__file__).resolve().parents[1]
SHIPPED = sorted(p.stem for p in (REPO / "configs").glob("*/*.json"))


def test_importing_every_port_module_leaves_jax_out():
    """In a fresh interpreter: import every module of the package, then
    no jax/flax/optax module is loaded, and no module of the JAX package
    (the port keeps its own copy of the JAX-free config)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tdeed_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tdeed_tpu_torch.__path__, 'tdeed_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] == 'tdeed_tpu')\n"
        "new = [m for m in ('tdeed_tpu_torch.metrics.soccernet', "
        "'tdeed_tpu_torch.cli.evaluate_challenge') if m not in sys.modules]\n"
        "print(len(mods), new, bad, ref)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.split(" ", 1)
    assert int(out[0]) >= 47, out  # every module of the slice was imported
    assert out[1].strip() == "[] [] []"


def test_build_flagship_config_at_full_width():
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"))
    model = build_model(cfg, device="cpu")
    assert model.dtype == torch.bfloat16 and model.clip_len == 100
    assert model.feat_dim == 368
    assert model.temp_enc.shape == (100, 368)
    assert model._pred_fine._fc_out.out_features == cfg.num_classes + 1 == 5
    assert len(model._temp_fine._sgp) == 2 * cfg.n_layers + 1
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_build_model_defaults_to_cuda_and_never_falls_back(monkeypatch):
    """No device named: the CUDA device, and without one a RuntimeError
    that names device='cpu', never a module quietly left on the CPU."""
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), clip_len=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg, device="cuda:0")
    model = build_model(cfg, device="cpu")
    assert {p.device.type for p in model.parameters()} == {"cpu"}


@pytest.mark.parametrize(
    "override,item",
    [
        ({"fuse_entry": True}, "fused_block"),
        ({"fuse_shift": True}, "fused_block"),
        ({"checkpoint_backbone": True}, "checkpoint_backbone"),
        ({"feature_arch": "rny008_gsm"}, "GSM"),
        ({"feature_arch": "rny002_gsm"}, "GSM"),
        ({"feature_arch": "rny002"}, "plain rny002"),
    ],
)
def test_build_model_refuses_what_the_port_lacks(override, item):
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), **override)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        build_model(cfg, device="cpu")
    assert item in str(err.value)


@pytest.mark.parametrize("name", SHIPPED)
def test_every_shipped_config_is_taken(name):
    """check_supported and the training CLI's startup refusals take each of
    the 14 shipped configs: rny002_gsf and rny008_gsf, the SoccerNet and
    SoccerNet Ball datasets, joint pretraining."""
    cfg = load_config(name, config_root=str(REPO / "configs"))
    check_supported(cfg)
    train_cli.refuse_waiting(cfg, train_cli.get_args(["--model", name]))
    assert (two_heads_for(cfg) is None) == (cfg.pretrain is None)


def test_build_challenge_config_at_full_width():
    """SoccerNetBall_challenge2: rny008_gsf (feature width 768) with the
    FC2 double head, SoccerNet Ball's 12 classes and SoccerNet's 17, each
    with its background."""
    cfg = load_config("SoccerNetBall_challenge2", config_root=str(REPO / "configs"))
    model = build_model(cfg, two_heads_for(cfg), device="cpu")
    assert model.feat_dim == 768 and model.clip_len == 100
    assert model.two_heads == (13, 18)
    assert model._pred_fine._fc1._fc_out.out_features == 13
    assert model._pred_fine._fc2._fc_out.out_features == 18
    assert len(model._temp_fine._sgp) == 2 * cfg.n_layers + 1
    assert model.dropout_heads == ["pred_fine.fc1", "pred_fine.fc2", "pred_displ"]


def test_steps_take_two_heads_from_the_model():
    """Two heads build, and each step takes the heads from the model: head
    2's class weights, mixup over C1+1 + C2+1 classes, head 1's scores."""
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), clip_len=8,
                      dtype="float32")
    torch.manual_seed(0)
    model = build_model(cfg, two_heads=(5, 18), device="cpu")
    assert model._pred_fine._fc2._fc_out.out_features == 18
    opt, sched = make_optimizer(model.parameters(), 1e-3, 1, 10)
    step = make_train_step(model, opt, sched, crop_dim=32, num_classes_bg=5, mixup=True,
                           radi_displacement=2)
    assert step.two_heads == (5, 18) and step.total_bg == 23
    assert tuple(step.weights2.shape) == (18,)
    make_val_step(model, crop_dim=32, num_classes_bg=5, radi_displacement=2)
    predict = make_predict_step(model, crop_dim=32, radi_displacement=2)
    frames = np.random.default_rng(0).integers(0, 256, (1, 8, 36, 36, 3)).astype(np.uint8)
    assert predict(frames)[1].shape == (1, 8, 5)
    single = make_train_step(build_model(cfg, device="cpu"), opt, sched, crop_dim=32,
                             num_classes_bg=5, mixup=True, radi_displacement=2)
    assert single.two_heads is None and single.weights2 is None and single.total_bg == 5


@pytest.mark.parametrize(
    "make,item",
    [
        (lambda cfg: SpottingPredictor(cfg, {}, {"a": 1}, n_devices=2, device="cpu"), "DDP"),
        (lambda cfg: SpottingPredictor(cfg, {}, {"a": 1}, two_heads=(5, 18), n_devices=2,
                                       device="cpu"), "DDP"),
        (lambda cfg: SpottingPredictor(dataclasses.replace(cfg, checkpoint_backbone=True), {},
                                       {"a": 1}, device="cpu"),
         "checkpoint_backbone"),
        (lambda cfg: SpottingPredictor(dataclasses.replace(cfg, decoder="native"), {}, {"a": 1},
                                       device="cpu"),
         "native decoder"),
    ],
    ids=["n_devices", "two_heads-n_devices", "checkpoint_backbone", "native-decoder"],
)
def test_predictor_refuses_what_the_port_lacks(make, item):
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), clip_len=8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        make(cfg)
    assert item in str(err.value)


def test_predictor_scores_head_1_of_two_heads():
    """A double-head model's predictor scores SoccerNet Ball's 12 classes
    and background: head 1 alone."""
    cfg = load_config("SoccerNetBall_challenge2", config_root=str(REPO / "configs"),
                      clip_len=8, n_layers=1, dtype="float32")
    sd = build_model(cfg, two_heads_for(cfg), device="cpu").state_dict()
    classes = {f"c{i}": i for i in range(1, 13)}
    pred = SpottingPredictor(cfg, sd, classes, two_heads=two_heads_for(cfg), device="cpu")
    frames = np.random.default_rng(0).integers(0, 256, (1, 8, 32, 40, 3), dtype=np.uint8)
    probs = pred.predict_fn(frames, False)
    assert probs.shape == (1, 8, 13)
    assert bool(((probs >= 0) & (probs <= 1)).all())


def test_predictor_defaults_to_cuda_and_never_falls_back(monkeypatch):
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), clip_len=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpottingPredictor(cfg, {}, {"a": 1})


def _flagship_config(root, **override):
    """configs/FineDiving/FineDiving_small.json under ``root``, its paths
    moved there and ``override`` applied; returns the config root."""
    with open(REPO / "configs" / "FineDiving" / "FineDiving_small.json") as fp:
        raw = json.load(fp)
    raw.update(frame_dir=str(root / "frames"), save_dir=str(root / "save"),
               store_dir=str(root / "store"), **override)
    os.makedirs(root / "configs" / "FineDiving")
    with open(root / "configs" / "FineDiving" / "FineDiving_small.json", "w") as fp:
        json.dump(raw, fp)
    return str(root / "configs")


@pytest.mark.parametrize(
    "argv,override,item",
    [
        (["--n_devices", "2"], {}, "DDP"),
        (["--distributed"], {}, "DDP"),
        ([], {"backbone_ckpt": "/pretrained/rny002"}, "backbone_ckpt"),
        ([], {"feature_arch": "rny008_gsm"}, "GSM"),
    ],
    ids=["n_devices", "distributed", "backbone_ckpt", "gsm"],
)
def test_train_cli_refuses_what_the_port_lacks_at_startup(tmp_path, argv, override, item):
    """Before it reads a plan or writes anything."""
    config_root = _flagship_config(tmp_path, **override)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        train_cli.main(["--model", "FineDiving_small", "--config_root", config_root,
                        "--data_root", str(tmp_path / "data"), "--no_wandb", "--device", "cpu",
                        *argv])
    assert item in str(err.value)
    assert sorted(os.listdir(tmp_path)) == ["configs"]


def test_challenge_cli_refuses_several_cards_and_other_datasets(tmp_path):
    """--n_devices 2 names its ROADMAP item; a config of another dataset is
    refused; both before anything is read or written."""
    config_root = _flagship_config(tmp_path)
    argv = ["--config_root", config_root, "--data_root", str(tmp_path / "data"),
            "--device", "cpu"]
    with pytest.raises(ValueError, match="soccernetball"):
        challenge_cli.main(["--model", "FineDiving_small", *argv])
    with open(REPO / "configs" / "SoccerNetBall" / "SoccerNetBall_challenge2.json") as fp:
        raw = json.load(fp)
    os.makedirs(tmp_path / "configs" / "SoccerNetBall")
    with open(tmp_path / "configs" / "SoccerNetBall" / "SoccerNetBall_challenge2.json",
              "w") as fp:
        json.dump(dict(raw, save_dir=str(tmp_path / "save")), fp)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        challenge_cli.main(["--model", "SoccerNetBall_challenge2", "--n_devices", "2", *argv])
    assert "DDP" in str(err.value)
    assert sorted(os.listdir(tmp_path)) == ["configs"]


@pytest.mark.parametrize("cli", ["train", "predict", "evaluate_challenge"])
def test_clis_raise_without_cuda_and_never_fall_back(tmp_path, monkeypatch, cli):
    """No --device: the CUDA device, and without one the RuntimeError of
    build_model (after train's store mode, which needs no device), before
    any result is written."""
    fx = make_finediving_fixture(str(tmp_path), num_videos=1, num_frames=12, size=16)
    config_root = write_tiny_config(str(tmp_path), fx, store_mode="store")
    argv = ["--model", "FineDiving_tiny", "--config_root", config_root,
            "--data_root", fx["data_root"]]
    if cli == "evaluate_challenge":
        # a two-head SoccerNet Ball run with its best checkpoint
        with open(REPO / "configs" / "SoccerNetBall" / "SoccerNetBall_challenge2.json") as fp:
            raw = json.load(fp)
        os.makedirs(tmp_path / "configs" / "SoccerNetBall")
        with open(tmp_path / "configs" / "SoccerNetBall" / "SoccerNetBall_challenge2.json",
                  "w") as fp:
            json.dump(dict(raw, save_dir=str(tmp_path / "snb"), clip_len=8, n_layers=1), fp)
        os.makedirs(tmp_path / "data" / "soccernetball")
        with open(tmp_path / "data" / "soccernetball" / "class.txt", "w") as fp:
            fp.write("".join(f"c{i}\n" for i in range(1, 13)))
        cfg = load_config("SoccerNetBall_challenge2", str(tmp_path / "configs"))
        os.makedirs(cfg.save_dir)
        save_params(os.path.join(cfg.save_dir, BEST),
                    build_model(cfg, two_heads_for(cfg), device="cpu"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if cli == "train":
        with pytest.raises(SystemExit):
            train_cli.main(argv + ["--no_wandb"])
        write_tiny_config(str(tmp_path), fx, store_mode="load")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            train_cli.main(argv + ["--no_wandb"])
    elif cli == "predict":
        cfg = load_config("FineDiving_tiny", config_root)
        os.makedirs(cfg.save_dir)
        save_params(os.path.join(cfg.save_dir, BEST), build_model(cfg, device="cpu"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            predict_cli.main(argv + ["--videos", "01__01"])
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            challenge_cli.main(["--model", "SoccerNetBall_challenge2", "--config_root",
                                str(tmp_path / "configs"), "--data_root",
                                str(tmp_path / "data")])
        assert os.listdir(cfg.save_dir) == [BEST]


def _frames(shape, dtype=torch.uint8):
    return torch.zeros(shape, dtype=dtype)


@pytest.mark.parametrize(
    "frames,params,error",
    [
        (_frames((2, 3, 8, 8)), torch.zeros(2, 16), ValueError),  # no channel dim
        (_frames((2, 3, 8, 8, 4)), torch.zeros(2, 16), ValueError),  # 4 channels
        (_frames((2, 3, 8, 8, 3), torch.float32), torch.zeros(2, 16), TypeError),
        (_frames((2, 3, 8, 8, 3)), torch.zeros(3, 16), ValueError),  # params rows
        (_frames((2, 3, 8, 8, 3)), torch.zeros(2, 16, dtype=torch.float64), ValueError),
        (_frames((2, 3, 8, 8, 3)).transpose(2, 3), torch.zeros(2, 16), ValueError),
        (_frames((2, 3, 2, 8, 3)), torch.zeros(2, 16), ValueError),  # too small to blur
    ],
    ids=["rank", "channels", "dtype", "param-rows", "param-dtype", "strided", "tiny"],
)
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(frames, params, error):
    """The checks the CUDA wrapper runs before a launch."""
    with pytest.raises(error):
        _check(frames, params)
    _check(_frames((2, 3, 8, 8, 3)), torch.zeros(2, 16))  # a valid pair passes


def test_predict_step_output_contract():
    """Scores in [0, 1], argmax over the decoded scores, (B, T, C+1)."""
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"),
                      clip_len=8, dtype="float32")
    torch.manual_seed(0)
    predict = make_predict_step(build_model(cfg, device="cpu"), crop_dim=32, radi_displacement=2)
    frames = np.random.default_rng(0).integers(0, 256, (1, 8, 36, 36, 3)).astype(np.uint8)
    cls, probs = predict(frames)
    assert probs.shape == (1, 8, 5) and cls.shape == (1, 8)
    assert bool(((probs >= 0) & (probs <= 1)).all())
    assert torch.equal(cls, probs.argmax(-1))
