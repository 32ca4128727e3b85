"""Guards of the PyTorch port: it never imports JAX, it builds the flagship
config and the SoccerNet Ball challenge config at full width, takes every
shipped config and trains every feature_arch the JAX package builds, its
entry points run on CUDA unless asked for the CPU, it takes the
fused-block knobs (the JAX package's alone) and builds the same model, and
its data-parallel entry points refuse, before
anything is read or written, only what they cannot run: more ranks or
replicas than cards, a batch that does not split into acc_grad_iter x
ranks, --distributed outside a torchrun launch."""

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
from tdeed_tpu_torch.cli import export_model as export_cli
from tdeed_tpu_torch.cli import predict as predict_cli
from tdeed_tpu_torch.cli import train as train_cli
from tdeed_tpu_torch.infer.predictor import SpottingPredictor
from tdeed_tpu_torch.kernels.augment import _check
from tdeed_tpu_torch.models.tdeed import build_model, check_supported, two_heads_for
from tdeed_tpu_torch.native import jpeg as native_jpeg
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train.step import make_predict_step, make_train_step, make_val_step
from tests.fixtures import make_finediving_fixture, write_tiny_config

REPO = Path(__file__).resolve().parents[1]
SHIPPED = sorted(p.stem for p in (REPO / "configs").glob("*/*.json"))


def test_importing_every_port_module_leaves_jax_out():
    """In a fresh interpreter: import every module of the package, then
    no jax/flax/optax module is loaded, no module of the JAX package (the
    port keeps its own copy of the JAX-free config) and none of the repo's
    JAX-side ``tools`` (the port's measuring tools keep their own copies)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import tdeed_tpu_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(tdeed_tpu_torch.__path__, 'tdeed_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax'))\n"
        "ref = sorted(m for m in sys.modules if m.split('.')[0] in ('tdeed_tpu', 'tools'))\n"
        "new = [m for m in ('tdeed_tpu_torch.metrics.soccernet', "
        "'tdeed_tpu_torch.cli.evaluate_challenge', 'tdeed_tpu_torch.infer.export', "
        "'tdeed_tpu_torch.cli.export_model', 'tdeed_tpu_torch.parallel', "
        "'tdeed_tpu_torch.parallel.mesh', 'tdeed_tpu_torch.native.jpeg', "
        "'tdeed_tpu_torch.cli.extract_frames', 'tdeed_tpu_torch.tools.fixtures', "
        "'tdeed_tpu_torch.tools.validate_reference_checkpoint', "
        "'tdeed_tpu_torch.tools.overfit_check', 'tdeed_tpu_torch.tools.drive_e2e', "
        "'tdeed_tpu_torch.tools.convergence_check', "
        "'tdeed_tpu_torch.tools.bench', 'tdeed_tpu_torch.tools.bench_snb', "
        "'tdeed_tpu_torch.tools.bench_input', 'tdeed_tpu_torch.tools.profile_step', "
        "'tdeed_tpu_torch.tools.profile_infer', 'tdeed_tpu_torch.tools.measure') "
        "if m not in sys.modules]\n"
        "print(len(mods), new, bad, ref)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.split(" ", 1)
    assert int(out[0]) >= 66, out  # every module of the slice was imported
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


@pytest.mark.parametrize("override", [{"fuse_entry": True}, {"fuse_shift": True},
                                      {"fuse_entry": True, "fuse_shift": True}])
def test_build_model_and_train_cli_take_the_fused_block_knobs(override):
    """fuse_entry and fuse_shift, alone or together, which only the JAX
    package reads: the training CLI's startup checks pass, and build_model
    builds the model of the config without them, the same modules and
    state_dict keys and, from one seed, the same weights."""
    name = "FineDiving_small"
    root = str(REPO / "configs")
    cfg = load_config(name, config_root=root, clip_len=8, **override)
    train_cli.refuse_waiting(cfg, train_cli.get_args(["--model", name]))
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    torch.manual_seed(0)
    plain = build_model(load_config(name, config_root=root, clip_len=8), device="cpu")
    assert repr(model) == repr(plain)
    got, want = model.state_dict(), plain.state_dict()
    assert list(got) == list(want)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert not model.eager_only


@pytest.mark.parametrize(
    "arch,checkpoint_backbone",
    [(a, False) for a in ("rny002", "rny008", "rny002_gsm", "rny008_gsm", "rny002_gsf",
                          "rny008_gsf")] + [("rny008_gsm", True)],
)
def test_build_model_trains_every_feature_arch(arch, checkpoint_backbone):
    """Every feature_arch the JAX package builds, {rny002, rny008} x
    {plain, _gsm, _gsf}, and checkpoint_backbone: the trunk, shift and
    widths the name says, and one train step on the CPU with a finite
    loss that moves the trunk."""
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), clip_len=8,
                      dtype="float32", n_layers=1, feature_arch=arch,
                      checkpoint_backbone=checkpoint_backbone)
    torch.manual_seed(0)
    model = build_model(cfg, device="cpu")
    trunk = model._features
    assert trunk.checkpoint_blocks == checkpoint_backbone
    assert model.feat_dim == (368 if arch.startswith("rny002") else 768)
    conv1 = trunk.s3["b1"].conv1
    gs = getattr(conv1, "gs", None)
    assert type(gs).__name__ == {"gsm": "GSM", "gsf": "GSF", None: "NoneType"}[cfg.shift_mode]
    assert getattr(trunk.s2["b1"].conv1, "gs", None) is None  # s1/s2 never shift
    before = trunk.stem.conv.weight.clone()
    opt, sched = make_optimizer(model.parameters(), 1e-3, 1, 10)
    step = make_train_step(model, opt, sched, crop_dim=16, num_classes_bg=5, mixup=True,
                           radi_displacement=2)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 256, (2, 8, 20, 20, 3)).astype(np.uint8) for k in ("frame", "frame2")}
    batch.update({k: rng.integers(0, 5, (2, 8)) for k in ("label", "label2")})
    assert np.isfinite(float(step(batch)["loss"]))
    assert not torch.equal(before, trunk.stem.conv.weight)
    assert int(trunk.stem.bn.num_batches_tracked) == 1


@pytest.mark.parametrize("arch", ["rny004_gsf", "resnet50", "rny002gsm"])
def test_build_model_rejects_an_arch_the_jax_package_cannot_build(arch):
    """Parsed as the JAX package parses it: the part before the last '_'
    must name a trunk it has."""
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), feature_arch=arch)
    with pytest.raises(ValueError, match=arch):
        build_model(cfg, device="cpu")


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
    "make,error,match",
    [
        (lambda cfg: SpottingPredictor(cfg, {}, {"a": 1}, n_devices=2),
         ValueError, "n_devices=2 but this machine has 1 CUDA device"),
        (lambda cfg: SpottingPredictor(cfg, {}, {"a": 1}, two_heads=(5, 18), n_devices=2),
         ValueError, "n_devices=2 but this machine has 1 CUDA device"),
        (lambda cfg: SpottingPredictor(dataclasses.replace(cfg, decoder="native"),
                                       build_model(cfg, device="cpu").state_dict(), {"a": 1},
                                       device="cpu"),
         None, None),
    ],
    ids=["n_devices", "two_heads-n_devices", "native-decoder"],
)
def test_predictor_refuses_what_the_port_lacks(monkeypatch, make, error, match):
    """More replicas than the machine has cards (here one), before any
    model is built; the native decoder, which the port has, is the one a
    predictor with decoder='native' reads frames with."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), clip_len=8)
    if error is None:
        assert make(cfg).decoder is native_jpeg.decode
        return
    with pytest.raises(error, match=match):
        make(cfg)


def test_predictor_takes_checkpoint_backbone_and_scores_the_same():
    """The knob changes nothing in eval: a predictor of a config with
    checkpoint_backbone gives the same scores from the same weights."""
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), clip_len=8,
                      n_layers=1, dtype="float32")
    torch.manual_seed(0)
    sd = build_model(cfg, device="cpu").state_dict()
    frames = np.random.default_rng(0).integers(0, 256, (1, 8, 36, 36, 3), dtype=np.uint8)
    probs = [SpottingPredictor(dataclasses.replace(cfg, checkpoint_backbone=ck, crop_dim=32), sd,
                               {f"c{i}": i for i in range(1, 5)}, device="cpu")
             .predict_fn(frames, True) for ck in (False, True)]
    assert probs[1].shape == (1, 8, 5) and torch.equal(probs[0], probs[1])


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
    "argv,error,match",
    [
        (["--n_devices", "3"], ValueError,
         "batch_size 8 does not split into 1 micro-batches over 3 ranks"),
        (["--distributed"], RuntimeError, "RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT"),
        (["--n_devices", "2", "--device", "cuda"], ValueError,
         "--n_devices 2 but this machine has 1 CUDA device"),
        (["--n_devices", "4", "--acc_grad_iter", "4"], ValueError,
         "must be a multiple of acc_grad_iter x ranks = 16"),
        (["--distributed", "--n_devices", "2"], ValueError, "do not pass --n_devices"),
    ],
    ids=["n_devices", "distributed", "n_devices-above-cards", "acc_grad_iter-x-ranks",
         "distributed-and-n_devices"],
)
def test_train_cli_refuses_what_the_port_lacks_at_startup(tmp_path, monkeypatch, argv, error,
                                                         match):
    """Data parallelism refuses only what it cannot run, before it reads a
    plan or writes anything: a batch of 8 over 3 ranks, or 4 micro-batches
    over 4 ranks; --distributed outside a torchrun launch (the error names
    the variables it lacks); more ranks than cards (here one)."""
    for name in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    config_root = _flagship_config(tmp_path)
    with pytest.raises(error, match=match):
        train_cli.main(["--model", "FineDiving_small", "--config_root", config_root,
                        "--data_root", str(tmp_path / "data"), "--no_wandb", "--device", "cpu",
                        *argv])
    assert sorted(os.listdir(tmp_path)) == ["configs"]


def test_challenge_cli_refuses_several_cards_and_other_datasets(tmp_path, monkeypatch):
    """--n_devices 2 on a machine with one card is refused; a config of
    another dataset is refused; both before anything is read or written."""
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
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="n_devices=2 but this machine has 1 CUDA device"):
        challenge_cli.main(["--model", "SoccerNetBall_challenge2", "--n_devices", "2", *argv,
                            "--device", "cuda"])
    assert sorted(os.listdir(tmp_path)) == ["configs"]


@pytest.mark.parametrize("cli", ["train", "predict", "evaluate_challenge", "export_model"])
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
    elif cli in ("predict", "export_model"):
        cfg = load_config("FineDiving_tiny", config_root)
        os.makedirs(cfg.save_dir)
        save_params(os.path.join(cfg.save_dir, BEST), build_model(cfg, device="cpu"))
        with pytest.raises(RuntimeError, match="device='cpu'"):
            if cli == "predict":
                predict_cli.main(argv + ["--videos", "01__01"])
            else:
                export_cli.main(["FineDiving_tiny", str(tmp_path / "artifact"), *argv[2:]])
        assert not os.path.exists(tmp_path / "artifact")
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
