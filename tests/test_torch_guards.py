"""Guards of the PyTorch port: it never imports JAX, it builds the flagship
config at full width, and it refuses the config values it does not carry
yet with the ROADMAP.md item that brings them."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from tdeed_tpu_torch import load_config
from tdeed_tpu_torch.infer.predictor import SpottingPredictor
from tdeed_tpu_torch.kernels.augment import _check
from tdeed_tpu_torch.models.tdeed import build_model
from tdeed_tpu_torch.train.schedule import make_optimizer
from tdeed_tpu_torch.train.step import make_predict_step, make_train_step

REPO = Path(__file__).resolve().parents[1]


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
        "print(len(mods), bad, ref)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
        timeout=120, check=True,
    ).stdout.split(" ", 1)
    assert int(out[0]) >= 39, out  # every module of the slice was imported
    assert out[1].strip() == "[] []"


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
        ({"acc_grad_iter": 2}, "acc_grad_iter scan"),
        ({"feature_arch": "rny002_gsm"}, "GSM"),
        ({"feature_arch": "rny002"}, "plain rny002"),
        ({"feature_arch": "rny008_gsf"}, "rny008"),
        ({"pretrain": {"dataset": "soccernet", "num_classes": 17}}, "FC2 double head"),
    ],
)
def test_build_model_refuses_what_the_port_lacks(override, item):
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), **override)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        build_model(cfg, device="cpu")
    assert item in str(err.value)


def test_steps_refuse_what_the_port_lacks():
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), clip_len=8)
    model = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="FC2 double head"):
        build_model(cfg, two_heads=(5, 18), device="cpu")
    opt, sched = make_optimizer(model.parameters(), 1e-3, 1, 10)
    common = dict(crop_dim=32, num_classes_bg=5, mixup=True, radi_displacement=2)
    with pytest.raises(NotImplementedError, match="acc_grad_iter scan"):
        make_train_step(model, opt, sched, acc_grad_iter=2, **common)
    with pytest.raises(NotImplementedError, match="FC2 double head"):
        make_train_step(model, opt, sched, two_heads=(5, 18), **common)
    with pytest.raises(NotImplementedError, match="FC2 double head"):
        make_predict_step(model, crop_dim=32, radi_displacement=2, two_heads=(5, 18))


@pytest.mark.parametrize(
    "make,item",
    [
        (lambda cfg: SpottingPredictor(cfg, {}, {"a": 1}, n_devices=2, device="cpu"), "DDP"),
        (lambda cfg: SpottingPredictor(cfg, {}, {"a": 1}, two_heads=(5, 18), device="cpu"),
         "FC2 double head"),
        (lambda cfg: SpottingPredictor.from_run("FineDiving_small", str(REPO / "configs")),
         "checkpoint and the CLIs"),
        (lambda cfg: SpottingPredictor(dataclasses.replace(cfg, decoder="native"), {}, {"a": 1},
                                       device="cpu"),
         "checkpoint and the CLIs"),
    ],
    ids=["n_devices", "two_heads", "from_run", "native-decoder"],
)
def test_predictor_refuses_what_the_port_lacks(make, item):
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), clip_len=8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md") as err:
        make(cfg)
    assert item in str(err.value)


def test_predictor_defaults_to_cuda_and_never_falls_back(monkeypatch):
    cfg = load_config("FineDiving_small", config_root=str(REPO / "configs"), clip_len=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SpottingPredictor(cfg, {}, {"a": 1})


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
