"""The SoccerNet Ball challenge path of the port on the CPU, against the
JAX package where both run:

  * ``cli.evaluate_challenge``: the JAX CLI from its orbax checkpoint and
    the port's CLI from the same weights (``params_from_jax``, saved with
    the port's checkpoint.py) write the same per-game
    ``results_spotting.json``: the same events, confidences at rtol 1e-4;
  * the joint-pretraining training CLI (SoccerNet Ball with SoccerNet,
    the FC2 double head) in store mode, then one run of 2 epochs that
    writes ``checkpoint_best`` and scores the test tail through
    ``evaluate_snb``.

Fixtures: synthetic games of 24x32 JPEG frames in the soccernetball and
soccernet layouts, built here (as tools/drive_e2e.py's drives do); tiny
configs at fp32 (oneDNN's bf16 convolution backward on the CPU can leave
NaN, ROADMAP queue 3): clip 8, full frames (crop_dim -1), n_layers 1,
sgp_ks 3.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from tdeed_tpu.checkpoint import save_params as jax_save_params
from tdeed_tpu.cli import evaluate_challenge as jax_challenge
from tdeed_tpu.config import load_config as jax_load_config
from tdeed_tpu.metrics.soccernet import SNB_EVENTS, SNB_GAMES
from tdeed_tpu.models.tdeed import build_model as jax_build_model
from tdeed_tpu_torch.checkpoint import save_params
from tdeed_tpu_torch.cli import evaluate_challenge, train
from tdeed_tpu_torch.config import load_config
from tdeed_tpu_torch.models.tdeed import build_model, two_heads_for
from tdeed_tpu_torch.utils.jax_convert import params_from_jax

SNB_CLASSES = list(SNB_EVENTS)
SN_CLASSES = ["Goal", "Foul", "Corner"]
H, W = 24, 32


def _frames(path, n, rng):
    os.makedirs(path, exist_ok=True)
    for i in range(n):
        Image.fromarray(rng.integers(0, 256, (H, W, 3), np.uint8)).save(
            os.path.join(path, f"frame{i}.jpg"))


def _labels(root, game, name, anns):
    os.makedirs(os.path.join(root, game), exist_ok=True)
    with open(os.path.join(root, game, name), "w") as fp:
        json.dump({"annotations": anns}, fp)


def _snb_events(n_frames, rng, every=10):
    """An event of a random class every `every` frames, positions in ms at
    25 fps."""
    return [{"gameTime": f"1 - 00:{f // 25:02d}", "label": str(rng.choice(SNB_CLASSES)),
             "position": str(f * 40)} for f in range(every // 2, n_frames, every)]


def _dataset(root, seed=0):
    """SoccerNet Ball: 2 train, 1 val, the 2 hard-coded test games and 1
    challenge game of 60 frames; SoccerNet: 1 train and 1 val game of two
    halves of 240 frames, 3 classes. Returns (frame_dir, data_root)."""
    rng = np.random.default_rng(seed)
    frame_dir, data_root = os.path.join(root, "frames"), os.path.join(root, "data")
    snb, sn = os.path.join(data_root, "soccernetball"), os.path.join(data_root, "soccernet")
    for ds, classes in ((snb, SNB_CLASSES), (sn, SN_CLASSES)):
        os.makedirs(ds)
        with open(os.path.join(ds, "class.txt"), "w") as fp:
            fp.write("\n".join(classes) + "\n")
        with open(os.path.join(ds, "labels_path.txt"), "w") as fp:
            fp.write(os.path.join(root, "labels_" + os.path.basename(ds)))
    snb_labels = os.path.join(root, "labels_soccernetball")
    splits = {"train": ["league/2020/a1", "league/2020/a2"], "val": ["league/2020/a3"],
              "test": SNB_GAMES["test"], "challenge": ["league/2020/c1"]}
    for split, games in splits.items():
        for game in games:
            _frames(os.path.join(frame_dir, game), 60, rng)
            if split != "challenge":
                _labels(snb_labels, game, "Labels-ball.json", _snb_events(60, rng))
        with open(os.path.join(snb, f"{split}.json"), "w") as fp:
            json.dump([{"video": g, "num_frames": 60} for g in games], fp)
    sn_labels = os.path.join(root, "labels_soccernet")
    for split, game in (("train", "cup/2020/m1"), ("val", "cup/2020/m2")):
        for half in (1, 2):
            _frames(os.path.join(frame_dir, game, str(half)), 240, rng)
        _labels(sn_labels, game, "Labels-v2.json", [
            {"gameTime": f"{half} - 00:0{s}", "label": SN_CLASSES[(s + half) % 3],
             "position": str(s * 1000)} for half in (1, 2) for s in (2, 5, 8)])
        with open(os.path.join(sn, f"{split}.json"), "w") as fp:
            json.dump([{"video": f"{game}/{h}", "num_frames": 240} for h in (1, 2)], fp)
    return frame_dir, data_root


def _config(root, name, frame_dir, save_dir, **kw):
    cfg = {
        "frame_dir": frame_dir, "save_dir": save_dir,
        "store_dir": os.path.join(root, "store"), "store_mode": "load",
        "batch_size": 2, "clip_len": 8, "crop_dim": -1, "dataset": "soccernetball",
        "radi_displacement": 1, "epoch_num_frames": 32, "feature_arch": "rny008_gsf",
        "learning_rate": 1e-3, "mixup": True, "modality": "rgb", "num_classes": 12,
        "num_epochs": 2, "warm_up_epochs": 1, "start_val_epoch": 1,
        "temporal_arch": "ed_sgp_mixer", "n_layers": 1, "sgp_ks": 3, "sgp_r": 2,
        "only_test": False, "criterion": "map", "num_workers": 2, "dtype": "float32",
        "pretrain": {"dataset": "soccernet", "num_classes": 3, "frame_dir": frame_dir,
                     "store_dir": os.path.join(root, "store2")},
    }
    cfg.update(kw)
    os.makedirs(os.path.join(root, "configs", "SoccerNetBall"), exist_ok=True)
    with open(os.path.join(root, "configs", "SoccerNetBall", name + ".json"), "w") as fp:
        json.dump(cfg, fp)
    return cfg


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("snb"))
    return (root,) + _dataset(root)


def _predictions(path):
    with open(path) as fp:
        return json.load(fp)["predictions"]


def test_challenge_cli_writes_the_jax_results(dataset):
    """One set of random weights with non-default running statistics, from
    the JAX package's init; the two CLIs each restore it from their own
    checkpoint format and write the challenge game's results."""
    root, frame_dir, data_root = dataset
    for side in ("jax", "port"):
        _config(root, f"SoccerNetBall_{side}", frame_dir, os.path.join(root, side))
    cfg = jax_load_config("SoccerNetBall_jax", os.path.join(root, "configs"))
    model = jax_build_model(cfg, two_heads=(13, 4))
    v = jax.jit(model.init, static_argnums=2)(
        jax.random.PRNGKey(3), jnp.zeros((1, 8, H, W, 3)), False)
    rng = np.random.default_rng(4)
    stats = jax.tree.map(lambda a: (a + rng.uniform(0.1, 0.5, a.shape)).astype(np.float32),
                         v["batch_stats"])
    jax_save_params(os.path.join(cfg.save_dir, "checkpoint_best"), v["params"], stats)
    port_cfg = load_config("SoccerNetBall_port", os.path.join(root, "configs"))
    pm = build_model(port_cfg, two_heads_for(port_cfg), device="cpu")
    pm.load_state_dict(params_from_jax(v["params"], stats), strict=True)
    os.makedirs(port_cfg.save_dir)
    save_params(os.path.join(port_cfg.save_dir, "checkpoint_best"), pm)

    argv = ["--config_root", os.path.join(root, "configs"), "--data_root", data_root]
    jax_challenge.main(["--model", "SoccerNetBall_jax", *argv])
    out = evaluate_challenge.main(["--model", "SoccerNetBall_port", *argv, "--device", "cpu"])
    assert out["videos"] == ["league/2020/c1"]
    game = os.path.join("preds", "league/2020/c1", "results_spotting.json")
    want = _predictions(os.path.join(cfg.save_dir, game))
    got = _predictions(os.path.join(port_cfg.save_dir, game))
    assert out["preds_root"] == os.path.join(port_cfg.save_dir, "preds")
    assert want and len(got) == len(want)
    key = ("gameTime", "label", "position", "half")
    assert [[p[k] for k in key] for p in got] == [[p[k] for k in key] for p in want]
    np.testing.assert_allclose([p["confidence"] for p in got],
                               [p["confidence"] for p in want], rtol=1e-4)


def test_joint_pretrain_cli_trains_and_scores_snb(dataset):
    """Store mode stores both datasets' plans and exits 0; the load run
    trains 2 epochs on 50/50 tagged batches through the double head,
    selects checkpoint_best on SoccerNet Ball's val mAP, and scores the
    test games through evaluate() and evaluate_snb."""
    root, frame_dir, data_root = dataset
    save_dir = os.path.join(root, "joint")
    _config(root, "SoccerNetBall_joint", frame_dir, save_dir, store_mode="store")
    argv = ["--model", "SoccerNetBall_joint", "--config_root", os.path.join(root, "configs"),
            "--data_root", data_root, "--no_wandb", "--device", "cpu"]
    with pytest.raises(SystemExit) as stored:
        train.main(argv)
    assert stored.value.code in (0, None)
    assert sorted(os.listdir(os.path.join(root, "store2"))) == [
        "LEN8DIS1SPLITtrain", "LEN8DIS1SPLITval"]
    _config(root, "SoccerNetBall_joint", frame_dir, save_dir)
    stats = train.main(argv)
    run_dir = os.path.join(save_dir, "SoccerNetBall_joint")
    assert [e["steps"] for e in stats["epochs"]] == [2, 2]
    files = os.listdir(run_dir)
    assert {"checkpoint_best", "checkpoint_last", "loss.json"} <= set(files)
    with open(os.path.join(run_dir, "loss.json")) as fp:
        history = json.load(fp)
    assert all(np.isfinite(r["train"]) and np.isfinite(r["val"]) for r in history)
    assert history[1]["val_mAP"] is not None
    for game in SNB_GAMES["test"]:
        assert os.path.exists(os.path.join(run_dir, "preds", game, "results_spotting.json"))
    snb = stats["soccernet"]["test"]
    assert 0.0 <= snb["a_mAP"] <= 1.0 and len(snb["a_mAP_per_class"]) == 12
