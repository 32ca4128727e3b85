"""End-to-end drive of the port's CLIs on synthetic fixtures (port of
tools/drive_e2e.py).

    python -m tdeed_tpu_torch.tools.drive_e2e [--device cuda|cpu]

Four drives, with tiny shapes, each in a fresh temporary directory:
  1. finediving: store mode -> load mode (train 1 epoch, val, best
     checkpoint, test evaluation with NMS/mAP, prediction store), then the
     predict CLI over the trained run;
  2. soccernetball challenge: a best checkpoint of random weights ->
     label-free CHALLENGE inference -> per-game results_spotting.json;
  3. SoccerNet Ball + SoccerNet joint training on the FC2 double head;
  4. challenge training on the train_challenge / val_challenge splits,
     then challenge inference from the trained best checkpoint.
Frames are PIL-written JPEGs, or without PIL the committed fixture JPEGs
of the same size (tools/fixtures.py). Every CLI runs on the CUDA device
unless ``--device cpu``; on the CPU the configs are fp32 (oneDNN's bf16
convolution backward leaves padding-only weight-gradient taps unset).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import numpy as np

from tdeed_tpu_torch.tools.fixtures import make_finediving_fixture, write_jpeg, write_tiny_config

SNB_CLASSES = ["PASS", "DRIVE", "HEADER", "HIGH PASS", "OUT", "CROSS", "THROW IN", "SHOT",
               "BALL PLAYER BLOCK", "PLAYER SUCCESSFUL TACKLE", "FREE KICK", "GOAL"]


def _dtype(device: str) -> dict:
    return {"dtype": "float32"} if device == "cpu" else {}


def _store_then_load(main, argv, cfg_path, cfg, tag):
    """Store mode (exits 0), then the same config in load mode."""
    print(f"== {tag} STORE ==", flush=True)
    try:
        main(argv)
    except SystemExit as e:
        assert e.code in (0, None), e.code
    cfg["store_mode"] = "load"
    with open(cfg_path, "w") as fp:
        json.dump(cfg, fp)
    print(f"== {tag} LOAD ==", flush=True)
    return main(argv)


def _frames(dirpath: str, n: int, rng) -> None:
    os.makedirs(dirpath, exist_ok=True)
    for i in range(n):
        write_jpeg(os.path.join(dirpath, f"frame{i}.jpg"),
                   rng.integers(0, 256, (24, 32, 3), np.uint8))


def _write_config(cfg_root: str, name: str, cfg: dict) -> str:
    os.makedirs(os.path.join(cfg_root, "SoccerNetBall"), exist_ok=True)
    path = os.path.join(cfg_root, "SoccerNetBall", f"{name}.json")
    with open(path, "w") as fp:
        json.dump(cfg, fp)
    return path


def drive_finediving(root: str, device: str = "cuda") -> dict:
    from tdeed_tpu_torch.cli.predict import main as predict_main
    from tdeed_tpu_torch.cli.train import main

    fx = make_finediving_fixture(root, num_videos=2, num_frames=24)
    cfg_root = write_tiny_config(root, fx, store_mode="store", **_dtype(device))
    argv = ["--model", "FineDiving_tiny", "--config_root", cfg_root,
            "--data_root", fx["data_root"], "--no_wandb", "--device", device]
    print("== finediving STORE ==", flush=True)
    try:
        main(argv)
    except SystemExit as e:
        assert e.code in (0, None), e.code
    write_tiny_config(root, fx, store_mode="load", **_dtype(device))
    print("== finediving LOAD (train + eval) ==", flush=True)
    stats = main(argv)
    run_dir = os.path.join(fx["save_dir"], "FineDiving_tiny")
    assert os.path.exists(os.path.join(run_dir, "checkpoint_best")), run_dir
    assert os.path.exists(os.path.join(run_dir, "loss.json"))
    print("== finediving DRIVE OK ==", flush=True)

    # Serving surface: the spotting CLI over the trained run
    out_json = os.path.join(root, "events.json")
    predict_main([
        "--model", "FineDiving_tiny", "--config_root", cfg_root,
        "--data_root", fx["data_root"],
        "--split", os.path.join(fx["data_root"], "finediving", "test.json"),
        "--out", out_json, "--device", device,
    ])
    with open(out_json) as fp:
        payload = json.load(fp)
    assert payload and "events" in payload[0]
    print("== PREDICT CLI DRIVE OK ==", flush=True)
    return {"train": stats, "predict": payload, "run_dir": run_dir}


def drive_snb_challenge(root: str, device: str = "cuda") -> None:
    from tdeed_tpu_torch.checkpoint import BEST, save_params
    from tdeed_tpu_torch.cli.evaluate_challenge import main
    from tdeed_tpu_torch.config import TDEEDConfig
    from tdeed_tpu_torch.models.tdeed import build_model

    game = "england_efl/2019-2020/2019-10-02 - Cardiff City - Queens Park Rangers"
    frame_dir = os.path.join(root, "frames")
    data_root = os.path.join(root, "data")
    save_dir = os.path.join(root, "save")
    ds_dir = os.path.join(data_root, "soccernetball")
    os.makedirs(ds_dir, exist_ok=True)
    _frames(os.path.join(frame_dir, game), 30, np.random.default_rng(0))
    with open(os.path.join(ds_dir, "class.txt"), "w") as fp:
        fp.write("\n".join(SNB_CLASSES) + "\n")
    with open(os.path.join(ds_dir, "challenge.json"), "w") as fp:
        json.dump([{"video": game, "num_frames": 30}], fp)

    cfg = {
        "frame_dir": frame_dir, "save_dir": save_dir, "store_dir": save_dir,
        "store_mode": "load", "batch_size": 2, "clip_len": 8, "crop_dim": -1,
        "dataset": "soccernetball", "radi_displacement": 1,
        "epoch_num_frames": 64, "feature_arch": "rny002_gsf",
        "learning_rate": 1e-3, "mixup": True, "modality": "rgb",
        "num_classes": 12, "num_epochs": 1, "warm_up_epochs": 1,
        "start_val_epoch": 0, "temporal_arch": "ed_sgp_mixer", "n_layers": 2,
        "sgp_ks": 3, "sgp_r": 2, "only_test": True, "criterion": "map",
        "num_workers": 2, **_dtype(device),
    }
    cfg_root = os.path.join(root, "configs")
    _write_config(cfg_root, "SoccerNetBall_tiny", cfg)

    # a best checkpoint of random weights
    model = build_model(TDEEDConfig.from_dict(cfg, model="SoccerNetBall_tiny"), device="cpu")
    run_dir = os.path.join(save_dir, "SoccerNetBall_tiny")
    os.makedirs(run_dir, exist_ok=True)
    save_params(os.path.join(run_dir, BEST), model)

    print("== SNB CHALLENGE inference ==", flush=True)
    main(["--model", "SoccerNetBall_tiny", "--config_root", cfg_root,
          "--data_root", data_root, "--device", device])
    out = os.path.join(run_dir, "preds", game, "results_spotting.json")
    assert os.path.exists(out), out
    with open(out) as fp:
        preds = json.load(fp)
    assert "predictions" in preds
    print(f"== SNB CHALLENGE DRIVE OK ({len(preds['predictions'])} preds) ==", flush=True)


def _labels(labels_root: str, game: str, name: str, annotations) -> None:
    os.makedirs(os.path.join(labels_root, game), exist_ok=True)
    with open(os.path.join(labels_root, game, name), "w") as fp:
        json.dump({"annotations": annotations}, fp)


def drive_joint_pretrain(root: str, device: str = "cuda") -> None:
    """SNB + SN joint training: FC2 double head, 50/50 tagged sampling,
    per-sample CE routing (ref: model/model.py:169-172,278-306)."""
    from tdeed_tpu_torch.cli.train import main

    frame_dir = os.path.join(root, "frames")
    data_root = os.path.join(root, "data")
    save_dir = os.path.join(root, "save")
    store_dir = os.path.join(root, "store")

    # --- SNB primary ----------------------------------------------------
    snb_dir = os.path.join(data_root, "soccernetball")
    os.makedirs(snb_dir, exist_ok=True)
    snb_labels = os.path.join(root, "labels_snb")
    with open(os.path.join(snb_dir, "class.txt"), "w") as fp:
        fp.write("PASS\nDRIVE\nGOAL\n")
    with open(os.path.join(snb_dir, "labels_path.txt"), "w") as fp:
        fp.write(snb_labels)
    for split, games in (("train", ["g1", "g2"]), ("val", ["g3"])):
        metas = []
        for g in games:
            game = f"league/2020/{g}"
            _frames(os.path.join(frame_dir, game), 60, np.random.default_rng(0))
            _labels(snb_labels, game, "Labels-ball.json",
                    [{"gameTime": "1 - 00:01", "label": "PASS", "position": "1000"}])
            metas.append({"video": game, "num_frames": 60})
        with open(os.path.join(snb_dir, f"{split}.json"), "w") as fp:
            json.dump(metas, fp)

    # --- SN pretrain ------------------------------------------------------
    sn_dir = os.path.join(data_root, "soccernet")
    os.makedirs(sn_dir, exist_ok=True)
    sn_labels = os.path.join(root, "labels_sn")
    with open(os.path.join(sn_dir, "class.txt"), "w") as fp:
        fp.write("Goal\nFoul\n")
    with open(os.path.join(sn_dir, "labels_path.txt"), "w") as fp:
        fp.write(sn_labels)
    for split, games in (("train", ["m1"]), ("val", ["m2"])):
        metas = []
        for g in games:
            game = f"cup/2020/{g}"
            for half in (1, 2):
                _frames(os.path.join(frame_dir, game, str(half)), 240,
                        np.random.default_rng(0))
            _labels(sn_labels, game, "Labels-v2.json", [
                {"gameTime": f"{h} - 00:0{s}", "label": lab, "position": f"{s}000"}
                for h in (1, 2) for s, lab in ((2, "Goal"), (6, "Foul"))])
            metas.extend({"video": f"{game}/{half}", "num_frames": 240} for half in (1, 2))
        with open(os.path.join(sn_dir, f"{split}.json"), "w") as fp:
            json.dump(metas, fp)

    cfg = {
        "frame_dir": frame_dir, "save_dir": save_dir, "store_dir": store_dir,
        "store_mode": "store", "batch_size": 2, "clip_len": 8, "crop_dim": -1,
        "dataset": "soccernetball", "radi_displacement": 1,
        "epoch_num_frames": 32, "feature_arch": "rny002_gsf",
        "learning_rate": 1e-3, "mixup": True, "modality": "rgb",
        "num_classes": 3, "num_epochs": 1, "warm_up_epochs": 1,
        "start_val_epoch": 99, "temporal_arch": "ed_sgp_mixer", "n_layers": 2,
        "sgp_ks": 3, "sgp_r": 2, "only_test": False, "criterion": "loss",
        "num_workers": 2, **_dtype(device),
        "pretrain": {"dataset": "soccernet", "num_classes": 2,
                     "frame_dir": frame_dir, "store_dir": store_dir + "2"},
    }
    cfg_root = os.path.join(root, "configs")
    cfg_path = _write_config(cfg_root, "SoccerNetBall_joint", cfg)
    argv = ["--model", "SoccerNetBall_joint", "--config_root", cfg_root,
            "--data_root", data_root, "--no_wandb", "--device", device]
    _store_then_load(main, argv, cfg_path, cfg, "JOINT")
    assert os.path.exists(os.path.join(save_dir, "SoccerNetBall_joint", "loss.json"))
    print("== JOINT PRETRAIN DRIVE OK ==", flush=True)


def drive_challenge_training(root: str, device: str = "cuda") -> None:
    """The SNB challenge-training flow: train on train_challenge /
    val_challenge split metadata (config keys train_split/val_split), then
    run label-free challenge inference from the trained best checkpoint
    (ref: evaluate_tdeed_challenge.py:29-141,
    config/SoccerNetBall/SoccerNetBall_challenge1.json)."""
    from tdeed_tpu_torch.cli.evaluate_challenge import main as challenge_main
    from tdeed_tpu_torch.cli.train import main as train_main

    frame_dir = os.path.join(root, "frames")
    data_root = os.path.join(root, "data")
    save_dir = os.path.join(root, "save")
    store_dir = os.path.join(root, "store")
    snb_dir = os.path.join(data_root, "soccernetball")
    labels_root = os.path.join(root, "labels_snb")
    os.makedirs(snb_dir, exist_ok=True)
    with open(os.path.join(snb_dir, "class.txt"), "w") as fp:
        fp.write("\n".join(SNB_CLASSES) + "\n")
    with open(os.path.join(snb_dir, "labels_path.txt"), "w") as fp:
        fp.write(labels_root)

    rng = np.random.default_rng(0)
    for split, games, labeled in (
        ("train_challenge", ["league/2020/c1", "league/2020/c2"], True),
        ("val_challenge", ["league/2020/c3"], True),
        ("challenge", ["league/2020/c4"], False),
    ):
        for game in games:
            _frames(os.path.join(frame_dir, game), 60, rng)
            if labeled:
                _labels(labels_root, game, "Labels-ball.json",
                        [{"gameTime": "1 - 00:01", "label": "PASS", "position": "1000"}])
        with open(os.path.join(snb_dir, f"{split}.json"), "w") as fp:
            json.dump([{"video": g, "num_frames": 60} for g in games], fp)

    cfg = {
        "frame_dir": frame_dir, "save_dir": save_dir, "store_dir": store_dir,
        "store_mode": "store", "batch_size": 2, "clip_len": 8, "crop_dim": -1,
        "dataset": "soccernetball", "radi_displacement": 1,
        "epoch_num_frames": 32, "feature_arch": "rny002_gsf",
        "learning_rate": 1e-3, "mixup": True, "modality": "rgb",
        "num_classes": 12, "num_epochs": 1, "warm_up_epochs": 1,
        "start_val_epoch": 99, "temporal_arch": "ed_sgp_mixer", "n_layers": 2,
        "sgp_ks": 3, "sgp_r": 2, "only_test": False, "criterion": "loss",
        "num_workers": 2, **_dtype(device),
        "train_split": "train_challenge", "val_split": "val_challenge",
    }
    cfg_root = os.path.join(root, "configs")
    cfg_path = _write_config(cfg_root, "SoccerNetBall_chtrain", cfg)
    argv = ["--model", "SoccerNetBall_chtrain", "--config_root", cfg_root,
            "--data_root", data_root, "--no_wandb", "--device", device]
    _store_then_load(train_main, argv, cfg_path, cfg, "CHALLENGE-TRAIN")
    run_dir = os.path.join(save_dir, "SoccerNetBall_chtrain")
    assert os.path.exists(os.path.join(run_dir, "checkpoint_best")), run_dir

    print("== CHALLENGE inference from trained ckpt ==", flush=True)
    challenge_main(["--model", "SoccerNetBall_chtrain", "--config_root", cfg_root,
                    "--data_root", data_root, "--device", device])
    out = os.path.join(run_dir, "preds", "league/2020/c4", "results_spotting.json")
    assert os.path.exists(out), out
    print("== CHALLENGE-TRAINING DRIVE OK ==", flush=True)


DRIVES = (("fd", drive_finediving), ("snb", drive_snb_challenge),
          ("joint", drive_joint_pretrain), ("chtrain", drive_challenge_training))


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="where the CLIs run (default: the CUDA device)")
    args = p.parse_args(argv)
    for tag, drive in DRIVES:
        with tempfile.TemporaryDirectory(prefix=f"drive_{tag}_") as root:
            drive(root, args.device)
    print("ALL E2E DRIVES OK")


if __name__ == "__main__":
    main()
