"""Synthetic FineDiving-layout datasets for the port's tools (drive_e2e,
convergence_check): the port's own copy of ``make_finediving_fixture`` and
``write_tiny_config`` from tests/fixtures.py (held equal by
tests/test_torch_tools.py), and the JPEG frame writer they share.

Frames are written with PIL at quality 95, as the tests' fixtures are.
Where PIL is missing, each frame path is a symbolic link to the committed
fixture JPEG of the same size (native/fixtures/, manifest.json): the
files are real JPEGs the decoder reads, but their pixels are the
fixture's, not the array's.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

FIXTURES = Path(__file__).resolve().parent.parent / "native" / "fixtures"


def fixture_jpegs(height: int, width: int) -> List[str]:
    """Paths of the committed fixture JPEGs of a frame size (manifest order)."""
    with open(FIXTURES / "manifest.json") as fp:
        frames = json.load(fp)["frames"]
    return [str(FIXTURES / f["file"]) for f in frames
            if (f["height"], f["width"]) == (height, width)]


def write_jpeg(path: str, arr: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as a quality-95 JPEG (PIL), or, without
    PIL, link the committed fixture of its size in its place."""
    try:
        from PIL import Image
    except ImportError:
        jpegs = fixture_jpegs(arr.shape[0], arr.shape[1])
        if not jpegs:
            raise FileNotFoundError(
                f"no PIL to encode a {arr.shape[0]}x{arr.shape[1]} frame and no committed "
                f"fixture of that size in {FIXTURES}") from None
        os.symlink(jpegs[0], path)
        return
    Image.fromarray(arr).save(path, quality=95)


def make_finediving_fixture(
    root: str,
    num_videos: int = 2,
    num_frames: int = 24,
    size: int = 24,
    num_classes: int = 4,
    seed: int = 0,
    splits: Optional[Dict[str, int]] = None,
) -> Dict[str, str]:
    """Build a finediving-style tree:

    frames under  <root>/frames/<vid_a>/<vid_b>/0001.jpg  (videos named
    '<a>__<b>', zero-padded frame names — ref: dataset/frame.py:277-281),
    metadata under <root>/data/finediving/{train,val,test}.json + class.txt.

    Returns {'frame_dir', 'data_root', 'store_dir', 'save_dir'}.
    """
    rng = np.random.default_rng(seed)
    frame_dir = os.path.join(root, "frames")
    data_root = os.path.join(root, "data")
    ds_dir = os.path.join(data_root, "finediving")
    os.makedirs(ds_dir, exist_ok=True)

    classes = [f"class{i}" for i in range(1, num_classes + 1)]
    with open(os.path.join(ds_dir, "class.txt"), "w") as fp:
        fp.write("\n".join(classes) + "\n")

    splits = splits or {"train": num_videos, "val": 1, "test": 1}
    vid_counter = 0
    for split, count in splits.items():
        metas: List[dict] = []
        for _ in range(count):
            vid_counter += 1
            name = f"{vid_counter:02d}__01"
            vdir = os.path.join(frame_dir, f"{vid_counter:02d}", "01")
            os.makedirs(vdir, exist_ok=True)
            for i in range(num_frames):
                img = rng.integers(0, 256, (size, size, 3), np.uint8)
                write_jpeg(os.path.join(vdir, f"{i + 1:04d}.jpg"), img)
            events = [
                {"frame": int(rng.integers(2, num_frames - 2)),
                 "label": classes[int(rng.integers(0, num_classes))]}
                for _ in range(2)
            ]
            events.sort(key=lambda e: e["frame"])
            metas.append(
                {
                    "video": name,
                    "num_frames": num_frames,
                    "fps": 10.0,
                    "events": events,
                    "num_events": len(events),
                }
            )
        with open(os.path.join(ds_dir, f"{split}.json"), "w") as fp:
            json.dump(metas, fp)

    out = {
        "frame_dir": frame_dir,
        "data_root": data_root,
        "store_dir": os.path.join(root, "store"),
        "save_dir": os.path.join(root, "save"),
    }
    for k in ("store_dir", "save_dir"):
        os.makedirs(out[k], exist_ok=True)
    return out


def write_tiny_config(
    root: str,
    fixture: Dict[str, str],
    *,
    model: str = "FineDiving_tiny",
    store_mode: str = "store",
    clip_len: int = 8,
    crop_dim: int = 16,
    num_epochs: int = 1,
    batch_size: int = 2,
    epoch_num_frames: int = 64,
    **extra,
) -> str:
    """Write a tiny config JSON under <root>/configs and return config_root."""
    cfg = {
        "frame_dir": fixture["frame_dir"],
        "save_dir": fixture["save_dir"],
        "store_dir": fixture["store_dir"],
        "store_mode": store_mode,
        "batch_size": batch_size,
        "clip_len": clip_len,
        "crop_dim": crop_dim,
        "dataset": "finediving",
        "radi_displacement": 1,
        "epoch_num_frames": epoch_num_frames,
        "feature_arch": "rny002_gsf",
        "learning_rate": 1e-3,
        "mixup": True,
        "modality": "rgb",
        "num_classes": 4,
        "num_epochs": num_epochs,
        "warm_up_epochs": 1,
        "start_val_epoch": 0,
        "temporal_arch": "ed_sgp_mixer",
        "n_layers": 2,
        "sgp_ks": 3,
        "sgp_r": 2,
        "only_test": False,
        "criterion": "loss",
        "num_workers": 2,
    }
    cfg.update(extra)
    config_root = os.path.join(root, "configs")
    prefix = model.split("_")[0]
    os.makedirs(os.path.join(config_root, prefix), exist_ok=True)
    with open(os.path.join(config_root, prefix, model + ".json"), "w") as fp:
        json.dump(cfg, fp)
    return config_root
