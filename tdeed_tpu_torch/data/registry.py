"""Dataset registry: per-dataset strides, tolerances, windows, path schemes.

The port's own copy of ``tdeed_tpu/data/registry.py`` (held equal by
tests/test_torch_infer_copies.py). It centralizes the constants the
reference scatters across files:
  - train stride/overlap  (ref: dataset/datasets.py:13-17)
  - eval stride           (ref: train_tdeed.py:30-33)
  - metric tolerances / NMS windows (ref: util/eval.py:24-31)
  - per-dataset frame naming quirks (ref: dataset/frame.py:274-353)
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Callable, Dict, Optional, Tuple

FPS_SN = 25  # ref: dataset/frame.py:27
DEFAULT_PAD_LEN = 5  # ref: dataset/frame.py:26


@dataclasses.dataclass(frozen=True)
class FrameScheme:
    """How a dataset names its frame files.

    resolve(frame_dir, video_name, source_info) ->
        (directory, frame0, ndigits)
    A frame index i maps to file ``frame{frame0+i}.jpg`` when ndigits == -1,
    or ``{frame0+i:0{ndigits}d}.jpg`` when ndigits > 0.
    """

    resolve: Callable[[str, str, Optional[dict]], Tuple[str, int, int]]


def _resolve_finediving(frame_dir, video, source_info):
    # video '01__10' -> dir '01/10'; zero-padded names discovered from listing
    # (ref: dataset/frame.py:277-281)
    path = os.path.join(frame_dir, video.replace("__", "/"))
    frame0_name = sorted(os.listdir(path))[0]
    ndigits = len(frame0_name[:-4])
    return path, int(frame0_name[:-4]), ndigits


def _resolve_tennis(frame_dir, video, source_info):
    # video '<base>_<frame0>_<frame1>' (ref: dataset/frame.py:283-286)
    frame0 = int(video.split("_")[-2])
    base = "_".join(video.split("_")[:-2])
    return os.path.join(frame_dir, base), frame0, -1


def _resolve_finegym(frame_dir, video, source_info):
    # frame0 from _source_info (ref: dataset/frame.py:288-291)
    frame0 = source_info["start_frame"] - source_info["pad"][0]
    base = video.split("_")[0]
    return os.path.join(frame_dir, base), frame0, -1


def _resolve_plain(frame_dir, video, source_info):
    # fs_comp / fs_perf / soccernet / soccernetball: frame{i}.jpg
    # (ref: dataset/frame.py:314-342)
    return os.path.join(frame_dir, video), 0, -1


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    train_stride: int
    train_overlap: float  # fraction of clip_len (ref: dataset/datasets.py:16-17)
    eval_stride: int
    tolerances: Tuple[int, ...]  # mAP tolerances in (strided) frames
    windows: Tuple[int, ...]  # (NMS window, SoftNMS window)
    scheme: FrameScheme
    external_labels: bool = False  # SN/SNB: labels in external tree
    hflip_tta: bool = True  # ref: train_tdeed.py:265
    events_only_clips: bool = False  # SN keeps only clips w/ events (frame.py:169)
    uses_source_info: bool = False

    def eval_overlap_len(self, clip_len: int) -> int:
        # 3/4 overlap, SN 1/2 (ref: train_tdeed.py:256)
        if self.name == "soccernet":
            return clip_len // 2
        return clip_len // 4 * 3


DATASETS: Dict[str, DatasetSpec] = {
    "finediving": DatasetSpec(
        "finediving", 1, 0.9, 1, (1, 2, 4), (1, 3), FrameScheme(_resolve_finediving)
    ),
    "tennis": DatasetSpec(
        "tennis", 1, 0.9, 1, (1, 2, 4), (1, 3), FrameScheme(_resolve_tennis)
    ),
    "fs_comp": DatasetSpec(
        "fs_comp", 1, 0.9, 1, (1, 2, 4), (1, 3), FrameScheme(_resolve_plain)
    ),
    "fs_perf": DatasetSpec(
        "fs_perf", 1, 0.9, 1, (1, 2, 4), (1, 3), FrameScheme(_resolve_plain)
    ),
    "finegym": DatasetSpec(
        "finegym", 1, 0.9, 1, (1, 2, 4), (1, 3), FrameScheme(_resolve_finegym),
        uses_source_info=True,
    ),
    "soccernet": DatasetSpec(
        "soccernet", 12, 0.5, 12, (3, 6), (3, 6), FrameScheme(_resolve_plain),
        external_labels=True, hflip_tta=False, events_only_clips=True,
    ),
    "soccernetball": DatasetSpec(
        "soccernetball", 2, 0.9, 2, (6, 12), (6, 12), FrameScheme(_resolve_plain),
        external_labels=True, hflip_tta=False,
    ),
}


def get_spec(name: str) -> DatasetSpec:
    if name not in DATASETS:
        raise KeyError(f"Unknown dataset {name!r}; known: {sorted(DATASETS)}")
    return DATASETS[name]


def load_classes(path: str) -> Dict[str, int]:
    """class.txt -> {name: idx+1}; 0 is background (ref: util/dataset.py:17-18)."""
    classes: Dict[str, int] = {}
    with open(path) as fp:
        i = 0
        for line in fp:
            line = line.strip()
            if line:
                i += 1
                classes[line] = i
    return classes


def event_frame(event: dict, dataset: str) -> Tuple[int, int]:
    """Return (frame, half) for an event record.

    SN/SNB events carry 'position' in milliseconds and 'gameTime' whose first
    char is the half (ref: dataset/frame.py:131-133); the rest carry 'frame'.
    """
    if dataset in ("soccernet", "soccernetball"):
        frame = int(int(event["position"]) / 1000 * FPS_SN)
        half = int(event["gameTime"][0])
        return frame, half
    return int(event["frame"]), 0


def strided_video_len(num_frames: int, stride: int) -> int:
    """ceil(num_frames / stride) (ref: dataset/frame.py:467,492)."""
    return math.ceil(num_frames / stride)
