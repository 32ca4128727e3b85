"""Clip planner: the two-phase store/load protocol.

The port's own copy of ``tdeed_tpu/data/clips.py`` (held equal by
tests/test_torch_train_copies.py); the pickles keep the reference's
on-disk format, so a store directory written by either package loads in
the other. Reproduces the reference's dataset preparation exactly
(ref: dataset/frame.py:97-208):
  * enumerate overlapping clip windows per video starting at
    -pad_len*stride with hop (1-overlap)*clip_len (int), ending so every
    window retains >= 1 real frame;
  * resolve per-clip frame paths by probing the filesystem once at store
    time ([base_path, found_start, pad_start, pad_end, ndigits, length] —
    the exact list format the reference pickles, so existing store dirs are
    mutually compatible);
  * dilate labels ±radi_displacement and record signed displacement targets;
  * SoccerNet ('soccernet') keeps only clips containing >= 1 event;
  * pickle {frame_paths, labels, labelsD} to
    store_dir/LEN{clip}DIS{radi}SPLIT{split}/.

Pure host-side Python — fully unit-testable against synthetic frame trees.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

from tdeed_tpu_torch.data.registry import (
    DEFAULT_PAD_LEN,
    DatasetSpec,
    event_frame,
    get_spec,
)
from tdeed_tpu_torch.utils.io import load_json


# A stored clip is the reference's list format:
#   [base_path, found_start, pad_start, pad_end, ndigits, length]
ClipPaths = list


@dataclasses.dataclass
class ClipPlan:
    """In-memory result of store/load: parallel lists over clips."""

    frame_paths: List[ClipPaths]
    labels: List[List[dict]]  # [{'label': int, 'label_idx': int}, ...]
    labels_d: Optional[List[List[dict]]]  # [{'displ': int, 'label_idx': int}, ...]

    def __len__(self) -> int:
        return len(self.frame_paths)


def store_key(clip_len: int, radi_displacement: int, split: str) -> str:
    return f"LEN{clip_len}DIS{radi_displacement}SPLIT{split}"


class _DirListingCache:
    """One scandir per video directory instead of one stat per frame.

    The reference probes os.path.exists for every frame of every window
    (ref: dataset/frame.py:296-353) — with 90% window overlap that is
    ~10 stat calls per frame, millions on SoccerNet. A single directory
    listing answers all of them from memory."""

    def __init__(self):
        self._cache: Dict[str, frozenset] = {}

    def names(self, path: str) -> frozenset:
        got = self._cache.get(path)
        if got is None:
            try:
                got = frozenset(os.listdir(path))
            except FileNotFoundError:
                got = frozenset()
            self._cache[path] = got
        return got


def resolve_clip_paths(
    spec: DatasetSpec,
    frame_dir: str,
    video: str,
    start: int,
    end: int,
    stride: int,
    source_info: Optional[dict] = None,
    dir_cache: Optional[_DirListingCache] = None,
) -> ClipPaths:
    """Probe frame existence for a window (ref: dataset/frame.py:274-353).

    pad_start counts negative frame indices; pad_end counts trailing frames
    that stopped existing (once a frame is missing, everything after pads).
    """
    path, frame0, ndigits = spec.scheme.resolve(frame_dir, video, source_info)
    listing = dir_cache.names(path) if dir_cache is not None else None
    found_start = -1
    pad_start = 0
    pad_end = 0
    for frame_num in range(start, end, stride):
        if frame_num < 0:
            pad_start += 1
            continue
        if pad_end > 0:
            pad_end += 1
            continue
        frame = frame0 + frame_num
        if ndigits > 0:
            name = str(frame).zfill(ndigits) + ".jpg"
        else:
            name = f"frame{frame}.jpg"
        if listing is not None:
            exists = name in listing
        else:
            exists = os.path.exists(os.path.join(path, name))
        if exists and found_start == -1:
            found_start = frame
        if not exists:
            pad_end += 1
    return [path, found_start, pad_start, pad_end, ndigits, (end - start) // stride]


def _dilated_events(
    events: Sequence[dict],
    classes: Dict[str, int],
    dataset: str,
    video_half: int,
    base_idx: int,
    stride: int,
    clip_len: int,
    radi: int,
) -> Tuple[List[dict], List[dict]]:
    """Label dilation + displacement targets (ref: dataset/frame.py:127-164).

    Later events overwrite earlier ones at the same index at rasterization
    time, matching the reference's list-order semantics.
    """
    labels: List[dict] = []
    labels_d: List[dict] = []
    for event in events:
        frame, half = event_frame(event, dataset)
        if dataset in ("soccernet", "soccernetball") and half != video_half:
            continue
        label_idx = (frame - base_idx) // stride
        if -radi <= label_idx < clip_len + radi:
            label = classes[event["label"]]
            for i in range(max(0, label_idx - radi), min(clip_len, label_idx + radi + 1)):
                labels.append({"label": label, "label_idx": i})
                labels_d.append({"displ": i - label_idx, "label_idx": i})
    return labels, labels_d


def plan_clips(
    dataset: str,
    label_file: str,
    frame_dir: str,
    classes: Dict[str, int],
    clip_len: int,
    stride: int,
    overlap: float,
    radi_displacement: int,
    pad_len: int = DEFAULT_PAD_LEN,
    labels_root: Optional[str] = None,
) -> ClipPlan:
    """Enumerate and label every training clip window (store phase).

    Window start range and hop: ref dataset/frame.py:116; hop is
    int((1-overlap)*clip_len) when overlap != 1 else 1 (frame.py:63-66).
    """
    spec = get_spec(dataset)
    videos = load_json(label_file)
    hop = max(1, int((1 - overlap) * clip_len)) if overlap != 1 else 1
    assert 0 <= overlap <= 1

    plan = ClipPlan(frame_paths=[], labels=[], labels_d=[])
    dir_cache = _DirListingCache()
    for video in videos:
        video_len = int(video["num_frames"])
        if dataset == "soccernet":
            video_half = int(video["video"][-1])
            events = load_json(
                os.path.join(
                    labels_root,
                    "/".join(video["video"].split("/")[:-1]) + "/Labels-v2.json",
                )
            )["annotations"]
        elif dataset == "soccernetball":
            video_half = 1
            events = load_json(
                os.path.join(labels_root, video["video"] + "/Labels-ball.json")
            )["annotations"]
        else:
            video_half = 0
            events = video["events"]

        source_info = video.get("_source_info") if spec.uses_source_info else None
        stop = max(0, video_len - 1 + (2 * pad_len - clip_len) * stride)
        for base_idx in range(-pad_len * stride, stop, hop):
            paths = resolve_clip_paths(
                spec, frame_dir, video["video"], base_idx,
                base_idx + clip_len * stride, stride, source_info,
                dir_cache=dir_cache,
            )
            labels, labels_d = _dilated_events(
                events, classes, dataset, video_half, base_idx, stride,
                clip_len, radi_displacement,
            )
            if paths[1] == -1:  # no frames available (ref: frame.py:166)
                continue
            if spec.events_only_clips and not labels:  # ref: frame.py:169-174
                continue
            plan.frame_paths.append(paths)
            plan.labels.append(labels)
            plan.labels_d.append(labels_d)

    if radi_displacement <= 0:
        plan.labels_d = None
    return plan


def store_plan(plan: ClipPlan, store_dir: str, clip_len: int,
               radi_displacement: int, split: str) -> str:
    """Pickle the plan in the reference's on-disk format (frame.py:181-194)."""
    path = os.path.join(store_dir, store_key(clip_len, radi_displacement, split))
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "frame_paths.pkl"), "wb") as f:
        pickle.dump(plan.frame_paths, f)
    with open(os.path.join(path, "labels.pkl"), "wb") as f:
        pickle.dump(plan.labels, f)
    if radi_displacement > 0 and plan.labels_d is not None:
        with open(os.path.join(path, "labelsD.pkl"), "wb") as f:
            pickle.dump(plan.labels_d, f)
    return path


def load_plan(store_dir: str, clip_len: int, radi_displacement: int,
              split: str) -> ClipPlan:
    """Unpickle a stored plan (ref: dataset/frame.py:197-208)."""
    path = os.path.join(store_dir, store_key(clip_len, radi_displacement, split))
    with open(os.path.join(path, "frame_paths.pkl"), "rb") as f:
        frame_paths = pickle.load(f)
    with open(os.path.join(path, "labels.pkl"), "rb") as f:
        labels = pickle.load(f)
    labels_d = None
    if radi_displacement > 0:
        with open(os.path.join(path, "labelsD.pkl"), "rb") as f:
            labels_d = pickle.load(f)
    return ClipPlan(frame_paths=frame_paths, labels=labels, labels_d=labels_d)


def rasterize_labels(
    labels: List[dict], labels_d: Optional[List[dict]], clip_len: int
):
    """Dense per-frame (label, displacement) vectors (ref: frame.py:226-233)."""
    import numpy as np

    out = np.zeros(clip_len, np.int64)
    for rec in labels:
        out[rec["label_idx"]] = rec["label"]
    out_d = None
    if labels_d is not None:
        out_d = np.zeros(clip_len, np.int64)
        for rec in labels_d:
            out_d[rec["label_idx"]] = rec["displ"]
    return out, out_d
