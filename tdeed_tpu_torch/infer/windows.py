"""Sliding-window evaluation dataset over full videos.

The port's own copy of ``tdeed_tpu/infer/windows.py`` (held equal by
tests/test_torch_infer_copies.py). Reproduces ActionSpotVideoDataset
(ref: dataset/frame.py:385-543): deterministic overlapping windows per
video, per-video dense label vectors, and stride-rescaled metadata for the
scorers.
"""

from __future__ import annotations

import copy
import math
import os
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np

from tdeed_tpu_torch.data.frames import get_decoder, load_window
from tdeed_tpu_torch.data.registry import (
    DEFAULT_PAD_LEN,
    FPS_SN,
    event_frame,
    get_spec,
)
from tdeed_tpu_torch.utils.io import load_json


class VideoWindows:
    """Window enumeration + label access for one split of one dataset."""

    def __init__(
        self,
        dataset: str,
        label_file: str,
        frame_dir: str,
        clip_len: int,
        overlap_len: int = 0,
        stride: int = 1,
        pad_len: int = DEFAULT_PAD_LEN,
        labels_root: Optional[str] = None,
        decoder: Callable[[str], np.ndarray] = None,
        cache=None,
    ):
        self.dataset = dataset
        self.spec = get_spec(dataset)
        self.videos_meta = load_json(label_file)
        self.clip_len = clip_len
        self.overlap_len = overlap_len
        self.stride = stride
        self.pad_len = pad_len
        self.labels_root = labels_root
        self.frame_dir = frame_dir
        self.decoder = decoder or get_decoder()
        # Optional decoded-frame LRU (data/loader.FrameCache): overlapping
        # windows re-read ~overlap_len/clip_len of their frames.
        self.cache = cache
        self._video_idx = {v["video"]: i for i, v in enumerate(self.videos_meta)}

        # Window starts (ref: dataset/frame.py:409-423)
        self.clips: List[Tuple[str, int, Optional[dict]]] = []
        for v in self.videos_meta:
            has_clip = False
            src = v.get("_source_info") if self.spec.uses_source_info else None
            for i in range(
                -pad_len * stride,
                max(0, v["num_frames"] - overlap_len * stride),
                (clip_len - overlap_len) * stride,
            ):
                has_clip = True
                self.clips.append((v["video"], i, src))
            assert has_clip, v

    def __len__(self) -> int:
        return len(self.clips)

    def load_clip(self, idx: int) -> Optional[Dict]:
        video, start, src = self.clips[idx]
        frames = load_window(
            self.spec,
            self.frame_dir,
            video,
            start,
            start + self.clip_len * self.stride,
            self.stride,
            self.decoder,
            pad=True,
            source_info=src,
            cache=self.cache,
        )
        if frames is None:
            return None
        # load_window(pad=True) accounts for every slot (decoded or
        # zero-padded), so the static clip length always holds.
        assert frames.shape[0] == self.clip_len, (frames.shape, self.clip_len)
        return {"video": video, "start": start // self.stride, "frame": frames}

    def batches(
        self, batch_size: int, num_workers: int = 8
    ) -> Iterator[List[Dict]]:
        """Decode windows with a thread pool, yield lists of clip dicts."""
        with ThreadPoolExecutor(max_workers=num_workers) as pool:
            for ofs in range(0, len(self.clips), batch_size):
                idxs = range(ofs, min(ofs + batch_size, len(self.clips)))
                out = [c for c in pool.map(self.load_clip, idxs) if c is not None]
                if out:
                    yield out

    # -- label access (ref: dataset/frame.py:454-533) ----------------------

    def _events_for(self, meta: dict) -> Tuple[List[dict], int]:
        if self.dataset == "soccernet":
            events = load_json(
                os.path.join(
                    self.labels_root,
                    "/".join(meta["video"].split("/")[:-1]) + "/Labels-v2.json",
                )
            )["annotations"]
            return events, int(meta["video"][-1])
        if self.dataset == "soccernetball":
            events = load_json(
                os.path.join(self.labels_root, meta["video"] + "/Labels-ball.json")
            )["annotations"]
            return events, 1
        return meta["events"], 0

    def get_labels(self, video: str, classes: Dict[str, int]) -> np.ndarray:
        meta = self.videos_meta[self._video_idx[video]]
        events, half = self._events_for(meta)
        num_frames = meta["num_frames"]
        num_labels = math.ceil(num_frames / self.stride)
        labels = np.zeros(num_labels, np.int64)
        for e in events:
            frame, ehalf = event_frame(e, self.dataset)
            if ehalf == half and frame < num_frames:
                labels[frame // self.stride] = classes[e["label"]]
        return labels

    @property
    def videos(self) -> List[Tuple[str, int, float]]:
        out = []
        for v in self.videos_meta:
            fps = FPS_SN if self.dataset in ("soccernet", "soccernetball") else v["fps"]
            out.append(
                (v["video"], math.ceil(v["num_frames"] / self.stride), fps / self.stride)
            )
        return sorted(out)

    @property
    def labels(self) -> List[dict]:
        """Video metadata with stride-rescaled events for the mAP scorer
        (ref: dataset/frame.py:498-533)."""
        if self.stride == 1 and not self.spec.external_labels:
            return self.videos_meta
        out = []
        for v in self.videos_meta:
            vc = copy.deepcopy(v)
            if self.dataset in ("soccernet", "soccernetball"):
                vc["fps"] = FPS_SN / self.stride
            else:
                vc["fps"] = vc["fps"] / self.stride
            vc["num_frames"] = vc["num_frames"] // self.stride
            events, half = self._events_for(v)
            if self.spec.external_labels:
                events = copy.deepcopy(events)
                for e in events:
                    f, ehalf = event_frame(e, self.dataset)
                    if self.dataset == "soccernetball" or ehalf == half:
                        e["frame"] = f // self.stride
                vc["events"] = events
            else:
                for e in vc["events"]:
                    e["frame"] = e["frame"] // self.stride
            out.append(vc)
        return out
