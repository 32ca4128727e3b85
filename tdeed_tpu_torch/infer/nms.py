"""Spotting postprocessors: hard NMS and Soft-NMS over event lists.

The port's own copy of ``tdeed_tpu/infer/nms.py`` (held equal by
tests/test_torch_infer_copies.py).

Same semantics as the reference postprocessors (ref: util/eval.py:195-261)
— per class, repeatedly take the max-score event; hard NMS drops
neighbours within ±window frames, Soft-NMS decays their scores by
|Δframe|² / window² — but NOT the reference's O(n²) Python scan per
emission. Hard NMS is a single score-ordered sweep with a suppression
mask; Soft-NMS keeps a lazy max-heap and only touches the ±window
neighbourhood of each emitted event (O(n·(log n + w))). Both reproduce
the greedy emission order, tie-breaking (first-listed among equal
scores), and float-exact decay products of the literal loops
(fuzzed in tests/test_nms_fuzz.py); at SN scale (5.6k frames x 17
classes x hundreds of halves above the 0.01 threshold) the literal loops
are minutes of interpreter time per split.
"""

from __future__ import annotations

import heapq
from collections import defaultdict
from typing import Dict, List, Union

import numpy as np

Window = Union[int, List[int]]


def _class_windows(events_by_label, window: Window):
    if isinstance(window, list):
        return {lbl: window[i] for i, lbl in enumerate(events_by_label)}
    return {lbl: window for lbl in events_by_label}


def _split_by_label(video_pred):
    events_by_label: Dict[str, List[dict]] = defaultdict(list)
    for e in video_pred["events"]:
        events_by_label[e["label"]].append(e)
    return events_by_label


def _rebuild(video_pred, events):
    events.sort(key=lambda x: x["frame"])
    out = {k: v for k, v in video_pred.items() if k != "events"}
    out["events"] = events
    out["num_events"] = len(events)
    return out


def _hard_nms_class(evts: List[dict], cw: int, threshold: float) -> List[dict]:
    """Greedy max-take with neighbour removal == score-descending sweep
    skipping already-suppressed events. Ties keep the first-listed event
    (stable sort on -score), matching the reference's max() scan."""
    scores = np.asarray([e["score"] for e in evts], np.float64)
    frames = np.asarray([e["frame"] for e in evts], np.int64)
    order = np.argsort(-scores, kind="stable")
    alive = np.ones(len(evts), bool)
    out = []
    for i in order:
        if not alive[i]:
            continue
        if scores[i] < threshold:
            break
        out.append(dict(evts[i]))
        alive &= np.abs(frames - frames[i]) > cw
    return out


def _soft_nms_class(evts: List[dict], cw: int, threshold: float) -> List[dict]:
    """Literal greedy semantics via a lazy max-heap + frame-sorted
    neighbourhood lookup. Decays are applied in emission order with the
    same float multiplications as the reference loop, so scores are
    bit-identical; the heap's (score, insertion-index) ordering reproduces
    the first-listed tie-break."""
    n = len(evts)
    scores = [float(e["score"]) for e in evts]
    frames = np.asarray([e["frame"] for e in evts], np.int64)
    by_frame = np.argsort(frames, kind="stable")
    frames_sorted = frames[by_frame]
    alive = [True] * n
    heap = [(-scores[i], i) for i in range(n)]
    heapq.heapify(heap)
    out = []
    while heap:
        neg, i = heapq.heappop(heap)
        if not alive[i] or -neg != scores[i]:
            continue  # stale entry
        if scores[i] < threshold:
            break
        out.append(dict(evts[i], score=scores[i]))
        alive[i] = False
        lo = np.searchsorted(frames_sorted, frames[i] - cw, side="left")
        hi = np.searchsorted(frames_sorted, frames[i] + cw, side="right")
        for j in by_frame[lo:hi]:
            if not alive[j]:
                continue
            scores[j] = scores[j] * abs(frames[i] - frames[j]) ** 2 / cw ** 2
            heapq.heappush(heap, (-scores[j], int(j)))
    return out


def non_maximum_suppression(
    pred: List[dict], window: Window, threshold: float = 0.0
) -> List[dict]:
    """Hard NMS (ref: util/eval.py:195-227)."""
    new_pred = []
    for video_pred in pred:
        events_by_label = _split_by_label(video_pred)
        windows = _class_windows(events_by_label, window)
        events = []
        for lbl, v in events_by_label.items():
            events.extend(_hard_nms_class(v, windows[lbl], threshold))
        new_pred.append(_rebuild(video_pred, events))
    return new_pred


def soft_non_maximum_suppression(
    pred: List[dict], window: Window, threshold: float = 0.01
) -> List[dict]:
    """Soft-NMS with quadratic decay (ref: util/eval.py:229-261)."""
    new_pred = []
    for video_pred in pred:
        events_by_label = _split_by_label(video_pred)
        windows = _class_windows(events_by_label, window)
        events = []
        for lbl, v in events_by_label.items():
            events.extend(_soft_nms_class(v, windows[lbl], threshold))
        new_pred.append(_rebuild(video_pred, events))
    return new_pred
