"""Inference orchestrator: sliding-window predict -> overlap aggregation ->
frame stats -> NMS/SoftNMS -> tolerance mAP -> prediction stores.

The port's own copy of ``tdeed_tpu/infer/evaluate.py`` (held equal by
tests/test_torch_infer_copies.py and tests/test_torch_predictor.py), with
one change: ``predict_windows`` takes the scores of a torch ``predict_fn``
(on any device) to the host itself.

Reproduces evaluate() (ref: util/eval.py:264-419): per-video score/support
accumulators, batch-4 inference (batch-1 + forced-hflip TTA when augmenting),
support counted from rows that received any displaced score (the
displacement decode leaves unclaimed rows zero — ref: util/eval.py:317),
window clamping at video bounds, then the NMS-vs-SoftNMS selection.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from tdeed_tpu_torch.data.registry import get_spec
from tdeed_tpu_torch.infer.nms import non_maximum_suppression, soft_non_maximum_suppression
from tdeed_tpu_torch.infer.windows import VideoWindows
from tdeed_tpu_torch.metrics.map import compute_maps
from tdeed_tpu_torch.utils.io import store_json, store_json_sn, store_json_snb

INFERENCE_BATCH_SIZE = 4  # ref: util/eval.py:32


class ErrorStat:
    """Frame-level error rate (ref: util/eval.py:34-48)."""

    def __init__(self):
        self._total = 0
        self._err = 0

    def update(self, true: np.ndarray, pred: np.ndarray) -> None:
        self._err += int(np.sum(true != pred))
        self._total += int(true.shape[0])

    def get(self) -> float:
        return self._err / max(1, self._total)


class ForegroundF1:
    """Per-class + any-class exact-frame F1 (ref: util/eval.py:50-85)."""

    def __init__(self):
        self._tp = defaultdict(int)
        self._fp = defaultdict(int)
        self._fn = defaultdict(int)

    def update(self, true: int, pred: int) -> None:
        if pred != 0:
            if true != 0:
                self._tp[None] += 1
            else:
                self._fp[None] += 1
            if pred == true:
                self._tp[pred] += 1
            else:
                self._fp[pred] += 1
                if true != 0:
                    self._fn[true] += 1
        elif true != 0:
            self._fn[None] += 1
            self._fn[true] += 1

    def update_all(self, true: np.ndarray, pred: np.ndarray) -> None:
        """Vectorized equivalent of calling update() per frame (the
        reference walks frames in Python — ref: util/eval.py:117-124; on an
        SN test split that is ~10^6 interpreter iterations)."""
        true = np.asarray(true).ravel()
        pred = np.asarray(pred).ravel()
        pred_fg = pred != 0
        true_fg = true != 0
        match = pred == true
        self._tp[None] += int(np.sum(pred_fg & true_fg))
        self._fp[None] += int(np.sum(pred_fg & ~true_fg))
        self._fn[None] += int(np.sum(~pred_fg & true_fg))
        n = int(max(true.max(initial=0), pred.max(initial=0))) + 1
        for c, v in enumerate(np.bincount(pred[pred_fg & match], minlength=n)):
            if c and v:
                self._tp[c] += int(v)
        for c, v in enumerate(np.bincount(pred[pred_fg & ~match], minlength=n)):
            if c and v:
                self._fp[c] += int(v)
        for c, v in enumerate(np.bincount(true[true_fg & ~match], minlength=n)):
            if c and v:
                self._fn[c] += int(v)

    def get(self, k) -> float:
        denom = self._tp[k] + 0.5 * self._fp[k] + 0.5 * self._fn[k]
        if denom == 0:
            return 0.0
        return self._tp[k] / denom

    def tp_fp_fn(self, k) -> Tuple[int, int, int]:
        return self._tp[k], self._fp[k], self._fn[k]


def process_frame_predictions(
    data: VideoWindows,
    classes: Dict[str, int],
    pred_dict: Dict[str, Tuple[np.ndarray, np.ndarray]],
    high_recall_score_threshold: float = 0.01,
    with_stats: bool = True,
    with_scores: bool = False,
):
    """Support-normalize, argmax, build event lists + frame stats
    (ref: util/eval.py:87-193). pred_scores materializes only when
    with_scores=True — the reference builds it unconditionally and every
    caller discards it (~10^7 boxed floats on an SN eval)."""
    classes_inv = {v: k for k, v in classes.items()}
    fps_dict = {video: fps for video, _, fps in data.videos}

    err = ErrorStat()
    f1 = ForegroundF1()
    pred_events = []
    pred_events_high_recall = []
    pred_scores = {}

    for video, (scores, support) in sorted(pred_dict.items()):
        support = support.copy()
        support[support == 0] = 1
        scores = scores / support[:, None]
        pred = np.argmax(scores, axis=1)

        if with_stats:
            label = data.get_labels(video, classes)
            err.update(label, pred)
            f1.update_all(label, pred)

        if with_scores:
            pred_scores[video] = scores.tolist()

        # Event extraction, vectorized (the reference's frame x class Python
        # loop is minutes of interpreter time on an SN split — ref:
        # util/eval.py:126-140). Dict building only touches the hits.
        fg = np.flatnonzero(pred)
        events = [
            {"label": classes_inv[int(pred[i])], "frame": int(i),
             "score": float(scores[i, pred[i]])}
            for i in fg
        ]
        # High-recall list in the reference's exact order: frames ascending,
        # classes in classes_inv insertion order within each frame (NMS tie
        # order downstream depends on it).
        cols = np.fromiter(classes_inv, dtype=np.int64)
        ii, kk = np.nonzero(scores[:, cols] >= high_recall_score_threshold)
        names = [classes_inv[int(c)] for c in cols]
        hit_scores = scores[ii, cols[kk]]
        events_high_recall = [
            {"label": names[k], "frame": int(i), "score": float(s)}
            for i, k, s in zip(ii, kk, hit_scores)
        ]
        pred_events.append({"video": video, "events": events, "fps": fps_dict[video]})
        pred_events_high_recall.append(
            {"video": video, "events": events_high_recall, "fps": fps_dict[video]}
        )

    return err, f1, pred_events, pred_events_high_recall, pred_scores


def accumulate_scores(
    pred_dict: Dict[str, Tuple[np.ndarray, np.ndarray]],
    video: str,
    start: int,
    pred_scores: np.ndarray,
    support_rows: Optional[np.ndarray] = None,
) -> None:
    """Add one window's scores into the per-video accumulator with the
    reference's bound clamping (ref: util/eval.py:303-317)."""
    scores, support = pred_dict[video]
    if start < 0:
        pred_scores = pred_scores[-start:, :]
        if support_rows is not None:
            support_rows = support_rows[-start:]
        start = 0
    end = start + pred_scores.shape[0]
    if end >= scores.shape[0]:
        end = scores.shape[0]
        pred_scores = pred_scores[: end - start, :]
        if support_rows is not None:
            support_rows = support_rows[: end - start]
    scores[start:end, :] += pred_scores
    if support_rows is None:
        support[start:end] += 1
    else:
        support[start:end] += support_rows


def predict_windows(
    predict_fn: Callable[[np.ndarray, bool], torch.Tensor],
    pred_dict: Dict[str, Tuple[np.ndarray, np.ndarray]],
    batches,
    batch_size: int,
    augment: bool,
) -> None:
    """The shared window->accumulator inner loop (evaluation AND serving).

    batches yields lists of {'video', 'start', 'frame'} clips. Semantics per
    ref util/eval.py:290-349: optional forced-hflip TTA second pass with
    unconditional support; otherwise support only on rows that received any
    displaced score (ref: util/eval.py:317,334,349).
    """
    for batch in batches:
        frames = np.stack([c["frame"] for c in batch], axis=0)
        # Pad ragged tails (last window batch / filtered clips) to the
        # static batch size so predict compiles exactly once per hflip
        # value; padded rows are sliced off below. Eval BN uses running
        # stats, so rows are independent and padding cannot leak.
        n = len(batch)
        if n < batch_size:
            frames = np.concatenate(
                [frames, np.zeros((batch_size - n, *frames.shape[1:]),
                                  frames.dtype)], axis=0
            )
        passes = [False, True] if augment else [False]
        for hflip in passes:
            # The one change from the JAX package's loop: np.asarray cannot
            # read a CUDA tensor, so the scores come to the host explicitly
            # (a numpy result passes through as_tensor unchanged).
            probs = torch.as_tensor(predict_fn(frames, hflip)).float().cpu().numpy()[:n]
            for i, clip in enumerate(batch):
                if augment:
                    rows = None  # TTA counts support per pass
                else:
                    rows = (probs[i].sum(axis=1) != 0).astype(np.int32)
                accumulate_scores(
                    pred_dict, clip["video"], int(clip["start"]), probs[i], rows
                )


def run_inference(
    predict_fn: Callable[[np.ndarray, bool], np.ndarray],
    data: VideoWindows,
    classes: Dict[str, int],
    augment: bool = False,
    batch_size: int = INFERENCE_BATCH_SIZE,
) -> Dict[str, Tuple[np.ndarray, np.ndarray]]:
    """Run sliding-window inference and aggregate overlapping scores.

    predict_fn(frames_u8 (B,T,H,W,3), hflip) -> probs (B,T,C+1) float.
    augment=True adds the forced-hflip TTA second pass
    (ref: util/eval.py:290-349).
    """
    pred_dict = {
        video: (
            np.zeros((video_len, len(classes) + 1), np.float32),
            np.zeros(video_len, np.int32),
        )
        for video, video_len, _ in data.videos
    }
    predict_windows(
        predict_fn, pred_dict, data.batches(batch_size), batch_size, augment
    )
    return pred_dict


def evaluate(
    predict_fn,
    data: VideoWindows,
    split: str,
    classes: Dict[str, int],
    save_pred: Optional[str] = None,
    printed: bool = True,
    test: bool = False,
    augment: bool = False,
    labels_root: Optional[str] = None,
    batch_size: Optional[int] = None,
):
    """Full protocol (ref: util/eval.py:264-419). Returns avg mAP (val mode)
    or (mAPs, tolerances) (test mode).

    batch_size: window-batch override (e.g. a multiple of a DP mesh size for
    sharded predict_fns). Default mirrors the reference: 1 under TTA, else
    INFERENCE_BATCH_SIZE (ref: util/eval.py:32). Results are per-window
    accumulations, so batching never changes them.
    """
    spec = get_spec(data.dataset)
    tolerances = list(spec.tolerances)
    windows = list(spec.windows)

    if batch_size is None:
        batch_size = 1 if augment else INFERENCE_BATCH_SIZE
    pred_dict = run_inference(predict_fn, data, classes, augment, batch_size)

    challenge = split == "CHALLENGE"
    err, f1, pred_events, pred_events_hr, _ = process_frame_predictions(
        data, classes, pred_dict, high_recall_score_threshold=0.01,
        with_stats=not challenge,
    )

    if not test:
        pred_nms = non_maximum_suppression(pred_events_hr, windows[0], threshold=0.10)
        maps, _ = compute_maps(
            data.labels, pred_nms, tolerances, printed=printed, labels_root=labels_root
        )
        return float(np.mean(maps))

    if challenge:
        # DELIBERATE parity fix: the reference computes the SNMS list and
        # prints "Storing predictions Challenge with SNMS" but then stores
        # the UN-suppressed high-recall variable (ref: util/eval.py:415-418
        # stores pred_events_high_recall, not ..._store) — an evident slip.
        # We store what it intended: the SNMS-filtered predictions.
        pred_store = soft_non_maximum_suppression(
            pred_events_hr, windows[1], threshold=0.01
        )
        if save_pred is not None:
            store_json_snb(save_pred, pred_store, stride=data.stride)
        return None, None

    print(f"=== Results on {split} (w/o NMS) ===")
    print("Error (frame-level): {:0.2f}\n".format(err.get() * 100))
    rows = []
    for name in ["any"] + sorted(classes):
        k = classes[name] if name != "any" else None
        rows.append(
            "{}\tF1={:0.2f}\tTP={} FP={} FN={}".format(
                name, f1.get(k) * 100, *f1.tp_fp_fn(k)
            )
        )
    print("\n".join(rows) + "\n")

    maps, _ = compute_maps(
        data.labels, pred_events_hr, tolerances, printed=printed, labels_root=labels_root
    )

    print(f"=== Results on {split} (w/ NMS{windows[0]}) ===")
    pred_nms = non_maximum_suppression(pred_events_hr, windows[0], threshold=0.01)
    maps_nms, tols = compute_maps(
        data.labels, pred_nms, tolerances, printed=printed, labels_root=labels_root
    )

    print(f"=== Results on {split} (w/ SNMS{windows[1]}) ===")
    pred_snms = soft_non_maximum_suppression(pred_events_hr, windows[1], threshold=0.01)
    maps_snms, _ = compute_maps(
        data.labels, pred_snms, tolerances, printed=printed, labels_root=labels_root
    )

    if np.mean(maps_snms) > np.mean(maps_nms):
        print("Storing predictions with SNMS")
        pred_store = pred_snms
    else:
        print("Storing predictions with NMS")
        pred_store = pred_nms

    if save_pred is not None:
        os.makedirs(os.path.dirname(save_pred), exist_ok=True)
        store_json(save_pred + ".json", pred_store)
        if data.dataset == "soccernet":
            store_json_sn(save_pred, pred_store, stride=data.stride)
        if data.dataset == "soccernetball":
            store_json_snb(save_pred, pred_store, stride=data.stride)

    # The reference returns the *SNMS* mAPs with the NMS call's tolerances
    # (ref: util/eval.py:392-393,413).
    return maps_snms, tols
