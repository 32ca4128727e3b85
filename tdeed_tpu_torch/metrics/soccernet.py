"""SoccerNet action-spotting metrics, first-party implementation.

The port's own copy of ``tdeed_tpu/metrics/soccernet.py`` (numpy only;
held equal by tests/test_torch_soccernet_copies.py). ``val_map_sn`` runs
the port's sliding-window inference and also takes the frame reader and
the decoded-frame cache the training CLI uses.

The reference calls the external ``SoccerNet`` pip package for SN test
scoring (ref: train_tdeed.py:25,272-284) and vendors a re-implementation for
SNB (``aux_evaluate`` — ref: util/eval.py:479-674). Here the whole metric is
first-party, following the public SoccerNet-v2 evaluation protocol:

  * events rasterized onto a 120-minute grid at ``framerate`` fps per game
    half (labels: +1 visible / -1 "not shown"; predictions: confidence,
    -1 = none) — ref behaviour: util/eval.py:591-674;
  * per delta (seconds), greedy matching: each ground truth claims the
    highest-scoring unclaimed prediction within ±delta*framerate/2 frames;
  * precision/recall over 200 confidence thresholds, AP via 11-point
    interpolation, averaged over classes then over deltas;
  * tight deltas 1..5 s, loose 5..60 s, at-k single deltas
    (ref: util/eval.py:449-462,566-580).

The SNB event dictionary matches the official challenge one
(ref: util/eval.py:506-507).
"""

from __future__ import annotations

import json
import os
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

VECTOR_MINUTES = 120
THRESHOLDS = np.linspace(0, 1, 200)

SNB_EVENTS = {
    "PASS": 0,
    "DRIVE": 1,
    "HEADER": 2,
    "HIGH PASS": 3,
    "OUT": 4,
    "CROSS": 5,
    "THROW IN": 6,
    "SHOT": 7,
    "BALL PLAYER BLOCK": 8,
    "PLAYER SUCCESSFUL TACKLE": 9,
    "FREE KICK": 10,
    "GOAL": 11,
}

SN_EVENTS = {
    "Penalty": 0, "Kick-off": 1, "Goal": 2, "Substitution": 3, "Offside": 4,
    "Shots on target": 5, "Shots off target": 6, "Clearance": 7,
    "Ball out of play": 8, "Throw-in": 9, "Foul": 10, "Indirect free-kick": 11,
    "Direct free-kick": 12, "Corner": 13, "Yellow card": 14, "Red card": 15,
    "Yellow->red card": 16,
}

SNB_GAMES = {
    # Hard-coded SNB split games (ref: util/eval.py:480-490)
    "train": [
        "england_efl/2019-2020/2019-10-01 - Leeds United - West Bromwich",
        "england_efl/2019-2020/2019-10-01 - Hull City - Sheffield Wednesday",
        "england_efl/2019-2020/2019-10-01 - Brentford - Bristol City",
        "england_efl/2019-2020/2019-10-01 - Blackburn Rovers - Nottingham Forest",
    ],
    "val": ["england_efl/2019-2020/2019-10-01 - Middlesbrough - Preston North End"],
    "test": [
        "england_efl/2019-2020/2019-10-01 - Stoke City - Huddersfield Town",
        "england_efl/2019-2020/2019-10-01 - Reading - Fulham",
    ],
    "challenge": [
        "england_efl/2019-2020/2019-10-02 - Cardiff City - Queens Park Rangers",
        "england_efl/2019-2020/2019-10-01 - Wigan Athletic - Birmingham City",
    ],
}


def deltas_for(metric: str) -> np.ndarray:
    """Delta sets in seconds (ref: util/eval.py:449-462)."""
    if metric == "loose":
        return np.arange(12) * 5 + 5
    if metric == "tight":
        return np.arange(5) + 1
    if metric.startswith("at"):
        return np.array([int(metric[2:])])
    raise ValueError(metric)


def _grid_size(framerate: float) -> int:
    """120-minute grid length. int() AFTER the multiply: val_map_sn uses the
    fractional framerate 25/stride, and truncating the rate first would
    shrink the grid below the positions the rasterizers compute."""
    return int(VECTOR_MINUTES * 60 * framerate)


def label2vector(
    annotations: Sequence[dict],
    num_classes: int,
    event_dict: Dict[str, int],
    framerate: float,
    half: int = 1,
) -> np.ndarray:
    """Rasterize GT events of one half onto the 120-min grid.

    +1 visible, -1 'not shown' (ref behaviour: util/eval.py:591-640).
    """
    size = _grid_size(framerate)
    vec = np.zeros((size, num_classes), np.float64)
    for ann in annotations:
        if ann["label"] not in event_dict:
            continue
        if int(ann["gameTime"][0]) != half:
            continue
        if "position" in ann:
            frame = int(framerate * int(ann["position"]) / 1000)
        else:
            # float multiply like the position path — int(framerate)*
            # would put gameTime-only events on a different grid for
            # fractional framerates
            mins = int(ann["gameTime"][-5:-3])
            secs = int(ann["gameTime"][-2:])
            frame = int(framerate * (secs + 60 * mins))
        value = -1.0 if ann.get("visibility") == "not shown" else 1.0
        vec[min(frame, size - 1), event_dict[ann["label"]]] = value
    return vec


def predictions2vector(
    predictions: Sequence[dict],
    num_classes: int,
    event_dict: Dict[str, int],
    framerate: float,
    half: int = 1,
) -> np.ndarray:
    """Rasterize predictions of one half; -1 marks 'no prediction'
    (ref behaviour: util/eval.py:643-674)."""
    size = _grid_size(framerate)
    vec = np.full((size, num_classes), -1.0, np.float64)
    for ann in predictions:
        if ann["label"] not in event_dict:
            continue
        if int(ann.get("half", 1)) != half:
            continue
        frame = int(framerate * int(ann["position"]) / 1000)
        vec[min(frame, size - 1), event_dict[ann["label"]]] = ann["confidence"]
    return vec


def closest_map(target: np.ndarray) -> np.ndarray:
    """For each frame/class, the value of the nearest GT event (midpoint
    partition), -1 where no GT exists (ref: util/eval.py:435-447)."""
    out = np.full(target.shape, -1.0)
    n = target.shape[0]
    for c in range(target.shape[1]):
        idxs = np.flatnonzero(target[:, c])
        if idxs.size == 0:
            continue
        bounds = np.concatenate(([-idxs[0]], idxs, [2 * n]))
        for i in range(1, len(bounds) - 1):
            start = max(0, (bounds[i - 1] + bounds[i]) // 2)
            stop = min(n, (bounds[i] + bounds[i + 1]) // 2)
            out[start:stop, c] = target[bounds[i], c]
    return out


def _match_class(
    target: np.ndarray, closest: np.ndarray, detection: np.ndarray, half_window: float
) -> Tuple[np.ndarray, int, int]:
    """Greedy per-GT matching for one (game, class) vector pair.

    Returns (detections[N, 3] = [score, matched, closest_gt_value],
    n_visible_gt, n_unshown_gt).
    """
    gt_idx = np.flatnonzero(target != 0)
    pred_idx = np.flatnonzero(detection >= 0)
    scores = detection[pred_idx]
    det = np.zeros((pred_idx.size, 3))
    det[:, 0] = scores
    det[:, 2] = closest[pred_idx]

    claimed = np.zeros(pred_idx.size, bool)
    for g in gt_idx:
        lo = np.searchsorted(pred_idx, g - half_window, side="left")
        hi = np.searchsorted(pred_idx, g + half_window, side="right")
        if lo >= hi:
            continue
        cand = np.arange(lo, hi)[~claimed[lo:hi]]
        if cand.size == 0:
            continue
        best = cand[np.argmax(scores[cand])]
        det[best, 1] = 1
        claimed[best] = True
    return det, int(np.sum(target > 0)), int(np.sum(target < 0))


def _ap_11pt(precision: np.ndarray, recall: np.ndarray) -> float:
    """11-point interpolated AP over a (thresholds,) PR curve."""
    ap = 0.0
    for r in np.arange(11) / 10.0:
        mask = recall >= r
        ap += float(np.max(precision[mask])) if np.any(mask) else 0.0
    return ap / 11.0


def _pr_curves(all_det: np.ndarray, n_gt: int, visibility: Optional[int]):
    """precision/recall over the 200-threshold grid for one class.

    visibility: None = all, +1 = visible-only, -1 = unshown-only (matched
    detections attributed by the sign of their closest-GT value)."""
    if visibility is not None:
        keep = all_det[:, 2] == visibility if visibility < 0 else all_det[:, 2] >= 0
        all_det = all_det[keep]
    precision = np.zeros(THRESHOLDS.size)
    recall = np.zeros(THRESHOLDS.size)
    for i, th in enumerate(THRESHOLDS):
        above = all_det[:, 0] >= th
        p = int(np.sum(above))
        tp = int(np.sum(all_det[above, 1]))
        # nan_to_num semantics of the official scorer: empty bins score 0
        precision[i] = tp / p if p > 0 else 0.0
        recall[i] = tp / n_gt if n_gt > 0 else 0.0
    return precision, recall


def average_map(
    targets: List[np.ndarray],
    detections: List[np.ndarray],
    closests: Optional[List[np.ndarray]] = None,
    framerate: float = 25,
    deltas: Sequence[int] = (1, 2, 3, 4, 5),
) -> Dict[str, object]:
    """SoccerNet average-mAP over delta tolerances.

    targets/detections: per game-half (T, C) vectors from
    label2vector/predictions2vector.
    """
    if closests is None:
        closests = [closest_map(t) for t in targets]
    num_classes = targets[0].shape[1]

    maps, maps_vis, maps_uns = [], [], []
    per_class = np.zeros((len(deltas), num_classes))
    for di, delta in enumerate(deltas):
        half_window = delta * framerate / 2.0
        ap, ap_vis, ap_uns = [], [], []
        for c in range(num_classes):
            rows = []
            n_vis = n_uns = 0
            for t, cl, d in zip(targets, closests, detections):
                det, nv, nu = _match_class(t[:, c], cl[:, c], d[:, c], half_window)
                rows.append(det)
                n_vis += nv
                n_uns += nu
            all_det = (
                np.concatenate(rows, axis=0) if rows else np.zeros((0, 3))
            )
            p, r = _pr_curves(all_det, n_vis + n_uns, None)
            ap.append(_ap_11pt(p, r))
            p, r = _pr_curves(all_det, n_vis, 1)
            ap_vis.append(_ap_11pt(p, r))
            p, r = _pr_curves(all_det, n_uns, -1)
            ap_uns.append(_ap_11pt(p, r))
            per_class[di, c] = ap[-1]
        maps.append(float(np.mean(ap)))
        maps_vis.append(float(np.mean(ap_vis)))
        maps_uns.append(float(np.mean(ap_uns)))

    def avg_over_deltas(values: np.ndarray) -> np.ndarray:
        # Official SoccerNet a-mAP integrates the mAP-vs-delta curve with
        # the trapezoid rule normalized by (n-1) — NOT a plain mean (the
        # endpoints carry half weight). Single-delta metrics (at-k) are the
        # value itself.
        values = np.asarray(values, np.float64)
        if values.shape[0] <= 1:
            return values[0]
        return np.trapezoid(values, axis=0) / (values.shape[0] - 1)

    # Unshown rescale: only 13 of SoccerNet's 17 classes can carry
    # 'not shown' annotations; the official scorer scales the unshown
    # average up by 17/13 to compensate.
    return {
        "a_mAP": float(avg_over_deltas(maps)),
        "a_mAP_per_class": list(np.atleast_1d(avg_over_deltas(per_class))),
        "a_mAP_visible": float(avg_over_deltas(maps_vis)),
        "a_mAP_unshown": float(avg_over_deltas(maps_uns)) * 17.0 / 13.0,
        "a_mAP_per_delta": maps,
    }


def _load_json(path: str):
    with open(path) as fp:
        return json.load(fp)


def rasterize_games(
    labels_root: str,
    preds_root: str,
    games: Sequence[str],
    label_file: str,
    num_classes: int,
    event_dict: Dict[str, int],
    framerate: float,
    halves: Sequence[int] = (1,),
):
    """(targets, detections) vectors for a stored prediction tree — shared
    across metrics so tight+loose don't re-read/re-rasterize every game."""
    targets, detections = [], []
    for game in games:
        labels = _load_json(os.path.join(labels_root, game, label_file))
        preds = _load_json(os.path.join(preds_root, game, "results_spotting.json"))
        for half in halves:
            targets.append(
                label2vector(
                    labels["annotations"], num_classes, event_dict, framerate, half
                )
            )
            detections.append(
                predictions2vector(
                    preds["predictions"], num_classes, event_dict, framerate, half
                )
            )
    return targets, detections


def evaluate_games(
    labels_root: str,
    preds_root: str,
    games: Sequence[str],
    label_file: str,
    num_classes: int,
    event_dict: Dict[str, int],
    metric: str,
    framerate: float,
    halves: Sequence[int] = (1,),
) -> Dict[str, object]:
    """Score stored results_spotting.json trees against a label tree
    (ref behaviour: util/eval.py:496-589)."""
    targets, detections = rasterize_games(
        labels_root, preds_root, games, label_file, num_classes, event_dict,
        framerate, halves,
    )
    return average_map(
        targets, detections, framerate=framerate, deltas=deltas_for(metric)
    )


def evaluate_snb(
    labels_root: str, preds_root: str, split: str = "test"
) -> Dict[str, object]:
    """SNB a-mAP@1 over the hard-coded split games (ref: util/eval.py:479-494)."""
    results = evaluate_games(
        labels_root,
        preds_root,
        SNB_GAMES[split],
        "Labels-ball.json",
        num_classes=12,
        event_dict=SNB_EVENTS,
        metric="at1",
        framerate=25,
        halves=(1,),
    )
    print(f"SNB {split} a-mAP@1: {results['a_mAP']:.4f}")
    return results


def evaluate_sn_official(
    labels_root: str, preds_root: str, split: str = "test",
    games: Optional[Sequence[str]] = None,
) -> Dict[str, Dict[str, object]]:
    """SN tight + loose average-mAP over both halves per game
    (ref: train_tdeed.py:271-296). Games default to every directory under
    preds_root that contains a results_spotting.json."""
    if games is None:
        games = sorted(
            os.path.relpath(root, preds_root)
            for root, _, files in os.walk(preds_root)
            if "results_spotting.json" in files
        )
    targets, detections = rasterize_games(
        labels_root, preds_root, games, "Labels-v2.json", 17, SN_EVENTS,
        framerate=2, halves=(1, 2),
    )
    closests = [closest_map(t) for t in targets]
    out = {}
    for metric in ("tight", "loose"):
        out[metric] = average_map(
            targets, detections, closests, framerate=2,
            deltas=deltas_for(metric),
        )
        print(f"SN {split} {metric} a-mAP: {out[metric]['a_mAP']:.4f}")
    return out


def val_map_sn(
    predict_fn: Callable,
    cfg,
    data_root: str,
    labels_root: str,
    batch_size: Optional[int] = None,
    decoder: Optional[Callable] = None,
    cache=None,
) -> float:
    """Validation tight a-mAP for SN via sliding-window inference over the
    val split (TPU-native equivalent of the reference's collected-tensor
    valMAP_SN path — ref: util/eval.py:422-476, model/model.py:204-274).

    DELIBERATE DELTA from the reference. The reference scores the val
    epoch's *randomly sampled training clips* (whatever windows the val
    loader happened to draw, concatenated per video in draw order,
    ref: model/model.py:204-274); this redesign runs the deterministic
    sliding-window inference used at test time (overlap 0, eval stride) and
    scores that. Consequences:
      * the metric here is deterministic across epochs (the reference's
        varies with the sampler RNG) and covers every video frame exactly
        once, so epoch-to-epoch comparisons are cleaner;
      * absolute values differ slightly from the reference's (different
        window coverage), but best-epoch selection only needs a consistent
        ordering — both track the same underlying tight a-mAP. The at-1.0
        oracle fixture (tests/test_soccernet_evaluators.py
        ::test_val_map_sn_with_oracle) pins the scale, and
        tests/test_valmap_selector.py shows both selectors rank a synthetic
        training trajectory identically across clip-sampling RNGs.
    """
    from tdeed_tpu_torch.data.registry import get_spec, load_classes
    from tdeed_tpu_torch.infer.evaluate import INFERENCE_BATCH_SIZE, run_inference
    from tdeed_tpu_torch.infer.windows import VideoWindows

    spec = get_spec("soccernet")
    classes = load_classes(os.path.join(data_root, "soccernet", "class.txt"))
    data = VideoWindows(
        "soccernet",
        os.path.join(data_root, "soccernet", "val.json"),
        cfg.frame_dir,
        cfg.clip_len,
        overlap_len=0,
        stride=spec.eval_stride,
        labels_root=labels_root,
        decoder=decoder,
        cache=cache,
    )
    pred_dict = run_inference(
        predict_fn, data, classes, augment=False,
        batch_size=batch_size or INFERENCE_BATCH_SIZE,
    )

    framerate = 25 / spec.eval_stride
    idx_for = {}  # class name -> SN_EVENTS index
    for name in classes:
        idx_for[classes[name]] = SN_EVENTS.get(name)

    targets, detections = [], []
    for video, (scores, support) in sorted(pred_dict.items()):
        support = support.copy()
        support[support == 0] = 1
        probs = scores / support[:, None]
        meta = data.videos_meta[data._video_idx[video]]
        half = int(video[-1])
        events = data._events_for(meta)[0]
        size = _grid_size(framerate)
        t = label2vector(events, 17, SN_EVENTS, framerate, half)
        d = np.full((size, 17), -1.0)
        n = min(size, probs.shape[0])
        for cls_id, sn_idx in idx_for.items():
            if sn_idx is None:
                continue
            d[:n, sn_idx] = probs[:n, cls_id]
        targets.append(t)
        detections.append(d)

    res = average_map(
        targets, detections, framerate=framerate, deltas=deltas_for("tight")
    )
    return float(res["a_mAP"])
