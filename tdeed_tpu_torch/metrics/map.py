"""Tolerance-mAP scorer: greedy nearest-GT matching within ±tolerance frames.

The port's own copy of ``tdeed_tpu/metrics/map.py`` (held equal by
tests/test_torch_infer_copies.py), a first-party reimplementation of the
reference metric (ref: util/score.py:16-161): per class, predictions are
globally sorted by score; each is matched to the closest unclaimed GT frame
in the same video; AP is the interpolated precision curve integrated over
TOTAL GT bins.
"""

from __future__ import annotations

import os
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from tdeed_tpu_torch.data.registry import FPS_SN  # single source (ref: dataset/frame.py:27)
from tdeed_tpu_torch.utils.io import load_json


def parse_ground_truth(truth: List[dict], labels_root: Optional[str] = None):
    """label -> video -> [frames] (ref: util/score.py:16-32)."""
    label_dict: Dict[str, Dict[str, List[int]]] = defaultdict(
        lambda: defaultdict(list)
    )
    for x in truth:
        if "events" not in x:
            assert labels_root is not None, "SN truth needs labels_root"
            events = load_json(
                os.path.join(
                    labels_root, "/".join(x["video"].split("/")[:-1]) + "/Labels-v2.json"
                )
            )["annotations"]
        else:
            events = x["events"]
        for e in events:
            frame = (
                e["frame"]
                if "frame" in e
                else int(int(e["position"]) / 1000 * FPS_SN)
            )
            label_dict[e["label"]][x["video"]].append(frame)
    return label_dict


def get_predictions(pred: List[dict], label: Optional[str] = None):
    """Flatten per-video event lists into score-descending (video, frame, score)
    rows. A stable argsort on -score preserves flattening order among ties,
    which the greedy matcher's claim order depends on."""
    videos: List[str] = []
    frames: List[int] = []
    scores: List[float] = []
    for x in pred:
        for e in x["events"]:
            if label is None or e["label"] == label:
                videos.append(x["video"])
                frames.append(e["frame"])
                scores.append(e["score"])
    order = np.argsort(-np.asarray(scores, dtype=np.float64), kind="stable")
    return [(videos[k], frames[k], scores[k]) for k in order]


def _greedy_match(
    pred: Sequence[Tuple[str, int, float]],
    truth: Dict[str, List[int]],
    tolerance: int,
) -> np.ndarray:
    """Boolean hit mask over score-ordered predictions.

    Semantics match the reference greedy matcher (ref: util/score.py:45-95):
    walking predictions best-first, each claims the nearest not-yet-claimed GT
    frame of its video when within ±tolerance. Distance ties resolve to the
    earliest-listed GT frame (np.argmin returns the first minimum, as the
    reference's strict-improvement scan does), and duplicate GT frame values
    within a video are claimable only once (the reference keys its claimed set
    by frame value).
    """
    # Per-video GT frame arrays, first-occurrence order, value-deduped.
    gt = {v: np.fromiter(dict.fromkeys(f), dtype=np.int64) for v, f in truth.items()}
    free = {v: np.ones(a.size, dtype=bool) for v, a in gt.items()}

    hit = np.zeros(len(pred), dtype=bool)
    prev_score = np.inf
    for i, (video, frame, score) in enumerate(pred):
        assert score <= prev_score, "predictions must be score-sorted"
        prev_score = score
        frames = gt.get(video)
        if frames is None:
            continue
        mask = free[video]
        dist = np.where(mask, np.abs(frames - frame), np.iinfo(np.int64).max)
        j = int(np.argmin(dist)) if frames.size else 0
        if frames.size and dist[j] <= tolerance:
            mask[j] = False
            hit[i] = True
    return hit


def compute_average_precision(
    pred: Sequence[Tuple[str, int, float]],
    truth: Dict[str, List[int]],
    tolerance: int = 0,
) -> float:
    """Greedy AP: interpolated precision integrated over TOTAL GT bins
    (ref: util/score.py:45-95)."""
    total = sum(len(x) for x in truth.values())
    if total == 0:
        return 0.0
    hit = _greedy_match(pred, truth, tolerance)
    if not hit.any():
        return 0.0
    # Precision at each hit, by global rank; then right-to-left running max.
    pc = np.cumsum(hit)[hit] / (np.flatnonzero(hit) + 1)
    interp = np.maximum.accumulate(pc[::-1])
    return float(interp.sum() / total)


def plot_pr_curves(
    truth_by_label: Dict,
    pred: List[dict],
    tolerance: int,
    out_path: str,
) -> None:
    """Optional per-class precision-recall plot (ref: util/score.py:147-157).

    Requires matplotlib; silently skips when unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:
        return
    fig, ax = plt.subplots()
    for label in sorted(truth_by_label):
        flat = get_predictions(pred, label=label)
        total = sum(len(v) for v in truth_by_label[label].values())
        if not total or not flat:
            continue
        hits = np.cumsum(_greedy_match(flat, truth_by_label[label], tolerance))
        ranks = np.arange(1, hits.size + 1)
        ax.plot(hits / total, hits / ranks, label=label)
    ax.set_xlabel("recall")
    ax.set_ylabel("precision")
    ax.set_title(f"PR @ tolerance {tolerance}")
    ax.legend(fontsize=6)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def compute_maps(
    truth: List[dict],
    pred: List[dict],
    tolerances: Sequence[int] = (1, 2, 4),
    printed: bool = False,
    labels_root: Optional[str] = None,
    plot_pr: Optional[str] = None,
) -> Tuple[List[float], List[int]]:
    """Per-tolerance mAP over classes (ref: util/score.py:98-161).

    plot_pr: when set, writes PR-curve PNGs ``<plot_pr>_tol{t}.png``."""
    assert {v["video"] for v in truth} == {v["video"] for v in pred}, (
        "Video set mismatch!"
    )
    truth_by_label = parse_ground_truth(truth, labels_root)

    rows = []
    maps = []
    class_aps_per_tol = []
    for tol in tolerances:
        class_aps = []
        for label in sorted(truth_by_label.keys()):
            ap = compute_average_precision(
                get_predictions(pred, label=label), truth_by_label[label], tol
            )
            class_aps.append((label, ap))
        maps.append(float(np.mean([a for _, a in class_aps])))
        class_aps_per_tol.append(class_aps)
        if plot_pr:
            plot_pr_curves(truth_by_label, pred, tol, f"{plot_pr}_tol{tol}.png")

    if printed:
        names = sorted(truth_by_label.keys()) + ["mAP"]
        print(_format_table(names, class_aps_per_tol, maps, tolerances))
        print("Avg mAP (across tolerances): {:0.2f}".format(np.mean(maps) * 100))
    return maps, list(tolerances)


def _format_table(names, class_aps_per_tol, maps, tolerances) -> str:
    header = ["AP @ tol"] + [str(t) for t in tolerances]
    lines = ["\t".join(header)]
    for i, name in enumerate(names):
        vals = []
        for j, _ in enumerate(tolerances):
            if name == "mAP":
                vals.append(maps[j] * 100)
            else:
                vals.append(class_aps_per_tol[j][i][1] * 100)
        lines.append("\t".join([name] + [f"{v:0.2f}" for v in vals]))
    return "\n".join(lines)
