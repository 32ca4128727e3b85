"""The port's copies of the SoccerNet scorers (metrics/soccernet.py) and of
the joint two-dataset sampler (data/loader.py:JointSampler) against their
originals in the JAX package, on the same random generators and on fuzzed
inputs. Every comparison is exact: the copies must compute the same
numbers, not close ones."""

import json
import os
import random

import numpy as np
import pytest
from PIL import Image

import tdeed_tpu.data.clips as jclips
import tdeed_tpu.data.frames as jframes
import tdeed_tpu.data.loader as jloader
import tdeed_tpu.metrics.soccernet as jsn
import tdeed_tpu_torch.data.clips as pclips
import tdeed_tpu_torch.data.frames as pframes
import tdeed_tpu_torch.data.loader as ploader
import tdeed_tpu_torch.metrics.soccernet as psn
from tests.fixtures import make_finediving_fixture

CLASSES = {f"class{i}": i for i in range(1, 5)}


def _assert_same(got, want, path="result"):
    """Equal nested dicts/lists of floats and arrays, exactly."""
    assert type(got) is type(want) or np.isscalar(got), (path, type(got), type(want))
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_same(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple, np.ndarray)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)
    else:
        assert got == want, (path, got, want)


def test_constants_match():
    for name in ("VECTOR_MINUTES", "SNB_EVENTS", "SN_EVENTS", "SNB_GAMES"):
        assert getattr(psn, name) == getattr(jsn, name), name
    np.testing.assert_array_equal(psn.THRESHOLDS, jsn.THRESHOLDS)
    for metric in ("tight", "loose", "at1", "at3"):
        np.testing.assert_array_equal(psn.deltas_for(metric), jsn.deltas_for(metric))


def _annotations(rng, n, labels, halves=(1, 2), gametime_only=0.2, unshown=0.2,
                 max_ms=7_200_000):
    anns = []
    for _ in range(n):
        ms = int(rng.integers(0, max_ms))
        ann = {"gameTime": f"{int(rng.choice(halves))} - {ms // 60000:02d}:{ms // 1000 % 60:02d}",
               "label": str(rng.choice(labels))}
        if rng.random() > gametime_only:
            ann["position"] = str(ms)
        if rng.random() < unshown:
            ann["visibility"] = "not shown"
        anns.append(ann)
    return anns


def _predictions(rng, n, labels, halves=(1, 2)):
    return [{"label": str(rng.choice(labels)), "position": int(rng.integers(0, 7_200_000)),
             "half": int(rng.choice(halves)), "confidence": float(rng.random())}
            for _ in range(n)]


@pytest.mark.parametrize("seed,framerate", [(0, 2), (1, 25 / 12), (2, 1.0)])
def test_rasterizers_match(seed, framerate):
    """label2vector (positions and gameTime-only events, 'not shown',
    labels outside the dictionary), predictions2vector and closest_map."""
    rng = np.random.default_rng(seed)
    labels = list(jsn.SN_EVENTS) + ["Not an event"]
    anns = _annotations(rng, 60, labels)
    preds = _predictions(rng, 80, labels)
    for half in (1, 2):
        want = jsn.label2vector(anns, 17, jsn.SN_EVENTS, framerate, half)
        np.testing.assert_array_equal(
            psn.label2vector(anns, 17, jsn.SN_EVENTS, framerate, half), want)
        np.testing.assert_array_equal(psn.closest_map(want), jsn.closest_map(want))
        np.testing.assert_array_equal(
            psn.predictions2vector(preds, 17, jsn.SN_EVENTS, framerate, half),
            jsn.predictions2vector(preds, 17, jsn.SN_EVENTS, framerate, half))


@pytest.mark.parametrize("metric,seed", [("tight", 3), ("loose", 4), ("at1", 5)])
def test_average_map_matches_on_fuzzed_vectors(metric, seed):
    """Sparse ground truth (visible and unshown) and scored detections,
    some near a ground truth and some not, over a few game halves."""
    rng = np.random.default_rng(seed)
    n, c, framerate = 3000, 5, 2
    targets, detections = [], []
    for _ in range(3):
        t = np.zeros((n, c))
        idx = rng.choice(n, 40, replace=False)
        t[idx, rng.integers(0, c, 40)] = rng.choice([1.0, -1.0], 40, p=[0.8, 0.2])
        d = np.full((n, c), -1.0)
        near = np.clip(idx + rng.integers(-6, 7, 40), 0, n - 1)
        d[near, rng.integers(0, c, 40)] = rng.random(40)
        d[rng.choice(n, 60, replace=False), rng.integers(0, c, 60)] = rng.random(60)
        targets.append(t)
        detections.append(d)
    kw = dict(framerate=framerate, deltas=jsn.deltas_for(metric))
    _assert_same(psn.average_map(targets, detections, **kw),
                 jsn.average_map(targets, detections, **kw))


def _write_tree(root, game, name, payload):
    os.makedirs(os.path.join(root, game), exist_ok=True)
    with open(os.path.join(root, game, name), "w") as fp:
        json.dump(payload, fp)


def test_file_scorers_match(tmp_path):
    """evaluate_snb over the challenge's hard-coded test games and
    evaluate_sn_official over two SoccerNet games, on written label and
    results_spotting.json trees."""
    rng = np.random.default_rng(6)
    labels_root, preds_root = str(tmp_path / "labels"), str(tmp_path / "preds")
    for game in jsn.SNB_GAMES["test"]:
        _write_tree(labels_root, game, "Labels-ball.json",
                    {"annotations": _annotations(rng, 30, list(jsn.SNB_EVENTS), halves=(1,))})
        _write_tree(preds_root, game, "results_spotting.json",
                    {"predictions": _predictions(rng, 50, list(jsn.SNB_EVENTS), halves=(1,))})
    _assert_same(psn.evaluate_snb(labels_root, preds_root, "test"),
                 jsn.evaluate_snb(labels_root, preds_root, "test"))

    sn_labels, sn_preds = str(tmp_path / "sn_labels"), str(tmp_path / "sn_preds")
    for game in ("cup/2020/m1", "cup/2021/m2"):
        _write_tree(sn_labels, game, "Labels-v2.json",
                    {"annotations": _annotations(rng, 40, list(jsn.SN_EVENTS))})
        _write_tree(sn_preds, game, "results_spotting.json",
                    {"predictions": _predictions(rng, 60, list(jsn.SN_EVENTS))})
    _assert_same(psn.evaluate_sn_official(sn_labels, sn_preds, "test"),
                 jsn.evaluate_sn_official(sn_labels, sn_preds, "test"))


def test_val_map_sn_matches(tmp_path):
    """SoccerNet's val mAP through each package's sliding-window inference,
    with one deterministic predict function of the frames' pixels."""
    rng = np.random.default_rng(7)
    frame_dir, data_root = tmp_path / "frames", tmp_path / "data"
    labels_root = str(tmp_path / "labels")
    os.makedirs(data_root / "soccernet")
    (data_root / "soccernet" / "class.txt").write_text("Goal\nFoul\nCorner\n")
    metas = []
    for half in (1, 2):
        video = f"league/2020/g1/{half}"
        os.makedirs(frame_dir / video)
        for i in range(0, 840, 12):  # the strided frames the windows read
            Image.fromarray(rng.integers(0, 256, (8, 8, 3), np.uint8)).save(
                frame_dir / video / f"frame{i}.jpg")
        metas.append({"video": video, "num_frames": 720})
    (data_root / "soccernet" / "val.json").write_text(json.dumps(metas))
    _write_tree(labels_root, "league/2020/g1", "Labels-v2.json", {"annotations": _annotations(
        rng, 12, ["Goal", "Foul", "Corner"], gametime_only=0, max_ms=28_000)})

    class Cfg:
        frame_dir = str(tmp_path / "frames")
        clip_len = 10

    def predict_fn(frames, hflip=False):
        m = frames.astype(np.float32).mean(axis=(2, 3, 4)) / 255.0  # (B, T)
        scores = np.stack([(m * (k + 3)) % 1.0 + 0.01 for k in range(4)], axis=-1)
        return scores / scores.sum(-1, keepdims=True)

    want = jsn.val_map_sn(predict_fn, Cfg, str(data_root), labels_root)
    got = psn.val_map_sn(predict_fn, Cfg, str(data_root), labels_root)
    assert got == want and 0.0 < want <= 1.0


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    return make_finediving_fixture(str(tmp_path_factory.mktemp("joint")),
                                   num_videos=2, num_frames=24, size=16)


def _joint(side, fx, mixup):
    clips, frames, loader = side
    samplers = []
    for split in ("train", "val"):
        plan = clips.plan_clips(
            "finediving", os.path.join(fx["data_root"], "finediving", f"{split}.json"),
            fx["frame_dir"], CLASSES, 8, 1, 0.9, 2)
        samplers.append(loader.ClipSampler(plan, 8, 1, 2, mixup,
                                           decoder=frames.get_decoder("pil")))
    return loader.JointSampler(*samplers)


@pytest.mark.parametrize("mixup", [True, False])
def test_joint_sampler_matches(fx, mixup):
    """The same stream of tagged samples from the same random.Random, and
    the same epochs through BatchLoader (the dataset ids collated)."""
    want_s = _joint((jclips, jframes, jloader), fx, mixup)
    got_s = _joint((pclips, pframes, ploader), fx, mixup)
    assert (got_s.s1.dataset_tag, got_s.s2.dataset_tag) == (1, 2)
    r1, r2 = random.Random(11), random.Random(11)
    tags = set()
    for _ in range(12):
        want, got = want_s.sample(r1), got_s.sample(r2)
        _assert_same(got, want)
        tags.add(int(got["dataset"]))
    assert tags == {1, 2}
    epochs = [list(loader.BatchLoader(s, 3, 12, num_workers=2, seed=4).epoch(1))
              for loader, s in ((jloader, want_s), (ploader, got_s))]
    assert len(epochs[0]) == len(epochs[1]) == 4
    for want, got in zip(*epochs):
        _assert_same(got, want)
